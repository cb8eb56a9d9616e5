#!/usr/bin/env python3
"""How many clusters of the RNN walk an H100 runs at once, and what a
launch of one cluster more costs.

    python3 scripts/torch_rnn_clusters.py

Builds a small library beside the kernels (build/tip_tpu_torch/) that
asks cudaOccupancyMaxActiveClusters for rnn_cluster.cuh's walks (the bf16
tc_walk_kernel at tiles of 8-32 rows and the f32 walk_kernel at 16 rows),
each with the shared memory its plan gives a block. Then times, as
chip_smoke.py does (chip_smoke.graph_ms), K1 at T 40, H 512:
  - bf16 at B 240 and 256 by ops/fused_rnn.py's plan (15 clusters) and
    by plans of 16 clusters of 15 and 16 rows (what the f32 plan's rule,
    RNN_FULL_CLUSTERS, would give);
  - f32 at B 240 (15 clusters of 16 rows) and 256 (16 clusters), its plan.
Prints the card's name and power limit, then JSON lines (the clusters,
then the clusters and the times). Exits non-zero without CUDA.
"""

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

SOURCE = r'''
#include "rnn_cluster.cuh"

template <class F>
static int max_clusters(F kernel, long long smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       rnnc::kMaxSmem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16 * rnnc::kCluster);
  cfg.blockDim = dim3(rnnc::kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = rnnc::kCluster;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// the bf16 forward walk at 64 columns a block, nb 8-row sides
extern "C" int tc_max_clusters(int nb, long long smem) {
  using rnnc::tc_walk_kernel;
  switch (nb) {
    case 1: return max_clusters(tc_walk_kernel<4, 1, false, false, true>, smem);
    case 2: return max_clusters(tc_walk_kernel<4, 2, false, false, true>, smem);
    case 3: return max_clusters(tc_walk_kernel<4, 3, false, false, true>, smem);
    default: return max_clusters(tc_walk_kernel<4, 4, false, false, true>, smem);
  }
}

// the f32 forward walk at 16 rows, 64 columns a block
extern "C" int f32_max_clusters(long long smem) {
  return max_clusters(rnnc::walk_kernel<16, 2, false, true>, smem);
}
'''


def build(K):
    """The query library, built from SOURCE beside the kernels."""
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = K.BUILD_DIR / "rnn_clusters_query.cu"
    out = K.BUILD_DIR / "rnn_clusters_query.so"
    src.write_text(SOURCE)
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-I", str(K.CSRC), "-o",
                    str(out), str(src)], check=True)
    so = ctypes.CDLL(str(out))
    so.tc_max_clusters.argtypes = [ctypes.c_int, ctypes.c_longlong]
    so.f32_max_clusters.argtypes = [ctypes.c_longlong]
    return so


def main():
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import fused_rnn as FR
    dev = torch.device("cuda")
    card = CS.card_info()
    print(card, flush=True)
    K.build_all(["fused_rnn"])
    query = build(K)
    torch.zeros(1, device=dev)
    result = {"card": card,
              "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    result["max_clusters_bf16"] = {
        f"tile{bt}": query.tc_max_clusters(FR.tc_rows(bt) // 8,
                                           FR.tc_smem_bytes(64, bt, False))
        for bt in (5, 8, 16, 18, 32)}
    result["max_clusters_f32"] = {
        "tile16": query.f32_max_clusters(FR.fused_rnn_plan(256, 512)
                                         .smem_bytes)}
    print(json.dumps(result), flush=True)

    so = K.lib("fused_rnn", FR._SIG)
    gen = torch.Generator(device=dev).manual_seed(11)
    T, H = 40, 512
    w = (torch.rand(H, H, generator=gen, device=dev) * 2 - 1) / math.sqrt(H)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        wd = w.to(dtype)
        for B in (240, 256):
            xin = (torch.randn(B, T, H, generator=gen, device=dev)
                   * 0.5).to(dtype)
            out = torch.empty_like(xin)
            plan = FR.fused_rnn_plan(B, H, xin.element_size())
            plans = {"plan": (plan.batch_tile, plan.clusters)}
            if dtype == torch.bfloat16:
                bt16 = -(-B // FR.RNN_FULL_CLUSTERS)
                plans["16_clusters"] = (bt16, -(-B // bt16))

            def launch(bt, clusters, xin=xin, out=out, wd=wd, B=B):
                stream = K.stream_of(xin.device)   # a graph's own
                if xin.dtype == torch.bfloat16:
                    err = so.fused_rnn_bf16_launch(
                        xin.data_ptr(), wd.data_ptr(), out.data_ptr(), B, T,
                        H, 8, 64, bt, clusters,
                        FR.tc_smem_bytes(64, bt, False), None, stream)
                else:
                    err = so.fused_rnn_launch(
                        xin.data_ptr(), wd.data_ptr(), out.data_ptr(), B, T,
                        H, 8, 64, bt, clusters,
                        FR.fused_rnn_plan(B, H).smem_bytes, stream)
                K.check(err, "fused_rnn")
            ref = FR.fused_rnn(xin, wd, impl="kernel")
            for name, (bt, clusters) in plans.items():
                launch(bt, clusters)
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name}: another tile changed "
                                         f"the outputs")
                times[f"{str(dtype).split('.')[1]}_B{B}_{name}"] = dict(
                    batch_tile=bt, clusters=clusters,
                    ms=CS.graph_ms(lambda bt=bt, c=clusters: launch(bt, c)))
    result["k1_ms"] = times
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
