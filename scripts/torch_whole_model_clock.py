#!/usr/bin/env python3
"""The single-stream whole-model kernels K4/K5 (csrc/fused_forward.cu) and
K7 (csrc/fused_cached.cu) by phase, on one GPU.

    python3 scripts/torch_whole_model_clock.py [--probe]

At chip_smoke.py's shapes and seeds (the full-width model of seed 0; K4 at
a (40, 221) window, row 39; K7 at slot 7 of full 40-slot rings):

  - each kernel's per-phase clock (``fused_forward.forward_phases``,
    ``streaming_cache.cached_step_phases``), the median of 7 clocked calls
    by kind of phase: K4 and K5 in both packings, K7 replay and carry in
    both;
  - device ms a call (20 calls in a CUDA graph replayed 50 times, as
    chip_smoke.py's ``graph_ms``) and eager ms (CUDA events around one
    call, median of 200);
  - host us of one wrapper call: ``time.perf_counter`` around the call,
    nothing synchronised, median of 400 after 50.

``--probe`` also builds a small CUDA source of its own into build/ and
reports whether a cooperative launch takes a cluster dimension
(``cudaLaunchKernelEx`` with both attributes, the clusters' blocks then
passing ``grid.sync()`` and a distributed-shared-memory write), the most
co-resident clusters of 8, and the device us of one ``grid.sync()`` over
one block an SM, with and without 40 KB of L2-resident activations staged
into shared memory by every block before it.

Prints one JSON line with the card's name and power limit. Exits non-zero
without CUDA.
"""

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

CLOCKED = 7
W = 40
SLOT = 7

PROBE_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(256) probe(int* out) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cl = cg::this_cluster();
  __shared__ int v;
  if (threadIdx.x == 0) v = 0;
  cl.sync();
  if (threadIdx.x == 0) atomicAdd(cl.map_shared_rank(&v, 0), 1);
  cl.sync();
  grid.sync();
  if (threadIdx.x == 0 && cl.block_rank() == 0) atomicAdd(out, v);
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) out[1] = out[0];
}

// n grid barriers; with floats > 0 every block first reads `floats` values
// of buf (L2-resident) into shared memory and sums a few
__global__ void __launch_bounds__(256) syncs(const float* buf, int floats,
                                             int n, float* out) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    if (floats > 0) {
      const float4* src = reinterpret_cast<const float4*>(buf) +
                          (i & 1) * (floats / 4);
      float4* dst = reinterpret_cast<float4*>(sm);
      for (int e = threadIdx.x; e < floats / 4; e += blockDim.x)
        dst[e] = __ldcg(src + e);
      __syncthreads();
      acc += sm[(threadIdx.x * 37 + i) % floats];
    }
    grid.sync();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

extern "C" int probe_launch(int clusters, int* out, int* max_clusters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * 8);
  cfg.blockDim = dim3(256);
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 8;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t e = cudaOccupancyMaxActiveClusters(max_clusters, probe, &cfg);
  if (e != cudaSuccess) return 1000 + static_cast<int>(e);
  if (clusters > *max_clusters) return -1;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, probe, out);
  if (e != cudaSuccess) return 2000 + static_cast<int>(e);
  return static_cast<int>(cudaDeviceSynchronize());
}

extern "C" int syncs_launch(int grid, const float* buf, int floats, int n,
                            float* out, void* stream) {
  const size_t smem = floats > 0 ? floats * sizeof(float) : 16;
  cudaFuncSetAttribute(syncs, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  void* args[] = {&buf, &floats, &n, &out};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(syncs), dim3(grid), dim3(256), args, smem,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
"""


def median_split(fn):
    """Per-kind medians over CLOCKED clocked calls of fn -> (split, n)."""
    fn()
    runs = [fn() for _ in range(CLOCKED)]
    keys = runs[0][1].keys()
    split = {k: statistics.median(r[1][k] for r in runs) for k in keys}
    return split, runs[0][2]


def host_us(fn, n=400, warmup=50):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
        if len(ts) % 50 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e6


def forward_rows(model, dev):
    from tip_tpu_torch.ops import fused_forward as FF
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(40, cfg.input_dim, generator=gen, device=dev)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        ws = model.packed_weights(dt)
        name = str(dt).split(".")[1]
        for kname, k in (("K4", 39), ("K5", None)):
            split, n = median_split(
                lambda: FF.forward_phases(ws, x, k, cfg))
            if k is None:
                call = lambda: FF.fused_forward(ws, x, cfg, impl="fused")
            else:
                call = lambda: FF.fused_forward_last(ws, x, k, cfg,
                                                     impl="fused")
            out[f"{kname}_{name}"] = dict(
                phases=n, clock_ms=split, ms=CS.graph_ms(call),
                call_ms=CS.time_ms(call), host_us=host_us(call))
    return out


def cached_rows(model, dev):
    import dataclasses
    from tip_tpu_torch.runtime import streaming_cache as SC
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        cfg = dataclasses.replace(model.cfg, compute_dtype=name)
        ws = model.packed_weights(dt)
        for carry in (False, True):
            cache = SC.cache_init(cfg, W, device=dev)
            for step in range(W + 7):
                x = torch.randn(cfg.input_dim, generator=gen, device=dev)
                SC.fused_cached_step_slot(ws, cache, x, step % W, True, cfg,
                                          rnn_carry=carry, impl="fused")
            split, n = median_split(
                lambda: SC.cached_step_phases(ws, cache, x, SLOT, True, cfg,
                                              rnn_carry=carry))
            call = lambda: SC.fused_cached_step_slot(
                ws, cache, x, SLOT, True, cfg, rnn_carry=carry, impl="fused")
            key = f"{'carry' if carry else 'replay'}_{name}"
            out[key] = dict(phases=n, clock_ms=split, ms=CS.graph_ms(call),
                            call_ms=CS.time_ms(call), host_us=host_us(call))
    return out


def probe(dev):
    from tip_tpu_torch.ops import _kernels as K
    src = K.BUILD_DIR / "whole_model_probe.cu"
    so_path = K.BUILD_DIR / "whole_model_probe.so"
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE_SRC)
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-o", str(so_path), str(src)],
                   check=True, timeout=600)
    so = ctypes.CDLL(str(so_path))
    so.probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int)]
    so.syncs_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p]
    res = {}
    out = torch.zeros(2, dtype=torch.int32, device=dev)
    most = ctypes.c_int(0)
    err = so.probe_launch(16, out.data_ptr(), ctypes.byref(most))
    torch.cuda.synchronize()
    res["coop_cluster_launch_rc"] = err
    res["max_clusters_of_8"] = most.value
    res["coop_cluster_blocks_counted"] = out.tolist()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    buf = torch.randn(2 * 10240, device=dev)
    acc = torch.zeros(sms, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for floats in (0, 10240):
        times = []
        for n in (1000, 2000):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            so.syncs_launch(sms, buf.data_ptr(), floats, 10, acc.data_ptr(),
                            stream)
            s.record()
            rc = so.syncs_launch(sms, buf.data_ptr(), floats, n,
                                 acc.data_ptr(), stream)
            e.record()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"syncs_launch: CUDA error {rc}")
            times.append(s.elapsed_time(e))
        # the difference of two counts: launch cost cancels
        res[f"us_per_sync_staging_{floats * 4 // 1024}KB"] = \
            (times[1] - times[0]) / 1000 * 1e3
    return res


def main():
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    dev = torch.device("cuda")
    card = CS.card_info()
    print(card, flush=True)
    K.build_all(["fused_forward", "fused_cached"])
    model = M.TIPModel(M.ModelConfig(forward_impl="fused"), device=dev,
                       generator=torch.Generator().manual_seed(0))
    result = {"card": card, "forward": forward_rows(model, dev),
              "cached": cached_rows(model, dev)}
    if "--probe" in sys.argv[1:]:
        result["probe"] = probe(dev)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
