#!/usr/bin/env python3
"""Variants of K9 (tip_tpu_torch/csrc/fused_recompute_batch.cu) built side
by side and timed on one GPU.

    python3 scripts/torch_k9_variants.py [variant ...]   # default: all

Each variant is a text patch of the kernel's sources
(fused_recompute_batch.cu, the phases it shares with K8 in
pool_phases.cuh, train_mma.cuh): the encoder's pass length, the
products' tiles, the pipeline depth and slice depth of train_mma.cuh's
tile routine, the f32 sums of each 8-deep step; two diagnostics time the
pipelined products' staging alone and their mma alone (their outputs are
wrong and not checked). Every variant is
built with nvcc into its own library under build/tip_tpu_torch/k9_variants/
(its namespaces renamed so that the libraries share no symbol) and loaded in
place of the port's fused_recompute_batch library. K9 then runs at the pool
path's shape (the full-width model, T 40, every window full) at B 64 and
256 in both packings, in two passes: its error against
fused_recompute_batch_plain, its device time (chip_smoke.graph_ms) and, at
B 64, its time by phase (the per-phase clock). Prints a line per variant,
packing, B and pass, then one JSON object.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tip_tpu_torch.ops import _kernels as K  # noqa: E402

OUT = K.BUILD_DIR / "k9_variants"
K9 = "fused_recompute_batch.cu"
POOL = "pool_phases.cuh"
MMA = "train_mma.cuh"
# name: [(file, text, its replacement), ...]
VARIANTS = {
    "base": [],
    "passes_of_1280_rows": [(K9, "kChunkRows = 2560;", "kChunkRows = 1280;")],
    "narrow_64_rows": [(POOL, "using NarrowTile = tf3::Tile<64, 1, 8, 80>;",
                        "using NarrowTile = tf3::Tile<64, 2, 4, 64>;")],
    "stages_4": [(MMA, "kStages = 3;", "kStages = 4;")],
    "slices_64_deep": [(MMA, "BM = 128, BK = 32,", "BM = 128, BK = 64,")],
    "no_f32_step_sums": [(POOL, "tf3::mma_tile<false, false, L, true>",
                           "tf3::mma_tile<false, false, L, false>"),
                          (POOL, "tf3::mma_slice<false, false, L, true>",
                           "tf3::mma_slice<false, false, L, false>")],
    # diagnostics, their outputs wrong: the pipelined products' staging
    # without their mma, and their mma on whatever shared memory holds
    "staging_only": [(MMA, "    mma_slice<TA, TB, L, kPromote, kBf16>(",
                      "    if (false) mma_slice<TA, TB, L, kPromote, kBf16>("),
                     (POOL, "    bf16_slice<L>(As, reinterpret_cast",
                      "    if (false) bf16_slice<L>(As, reinterpret_cast")],
    "mma_only": [(MMA, "      load_stage<TA, TB, L, kShiftA>(sm + s",
                  "      if (false) load_stage<TA, TB, L, kShiftA>(sm + s"),
                 (MMA, "      load_stage<TA, TB, L, kShiftA>(st, st",
                  "      if (false) load_stage<TA, TB, L, kShiftA>(st, st"),
                 (POOL, "      load_bf16_stage<L>(\n          sm + s",
                  "      if (false) load_bf16_stage<L>(\n          sm + s"),
                 (POOL, "      load_bf16_stage<L>(st,",
                  "      if (false) load_bf16_stage<L>(st,")],
}
DIAGNOSTIC = ("staging_only", "mma_only")


def start_build(i, name):
    """Write the variant's sources and start its nvcc."""
    d = OUT / f"v{i}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in sorted(K.CSRC.iterdir()):
        if f.suffix not in (".cu", ".cuh"):
            continue
        text = f.read_text()
        for fname, old, new in VARIANTS[name]:
            if f.name == fname:
                if old not in text:
                    raise RuntimeError(f"{name}: the patch does not apply")
                text = text.replace(old, new)
        for ns in ("tf3", "tg"):
            text = text.replace(f"namespace {ns} {{",
                                f"namespace {ns}_v{i} {{")
            text = text.replace(f"{ns}::", f"{ns}_v{i}::")
        (d / f.name).write_text(text)
    so = d / "fused_recompute_batch.so"
    cmd = [K._nvcc(), *K.NVCC_FLAGS, "-o", str(so), str(d / K9)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), so


def main():
    if not torch.cuda.is_available():
        print("torch_k9_variants: no CUDA device", file=sys.stderr)
        return 1
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import fused_forward as FF
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_info(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    builds = {name: start_build(i, name) for i, name in enumerate(VARIANTS)
              if name in names}
    libs = {}
    for name, (proc, so) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log.decode(errors='replace')}")
            return 1
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in FF._SIG_BATCH.items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    model = M.TIPModel(M.ModelConfig(forward_impl="fused"), device=dev,
                       generator=torch.Generator().manual_seed(0))
    cfg, T = model.cfg, 40
    inputs = {}
    for B in (64, 256):
        x = torch.randn(B, T, cfg.input_dim, generator=gen, device=dev)
        x[:, ::3, 100] = float("nan")
        inputs[B] = (x, [T - 1] * B,
                     torch.full((B,), T - 1, dtype=torch.int32, device=dev))
    res = {}
    for rep in range(2):
        for name, lib in libs.items():
            K._libs["fused_recompute_batch"] = lib
            for dt in (torch.float32, torch.bfloat16):
                ws = model.packed_weights(dt)
                dn = str(dt).split(".")[1]
                for B, (x, ks, k_dev) in inputs.items():
                    y = FF._launch_batch(ws, x, k_dev, cfg)
                    err = None if name in DIAGNOSTIC else cs.max_err(
                        y, FF._recompute_batch_rows(ws, x, k_dev, cfg))
                    ms = cs.graph_ms(lambda: FF._launch_batch(ws, x, k_dev,
                                                              cfg),
                                     per_graph=5, replays=10)
                    r = res.setdefault(f"{name}/{dn}/B{B}",
                                       dict(err=err, ms=[]))
                    r["ms"].append(ms)
                    if B == 64 and rep == 0:
                        r["phases_ms"] = FF.recompute_batch_phases(
                            ws, x, ks, cfg)[1]
                    print(f"pass {rep} {name} {dn} B {B}: {ms:.4f} ms, error "
                          f"{err}", flush=True)
    print(json.dumps({"k9_variants": res, "card": cs.card_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
