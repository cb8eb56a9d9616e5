#!/usr/bin/env python3
"""Variants of the f32 K12's tensor-core GEMM
(tip_tpu_torch/csrc/train_mma.cuh) built side by side and timed as K12 on
one GPU (the bf16 variants' products are csrc/bf16_gemm.cuh's).

    python3 scripts/torch_k12_variants.py

Each variant is a text patch of train_mma.cuh: how the operands are split
into TF32 parts, the order of the three products, the warp layout of a
block, the pipeline depth, the blocks an SM. Every variant is built with
nvcc into its own library under build/tip_tpu_torch/k12_variants/, its
namespaces renamed so that the libraries share no symbol, and loaded in
place of the port's encoder_train library. K12 then runs at the training
shape (B 256, T 40, the full-width model's layer 0 with chip_smoke.py's
ff1 shift, p 0.1) in each variant, in two passes: its error against
encoder_layer_bwd_plain (relative to each output's largest entry), its
device time (chip_smoke.graph_ms) and K11's (the forward K12 recomputes)
on the variant's GEMM. Prints a line per variant and pass, then one JSON object.
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

OUT = K.BUILD_DIR / "k12_variants"
SPLIT = '''  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));'''
RNA_HI = '''  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));'''
RNA_LO = '''  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));'''
PRODUCTS = '''#pragma unroll
      for (int nt = 0; nt < W::NT; ++nt) {
        mma(acc[mt][nt], al, bh[nt]);
        mma(acc[mt][nt], ah, bl[nt]);
        mma(acc[mt][nt], ah, bh[nt]);
      }'''
INTERLEAVED = '''#pragma unroll
      for (int nt = 0; nt < W::NT; ++nt) mma(acc[mt][nt], al, bh[nt]);
#pragma unroll
      for (int nt = 0; nt < W::NT; ++nt) mma(acc[mt][nt], ah, bl[nt]);
#pragma unroll
      for (int nt = 0; nt < W::NT; ++nt) mma(acc[mt][nt], ah, bh[nt]);'''
WIDE = "using WideTile = Tile<128, 2, 4>;     // N > 256"
NARROW = "using NarrowTile = Tile<64, 4, 2>;    // N <= 256"
# name: [(text of train_mma.cuh, its replacement), ...]
VARIANTS = {
    "base": [],
    "split_rna_both": [(SPLIT, RNA_HI + "\n" + RNA_LO)],
    "split_rna_hi": [(SPLIT, RNA_HI + "\n  lo = __float_as_uint(x - "
                      "__uint_as_float(hi));")],
    "interleaved": [(PRODUCTS, INTERLEAVED)],
    "narrow_as_wide": [(NARROW, "using NarrowTile = Tile<128, 2, 4>;")],
    "stages_2": [("kStages = 3;", "kStages = 2;")],
    "one_block_an_sm": [("__launch_bounds__(L::THREADS, 2)",
                         "__launch_bounds__(L::THREADS, 1)")],
    "wide_2x2_warps": [(WIDE, "using WideTile = Tile<128, 2, 2>;")],
    "wide_4x2_warps": [(WIDE, "using WideTile = Tile<128, 4, 2>;")],
    "narrow_2x2_warps": [(NARROW, "using NarrowTile = Tile<64, 2, 2>;")],
    "narrow_2x1_warps": [(NARROW, "using NarrowTile = Tile<64, 2, 1>;")],
}


def start_build(i, name):
    """Write the variant's sources and start its nvcc."""
    d = OUT / f"v{i}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in sorted(K.CSRC.iterdir()):
        if f.suffix not in (".cu", ".cuh"):
            continue
        text = f.read_text()
        if f.name == "train_mma.cuh":
            for old, new in VARIANTS[name]:
                if old not in text:
                    raise RuntimeError(f"{name}: the patch does not apply")
                text = text.replace(old, new)
        for ns in ("tf3", "tg", "bg"):
            text = text.replace(f"namespace {ns} {{", f"namespace {ns}_v{i} {{")
            text = text.replace(f"{ns}::", f"{ns}_v{i}::")
        (d / f.name).write_text(text)
    so = d / "encoder_train.so"
    cmd = [K._nvcc(), *K.NVCC_FLAGS, "-o", str(so), str(d / "encoder_train.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT), so


def load(so, sig):
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in sig.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        print("torch_k12_variants: no CUDA device", file=sys.stderr)
        return 1
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import encoder_train as ET
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_info(), flush=True)
    builds = {name: start_build(i, name) for i, name in enumerate(VARIANTS)}
    libs = {}
    for name, (proc, so) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log.decode(errors='replace')}")
            return 1
        libs[name] = load(so, ET._SIG)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    model = M.TIPModel(M.ModelConfig(), device=dev,
                       generator=torch.Generator().manual_seed(0))
    ws = [w.detach().contiguous() for w in ET.pack_layer_weights(
        dict(model.named_parameters()), "layers.0.")]
    ws[5] = (ws[5] + cs.K12_FF1_SHIFT).contiguous()
    ws = tuple(ws)
    x = torch.randn(256, 40, 256, generator=gen, device=dev)
    dy = torch.randn(256, 40, 256, generator=gen, device=dev)
    seed, nh, p = -123457, 16, 0.1
    ref = ET.encoder_layer_bwd_plain(x, ws, seed, dy, nh, p, True, 8)
    res = {}
    for rep in range(2):
        for name, lib in libs.items():
            K._libs["encoder_train"] = lib
            # a variant's tiles set its reductions' splits, so its scratch
            ET._part_floats.clear()

            def k12():
                return ET.encoder_layer_bwd(x, ws, seed, dy, nh, p, True, 8,
                                            impl="kernel")
            dx, dws = k12()
            err = max([cs.rel_err(dx, ref[0])]
                      + [cs.rel_err(a, b) for a, b in zip(dws, ref[1])])
            ms = cs.graph_ms(k12, per_graph=5, replays=10)
            fwd = cs.graph_ms(lambda: ET.encoder_layer_fwd(
                x, ws, seed, nh, p, True, 8, impl="kernel"), per_graph=5,
                replays=10)
            r = res.setdefault(name, dict(err=err, k12_ms=[],
                                          forward_ms=[]))
            r["k12_ms"].append(ms)
            r["forward_ms"].append(fwd)
            print(f"pass {rep} {name}: K12 {ms:.4f} ms, K11 "
                  f"{fwd:.4f} ms, error {err:.3g}", flush=True)
    print(json.dumps({"k12_variants": res, "card": cs.card_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
