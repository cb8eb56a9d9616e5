#!/usr/bin/env python3
"""The pool kernels K8 and K9 and the RNN backward K10 of this checkout
beside those of commit 5bc1d35 (their versions before K8 and K10 were
redesigned), on one GPU in one process.

    git archive 5bc1d35 tip_tpu_torch | tar -x -C output/parent
    python3 scripts/torch_compare_parent.py output/parent

The other checkout's `csrc/` sources are built with nvcc into
`<parent>/build/` and called through their own C entry points: K8's and
K10's as 5bc1d35 declares them (without K8's clock arguments, and with
K10's scratch query), K9's as this checkout's wrapper calls it. ctypes does
not check a call's arguments, so the script first reads those declarations
in the other checkout's sources and refuses any checkout whose entry points
differ from these. Then:

  - K9: the outputs of both builds on chip_smoke.py's K9 inputs (B 1, 5,
    64 at full width, B 6 at the small width, both packings; B 64 and 256
    with full windows) must be equal bit for bit;
  - K8 (both RNN variants, both packings, B 64 and 256, a slot of full
    rings) and K10 (256, 40, 512): device ms of each build, CUDA graphs as
    chip_smoke.py times them, in turns (other, this, this, other), and the
    largest difference of the outputs.

Prints one JSON line with the card's name and power limit. Exits non-zero
without CUDA, or when K9's outputs differ.
"""

import ctypes
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

PARENT_KERNELS = ("fused_recompute_batch", "fused_cached_batch",
                  "fused_rnn_bwd")
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIG = {
    "fused_cached_batch_launch": [_P, _P] + [_I] * 14 + [_P] * 7
    + [ctypes.c_longlong, _P, _P],
    "fused_cached_batch_scratch_floats": [_I] * 6,
    "fused_rnn_bwd_scratch": [_I, _I, _I, ctypes.POINTER(ctypes.c_longlong)],
    "fused_rnn_bwd_launch": [_P] * 6 + [_I] * 3 + [_P]}


# 5bc1d35's declarations of the entry points PARENT_SIG calls, spaces
# squeezed; K9's must equal this checkout's
PARENT_DECL = {
    "fused_cached_batch_launch":
        "const void* tok, const void* const* weights, int n_w, int is_bf16, "
        "int B, int W, int Din, int d, int heads, int ff, int layers, int H, "
        "int S, int zero0, int slot, int rnn_carry, const void* commit, "
        "void* k, void* v, void* enc, void* h, void* valid, void* scratch, "
        "long long scratch_floats, void* y, void* stream",
    "fused_cached_batch_scratch_floats":
        "int B, int W, int d, int ff, int H, int rnn_carry",
    "fused_rnn_bwd_scratch": "int B, int T, int H, long long* floats",
    "fused_rnn_bwd_launch":
        "const void* hs, const void* w_hh, const void* g, void* dx, "
        "void* dw, void* scratch, int B, int T, int H, void* stream"}
K9_ENTRY_POINTS = ("fused_recompute_batch_scratch_floats",
                   "fused_recompute_batch_launch")


def declaration(src: Path, fn: str):
    """The parameter list of `extern "C" int fn(...)` in src, spaces
    squeezed, or None."""
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src.read_text())
    return None if m is None else " ".join(m.group(1).split())


def check_abi(parent: Path):
    """Raise unless the other checkout declares the entry points this
    script calls as it calls them."""
    def decl(root, fn):
        src = re.sub(r"_(launch|scratch\w*)$", "", fn)
        return declaration(root / "tip_tpu_torch" / "csrc" / f"{src}.cu", fn)
    wrong = [fn for fn, want in PARENT_DECL.items()
             if decl(parent, fn) != want]
    wrong += [fn for fn in K9_ENTRY_POINTS
              if decl(parent, fn) is None
              or decl(parent, fn) != decl(ROOT, fn)]
    if wrong:
        raise SystemExit(f"{parent}: entry points {wrong} are not declared "
                         "as in 5bc1d35; this script compares only with "
                         "that commit's K8, K9 and K10")


def build_parent(parent: Path):
    """nvcc every compared source of the other checkout, in parallel."""
    from tip_tpu_torch.ops import _kernels as K
    out = parent / "build"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in PARENT_KERNELS:
        src = parent / "tip_tpu_torch" / "csrc" / f"{name}.cu"
        cmd = [K._nvcc(), *K.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the other {name}.cu:\n"
                               + log.decode(errors="replace"))
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    for name, so in libs.items():
        for fn, argtypes in PARENT_SIG.items():
            if hasattr(so, fn):
                getattr(so, fn).argtypes = argtypes
                getattr(so, fn).restype = ctypes.c_int
    return libs


def k9_bits(libs, model, dev):
    """Both K9 builds on chip_smoke.py's K9 inputs: {case: equal}."""
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import fused_forward as FF
    mine = K.lib("fused_recompute_batch", FF._SIG_BATCH)
    other = libs["fused_recompute_batch"]
    for fn, argtypes in FF._SIG_BATCH.items():
        getattr(other, fn).argtypes = argtypes
        getattr(other, fn).restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(1)
    small = CS.small_model(dev)
    cases = [("full", model, 40, 1, None), ("full", model, 40, 5, None),
             ("full", model, 40, CS.POOL_CAPACITY, None),
             ("small", small, 12, 6, None),
             ("timed", model, 40, CS.POOL_CAPACITY, 39),
             ("timed", model, 40, 256, 39)]
    equal = {}
    for tag, mdl, T, B, k_full in cases:
        cfg = mdl.cfg
        for dt in (torch.float32, torch.bfloat16):
            ws = mdl.packed_weights(dt)
            x = torch.randn(B, T, cfg.input_dim, generator=gen, device=dev)
            if k_full is None:
                x[:, ::3, 100] = float("nan")
                x[:, :, 90 + 108:90 + 111] = 5.0
                ks = [(0, 3, 17, T - 1)[b % 4] % T for b in range(B)]
            else:
                ks = [k_full] * B
            k_dev = torch.tensor(ks, dtype=torch.int32, device=dev)
            outs = []
            for so in (other, mine):
                K._libs["fused_recompute_batch"] = so
                outs.append(FF._launch_batch(ws, x, k_dev, cfg))
            K._libs["fused_recompute_batch"] = mine
            equal[f"{tag}_B{B}_{str(dt).split('.')[1]}"] = bool(
                torch.equal(outs[0], outs[1]))
    return equal


def other_k8(so, ws, cache, x, slot, commit, cfg, rnn_carry):
    """The other checkout's K8 through its own entry point."""
    from tip_tpu_torch.ops import fused_forward as FF
    B, W = cache.enc.shape[:2]
    d, ff, H = cfg.tf_in_dim, cfg.tf_hid_size, cfg.rnn_hid_size
    n = so.fused_cached_batch_scratch_floats(B, W, d, ff, H, int(rnn_carry))
    y = torch.empty((B, cfg.size_s), dtype=torch.float32, device=x.device)
    scratch = torch.empty(n, dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws])
    err = so.fused_cached_batch_launch(
        x.data_ptr(), ptrs, len(ws), int(ws[0].dtype == torch.bfloat16), B,
        W, cfg.input_dim, d, cfg.n_heads, ff, cfg.tf_layers, H, cfg.size_s,
        FF._imu_dim(cfg) + 108, slot, int(rnn_carry), commit.data_ptr(),
        cache.k.data_ptr(), cache.v.data_ptr(), cache.enc.data_ptr(),
        cache.h.data_ptr(), cache.valid.data_ptr(), scratch.data_ptr(), n,
        y.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the other fused_cached_batch: error {err}")
    return y


def other_k10(so, hs, w, g):
    B, T, H = hs.shape
    n = ctypes.c_longlong()
    so.fused_rnn_bwd_scratch(B, T, H, ctypes.byref(n))
    scratch = torch.empty(n.value, dtype=torch.float32, device=hs.device)
    dx = torch.empty_like(hs)
    dw = torch.empty((H, H), dtype=torch.float32, device=hs.device)
    err = so.fused_rnn_bwd_launch(hs.data_ptr(), w.data_ptr(), g.data_ptr(),
                                  dx.data_ptr(), dw.data_ptr(),
                                  scratch.data_ptr(), B, T, H,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the other fused_rnn_bwd: error {err}")
    return dx, dw


def in_turns(other, mine):
    """Device ms of both, timed other, this, this, other."""
    g = dict(per_graph=5, replays=10)
    o1, m1, m2, o2 = (CS.graph_ms(f, **g) for f in (other, mine, mine,
                                                     other))
    return dict(other_ms=[o1, o2], this_ms=[m1, m2])


def k8_times(libs, model, dev):
    from tip_tpu_torch.runtime import streaming_cache as SC
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for B in (CS.POOL_CAPACITY, 256):
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            cfg = dataclasses.replace(model.cfg, compute_dtype=name)
            ws = model.packed_weights(dt)
            x = torch.randn(B, cfg.input_dim, generator=gen, device=dev)
            commit = torch.ones(B, dtype=torch.bool, device=dev)
            for rnn_carry in (False, True):
                c = SC.cache_init(cfg, 40, device=dev, batch=B)
                for n in ("k", "v", "enc", "h"):
                    getattr(c, n).copy_(torch.randn(
                        getattr(c, n).shape, generator=gen, device=dev))
                c.valid.fill_(True)
                co, cm = c.clone(), c.clone()
                y_o = other_k8(libs["fused_cached_batch"], ws, c.clone(), x, 7,
                               commit, cfg, rnn_carry)
                _, y_m = SC.fused_cached_batch(ws, c.clone(), x, 7, commit,
                                               cfg, rnn_carry=rnn_carry,
                                               impl="fused")
                var = "carry" if rnn_carry else "replay"
                t = in_turns(
                    lambda: other_k8(libs["fused_cached_batch"], ws, co, x, 7,
                                     commit, cfg, rnn_carry),
                    lambda: SC.fused_cached_batch(ws, cm, x, 7, commit, cfg,
                                                  rnn_carry=rnn_carry,
                                                  impl="fused"))
                t["max_abs_diff"] = CS.max_err(y_o, y_m)
                out[f"{var}_{name}_B{B}"] = t
    return out


def k10_times(libs, dev):
    from tip_tpu_torch.ops import fused_rnn as FR
    gen = torch.Generator(device=dev).manual_seed(4)
    B, T, H = 256, 40, 512
    hs = torch.tanh(torch.randn(B, T, H, generator=gen, device=dev))
    w = torch.randn(H, H, generator=gen, device=dev) / H ** 0.5
    g = torch.randn(B, T, H, generator=gen, device=dev)
    so = libs["fused_rnn_bwd"]
    o = other_k10(so, hs, w, g)
    m = FR.fused_rnn_bwd(hs, w, g, impl="kernel")
    t = in_turns(lambda: other_k10(so, hs, w, g),
                 lambda: FR.fused_rnn_bwd(hs, w, g, impl="kernel"))
    t["max_rel_diff"] = max(CS.rel_err(a, b) for a, b in zip(m, o))
    return {f"B{B}_T{T}_H{H}": t}


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    dev = torch.device("cuda")
    card = CS.card_info()
    print(card, flush=True)
    parent = Path(sys.argv[1]).resolve()
    check_abi(parent)
    K.build_all()
    libs = build_parent(parent)
    model = M.TIPModel(M.ModelConfig(forward_impl="fused"), device=dev,
                       generator=torch.Generator().manual_seed(0))
    bits = k9_bits(libs, model, dev)
    result = {"card": card, "k9_bit_equal": bits,
              "k8": k8_times(libs, model, dev), "k10": k10_times(libs, dev)}
    print(json.dumps(result), flush=True)
    return 0 if all(bits.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
