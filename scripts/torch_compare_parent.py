#!/usr/bin/env python3
"""The single-stream whole-model kernels K4/K5 and K7 of this checkout
beside those of commit ed6c80d (their versions before their redesign), and
the kernels that share device code with them (K8, K9, K1, K10) bit for bit,
on one GPU in one process.

    git archive ed6c80d tip_tpu_torch | tar -x -C output/parent
    python3 scripts/torch_compare_parent.py output/parent

The other checkout's `csrc/` sources are built with nvcc into
`<parent>/build/` and called through their own C entry points: K4's and
K7's as ed6c80d declares them (without the per-phase clock's arguments;
K7's scratch query by SM count), K8's, K9's, K1's and K10's as this
checkout's wrappers call them. ctypes does not check a call's arguments, so
the script first reads those declarations in the other checkout's sources
and refuses any checkout whose entry points differ from these. Then:

  - K8, K9, K1 and K10: the outputs of both builds on chip_smoke.py's
    inputs must be equal bit for bit (K8: y and the updated rings; K9: 12
    cases; K1 at B 1, 3, 8, 17, 64, 256; K10 at (256, 40, 512): dx, dW);
  - K4 and K5 at (40, 221), row 39, both packings, and K7 (replay and
    carry, both packings, slot 7 of full 40-slot rings): device ms of each
    build, CUDA graphs as chip_smoke.py times them, in turns (other, this,
    this, other), and the largest difference of the outputs.

Prints one JSON line with the card's name and power limit. Exits non-zero
without CUDA, or when an output that must be bit-equal differs.
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

PARENT = "ed6c80d"
PARENT_KERNELS = ("fused_forward", "fused_cached", "fused_cached_batch",
                  "fused_recompute_batch", "fused_rnn", "fused_rnn_bwd")
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIG = {
    "fused_forward_launch": [_P, _P, _I, _I] + [_I] * 10 + [_P, _P, _P],
    "fused_cached_launch": [_P, _P] + [_I] * 14 + [_P] * 6 + [_I, _P, _P],
    "fused_cached_scratch_floats": [_I] * 6}

# ed6c80d's declarations of the entry points PARENT_SIG calls, spaces
# squeezed; the others must equal this checkout's
PARENT_DECL = {
    "fused_forward_launch":
        "const void* x, const void* const* weights, int n_w, int is_bf16, "
        "int T, int Din, int d, int heads, int ff, int layers, int H, int S, "
        "int zero0, int k_last, void* scratch, void* out, void* stream",
    "fused_cached_launch":
        "const void* tok, const void* const* weights, int n_w, int is_bf16, "
        "int W, int Din, int d, int heads, int ff, int layers, int H, int S, "
        "int zero0, int slot, int commit, int rnn_carry, void* k, void* v, "
        "void* enc, void* h, void* valid, void* scratch, int scratch_floats, "
        "void* y, void* stream",
    "fused_cached_scratch_floats": "int sms, int W, int d, int ff, int H, "
                                   "int S"}
SAME_ENTRY_POINTS = {
    "fused_cached_batch": ("fused_cached_batch_launch",
                           "fused_cached_batch_scratch_floats"),
    "fused_recompute_batch": ("fused_recompute_batch_launch",
                              "fused_recompute_batch_scratch_floats"),
    "fused_rnn": ("fused_rnn_launch",),
    "fused_rnn_bwd": ("fused_rnn_bwd_launch",)}


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
    wrong += [fn for fns in SAME_ENTRY_POINTS.values() for fn in fns
              if decl(parent, fn) is None
              or decl(parent, fn) != decl(ROOT, fn)]
    if wrong:
        raise SystemExit(f"{parent}: entry points {wrong} are not declared "
                         f"as in {PARENT}; this script compares only with "
                         "that commit's kernels")


def this_signatures():
    """This checkout's wrappers' ctypes signatures, by source."""
    from tip_tpu_torch.ops import fused_forward as FF
    from tip_tpu_torch.ops import fused_rnn as FR
    from tip_tpu_torch.runtime import streaming_cache as SC
    return {"fused_cached_batch": SC._SIG_BATCH,
            "fused_recompute_batch": FF._SIG_BATCH,
            "fused_rnn": FR._SIG, "fused_rnn_bwd": FR._SIG_BWD}


# the shared headers' named namespaces, renamed in the other build: the
# same template kernels in both libraries would otherwise share their
# symbols (a launch attribute set on one kernel, the other one launched)
RENAMED = ("-Drnnc=rnnc_other", "-Dtf3=tf3_other", "-Dtg=tg_other",
           "-Dhm=hm_other", "-Dtipq=tipq_other")


def build_parent(parent: Path):
    """nvcc every compared source of the other checkout, in parallel."""
    from tip_tpu_torch.ops import _kernels as K
    out = parent / "build"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in PARENT_KERNELS:
        src = parent / "tip_tpu_torch" / "csrc" / f"{name}.cu"
        cmd = [K._nvcc(), *K.NVCC_FLAGS, *RENAMED, "-o",
               str(out / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the other {name}.cu:\n"
                               + log.decode(errors="replace"))
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    sigs = dict(PARENT_SIG)
    for sig in this_signatures().values():
        sigs.update(sig)
    for so in libs.values():
        for fn, argtypes in sigs.items():
            if hasattr(so, fn):
                getattr(so, fn).argtypes = argtypes
                getattr(so, fn).restype = ctypes.c_int
    return libs


class Swapped:
    """This checkout's wrapper of `name` calling the other build's library
    inside the block (the entry points are declared alike)."""

    def __init__(self, libs, name):
        from tip_tpu_torch.ops import _kernels as K
        self.K, self.name, self.other = K, name, libs[name]

    def __enter__(self):
        self.mine = self.K.lib(self.name, this_signatures()[self.name])
        self.K._libs[self.name] = self.other

    def __exit__(self, *exc):
        self.K._libs[self.name] = self.mine


def both(libs, name, fn):
    """fn() with the other build's library, then with this one's."""
    with Swapped(libs, name):
        o = fn()
    return o, fn()


def equal(a, b):
    if isinstance(a, (tuple, list)):
        return all(equal(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def k9_bits(libs, model, dev):
    """Both K9 builds on chip_smoke.py's K9 inputs: {case: equal}."""
    from tip_tpu_torch.ops import fused_forward as FF
    gen = torch.Generator(device=dev).manual_seed(1)
    small = CS.small_model(dev)
    cases = [("full", model, 40, 1, None), ("full", model, 40, 5, None),
             ("full", model, 40, CS.POOL_CAPACITY, None),
             ("small", small, 12, 6, None),
             ("timed", model, 40, CS.POOL_CAPACITY, 39),
             ("timed", model, 40, 256, 39)]
    out = {}
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
            o, m = both(libs, "fused_recompute_batch",
                        lambda: FF._launch_batch(ws, x, k_dev, cfg))
            out[f"{tag}_B{B}_{str(dt).split('.')[1]}"] = equal(o, m)
    return out


def full_rings(SC, cfg, B, gen, dev):
    """A pool's rings of random rows, every slot valid but one a stream."""
    c = SC.cache_init(cfg, 40, device=dev, batch=B)
    for n in ("k", "v", "enc", "h"):
        getattr(c, n).copy_(torch.randn(getattr(c, n).shape, generator=gen,
                                        device=dev))
    c.valid.fill_(True)
    c.valid[torch.arange(B, device=dev), torch.arange(B, device=dev) % 40] = \
        False
    return c


def k8_bits(libs, model, dev):
    """Both K8 builds at B 64 and 256, both packings and RNN variants, slot
    7, a stream in three not committed: y and every ring equal."""
    from tip_tpu_torch.runtime import streaming_cache as SC
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for B in (CS.POOL_CAPACITY, 256):
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            cfg = dataclasses.replace(model.cfg, compute_dtype=name)
            ws = model.packed_weights(dt)
            x = torch.randn(B, cfg.input_dim, generator=gen, device=dev)
            commit = torch.arange(B, device=dev) % 3 != 1
            for rnn_carry in (False, True):
                c = full_rings(SC, cfg, B, gen, dev)

                def run():
                    cc = c.clone()
                    _, y = SC.fused_cached_batch(ws, cc, x, 7, commit, cfg,
                                                 rnn_carry=rnn_carry,
                                                 impl="fused")
                    return [y] + [getattr(cc, n) for n in
                                  ("k", "v", "enc", "h", "valid")]
                o, m = both(libs, "fused_cached_batch", run)
                var = "carry" if rnn_carry else "replay"
                out[f"{var}_{name}_B{B}"] = equal(o, m)
    return out


def k1_bits(libs, dev):
    from tip_tpu_torch.ops import fused_rnn as FR
    gen = torch.Generator(device=dev).manual_seed(4)
    w = torch.randn(512, 512, generator=gen, device=dev) / 512 ** 0.5
    out = {}
    for B in CS.RNN_CHECKED_B:
        xin = torch.randn(B, 40, 512, generator=gen, device=dev)
        o, m = both(libs, "fused_rnn",
                    lambda: FR.fused_rnn(xin, w, impl="kernel"))
        out[f"B{B}"] = equal(o, m)
    return out


def k10_bits(libs, dev):
    from tip_tpu_torch.ops import fused_rnn as FR
    gen = torch.Generator(device=dev).manual_seed(4)
    B, T, H = 256, 40, 512
    hs = torch.tanh(torch.randn(B, T, H, generator=gen, device=dev))
    w = torch.randn(H, H, generator=gen, device=dev) / H ** 0.5
    g = torch.randn(B, T, H, generator=gen, device=dev)
    o, m = both(libs, "fused_rnn_bwd",
                lambda: FR.fused_rnn_bwd(hs, w, g, impl="kernel"))
    return {f"B{B}_T{T}_H{H}": equal(o, m)}


def other_k4(so, ws, x, k_last, cfg):
    """The other checkout's K4 (k_last >= 0) or K5 (-1) through its own
    entry point."""
    from tip_tpu_torch.ops import fused_forward as FF
    T = x.shape[0]
    d, ff, H = cfg.tf_in_dim, cfg.tf_hid_size, cfg.rnn_hid_size
    out = torch.empty((cfg.size_s,) if k_last >= 0 else (T, cfg.size_s),
                      dtype=torch.float32, device=x.device)
    scratch = torch.empty(T * (6 * d + ff + 2 * H), dtype=torch.float32,
                          device=x.device)
    ptrs = (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws])
    err = so.fused_forward_launch(
        x.data_ptr(), ptrs, len(ws), int(ws[0].dtype == torch.bfloat16), T,
        cfg.input_dim, d, cfg.n_heads, ff, cfg.tf_layers, H, cfg.size_s,
        FF._imu_dim(cfg) + 108, k_last, scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the other fused_forward: error {err}")
    return out


def other_k7(so, ws, cache, x, slot, commit, cfg, rnn_carry):
    """The other checkout's K7 through its own entry point."""
    from tip_tpu_torch.ops import fused_forward as FF
    W = cache.enc.shape[0]
    d, ff, H = cfg.tf_in_dim, cfg.tf_hid_size, cfg.rnn_hid_size
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n = so.fused_cached_scratch_floats(sms, W, d, ff, H, cfg.size_s)
    y = torch.empty(cfg.size_s, dtype=torch.float32, device=x.device)
    scratch = torch.empty(n, dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws])
    err = so.fused_cached_launch(
        x.data_ptr(), ptrs, len(ws), int(ws[0].dtype == torch.bfloat16), W,
        cfg.input_dim, d, cfg.n_heads, ff, cfg.tf_layers, H, cfg.size_s,
        FF._imu_dim(cfg) + 108, slot, int(commit), int(rnn_carry),
        cache.k.data_ptr(), cache.v.data_ptr(), cache.enc.data_ptr(),
        cache.h.data_ptr(), cache.valid.data_ptr(), scratch.data_ptr(), n,
        y.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the other fused_cached: error {err}")
    return y


def in_turns(other, mine):
    """Device ms of both, timed other, this, this, other (chip_smoke.py's
    graphs: 20 calls a graph, 50 replays)."""
    o1, m1, m2, o2 = (CS.graph_ms(f) for f in (other, mine, mine, other))
    return dict(other_ms=[o1, o2], this_ms=[m1, m2])


def k4_times(libs, model, dev):
    from tip_tpu_torch.ops import fused_forward as FF
    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = model.cfg
    x = torch.randn(40, cfg.input_dim, generator=gen, device=dev)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        ws = model.packed_weights(dt)
        for kname, k in (("K4", 39), ("K5", -1)):
            def mine():
                if k < 0:
                    return FF.fused_forward(ws, x, cfg, impl="fused")
                return FF.fused_forward_last(ws, x, k, cfg, impl="fused")

            def other():
                return other_k4(libs["fused_forward"], ws, x, k, cfg)
            t = in_turns(other, mine)
            t["max_abs_diff"] = CS.max_err(other(), mine())
            out[f"{kname}_{str(dt).split('.')[1]}"] = t
    return out


def k7_times(libs, model, dev):
    from tip_tpu_torch.runtime import streaming_cache as SC
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        cfg = dataclasses.replace(model.cfg, compute_dtype=name)
        ws = model.packed_weights(dt)
        for rnn_carry in (False, True):
            cache = SC.cache_init(cfg, 40, device=dev)
            for step in range(47):
                x = torch.randn(cfg.input_dim, generator=gen, device=dev)
                SC.fused_cached_step_slot(ws, cache, x, step % 40, True, cfg,
                                          rnn_carry=rnn_carry, impl="fused")
            co, cm = cache.clone(), cache.clone()
            y_o = other_k7(libs["fused_cached"], ws, cache.clone(), x, 7, True,
                           cfg, rnn_carry)
            _, y_m = SC.fused_cached_step_slot(ws, cache.clone(), x, 7, True,
                                               cfg, rnn_carry=rnn_carry,
                                               impl="fused")
            t = in_turns(
                lambda: other_k7(libs["fused_cached"], ws, co, x, 7, True,
                                 cfg, rnn_carry),
                lambda: SC.fused_cached_step_slot(ws, cm, x, 7, True, cfg,
                                                  rnn_carry=rnn_carry,
                                                  impl="fused"))
            t["max_abs_diff"] = CS.max_err(y_o, y_m)
            out[f"{'carry' if rnn_carry else 'replay'}_{name}"] = t
    return out


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
    bits = {"k9": k9_bits(libs, model, dev), "k8": k8_bits(libs, model, dev),
            "k1": k1_bits(libs, dev), "k10": k10_bits(libs, dev)}
    result = {"card": card, "parent": PARENT, "bit_equal": bits,
              "k4_k5": k4_times(libs, model, dev),
              "k7": k7_times(libs, model, dev)}
    print(json.dumps(result), flush=True)
    return 0 if all(v for b in bits.values() for v in b.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
