#!/usr/bin/env python3
"""The bf16 RNN head (K1 bf16, K10 bf16) and the per-frame tail kernels K2
(decode_fused), K3 (tail_fused) and K6 (fk_bullet_fused) of this checkout
beside those of another commit (as a rule the parent), and every other
kernel (K1, K4/K5, K7-K12 f32, K11 bf16, K12 bf16) bit for bit, on one GPU
in one process.

    git archive <commit> tip_tpu_torch | tar -x -C output/parent
    python3 scripts/torch_compare_parent.py output/parent [--bits_only]

The argument is a checkout of the other commit's tip_tpu_torch/. Every
csrc/*.cu of that checkout is built with nvcc into `<checkout>/build/`. Its
K2, K3 and K6, its K1 and K10 (f32 and bf16) and its K11 and K12 (f32 and
bf16) run through its own wrappers (its ops/fused_tail.py,
ops/kinematics.py, ops/fused_rnn.py and ops/encoder_train.py, loaded
beside this checkout's) and its own C entry points; the other kernels run
through this checkout's wrappers calling the other build's library. ctypes
does not check a call's arguments, so the script first reads the other
checkout's declarations and refuses it unless its K2, K3 and K6 entry
points are declared as its own wrappers' ctypes tables (their _SIG) call
them, its RNN and encoder entry points with as many parameters as its own
wrappers pass, and every other entry point it declares with the parameter
types this checkout declares it with (names aside; entry points that only
this checkout has are not called on the other build). Then:

  - K1 bf16 and K10 bf16 at B 1, 64 and 256 (T 40, H 512, chip_smoke.py's
    inputs: K10's hidden states from the plain forward): device ms
    (chip_smoke.graph_ms) and eager ms (chip_smoke.time_ms) of each build
    in turns (other, this, this, other), and the share of entries of h
    (K1) and of dx and dW (K10) off the other build's;
  - K1, K4/K5, K7, K8, K9, K10, K11 and K12: the outputs of both builds on
    chip_smoke.py's inputs must be equal bit for bit (K1 at B 1, 3, 8, 17,
    64, 256 and K10 at (256, 40, 512), f32; K4 and K5 at (40, 221) in both
    packings; K7 replay and carry in both packings, y and the rings; K8 at
    B 64 and 256; K9 12 cases; K11 and K12 in f32 at (256, 40, 256) p 0.1
    and a small case, and in bf16 at B 1, 64 and 256, T 40, the full-width
    model's layer 0 with chip_smoke.py's ff1 shift, p 0);
  - K1 and K10 (f32; each build through its own wrapper), K4 (row 39) and
    K5 in both packings, K7 (replay and carry, both packings, an
    uncommitted step at slot 7 of full rings), K8 (B 64, likewise) and K9
    (B 64, every window full, both packings) at those shapes: device ms
    (chip_smoke.graph_ms) of each build in turns (other, this, this,
    other), "turns" in the JSON line, with this build's best over the
    other's;
  - unless --bits_only, K2, K3 and K6 at B 1 and 64: device ms
    (chip_smoke.graph_ms), eager
    ms (chip_smoke.time_ms) and the host us of one call without a sync
    (chip_smoke.host_us) of each build's wrapper and kernel, in turns
    (other, this, this, other), and the largest difference of the outputs;
  - paths A, B and E of chip_smoke.py, the runner with the other build's
    K2 and K3 and with this one's, in turns: device ms and kernels a frame
    (torch.profiler over 50 steady frames, chip_smoke.profile_frames) and
    the two kernels' share.

Both builds are made here, from the same nvcc flags, with the shared
headers' namespaces renamed to names of one length (the other's
``renamed("other")``, this checkout's ``renamed("local")`` into
build/tip_tpu_torch/compare_local/), so that neither side runs code built
otherwise than the other's. Renaming only the other build moved some
kernels' times by a few per cent when a checkout of this tree was the
other (on an H100 80GB HBM3: K9 bf16 at B 64 +2.6%, K4/K5 f32 +1.3%, K9
f32 -1.3%), and renaming both alike did not remove it (K9 bf16 +2.5%, K10
f32 +3.0%, K9 f32 -1.4%, this build going second). So every run takes
both orders: first the other build goes first (its libraries load first,
each of its kernels launches first, turns run other, this, this, other),
then the script runs itself again in a child process with --this_first
on the same libraries (this build first); the last JSON line pairs each
timed case's this_vs_other of the two orders with their geometric mean,
in which a bias that follows the order cancels. K2, K3, K6 and the paths
(without --bits_only) run the other build first in both.

Prints a JSON line of each order's results, then the pairs, each with the
card's name and power limit. Exits non-zero without CUDA, and 2 when an
output that must be bit-equal differs in either order.
"""

import ctypes
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

TAIL_SOURCES = ("fused_tail", "fused_fk")
# sources whose every entry point must be declared as in this checkout
SAME_SOURCES = ("fused_forward", "fused_cached", "fused_cached_batch",
                "fused_recompute_batch")
# the RNN head: every entry point through the other checkout's own wrapper
# (ops/fused_rnn.py), f32 and bf16
RNN_SOURCES = ("fused_rnn", "fused_rnn_bwd")
# encoder_train: every entry point through the other checkout's own
# wrapper (ops/encoder_train.py), f32 and bf16
ENCODER = "encoder_train"


def declarations(src: Path):
    """{name: parameter list, spaces squeezed} of the extern "C" functions
    of src."""
    text = src.read_text()
    return {m.group(1): " ".join(m.group(2).split()) for m in re.finditer(
        r'extern "C" \w+ (\w+)\(([^)]*)\)', text)}


# a C parameter's type -> its ctypes type (every pointer is c_void_p)
CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float,
         "long long": ctypes.c_longlong}


def ctypes_of(decl: str):
    """The ctypes types of a C parameter list (as ``declarations`` gives
    it), or None where a type is not one of CTYPE's or a pointer."""
    out = []
    for param in decl.split(","):
        typ = param.strip().rsplit(" ", 1)[0].replace("const ", "")
        if "*" in param:
            out.append(ctypes.c_void_p)
        elif typ in CTYPE:
            out.append(CTYPE[typ])
        else:
            return None
    return out


def param_types(decl: str):
    """The parameter types of a C parameter list, names dropped."""
    return [p.strip().rsplit(" ", 1)[0].replace(" *", "*")
            for p in decl.split(",")]


def check_abi(parent: Path, other_sigs):
    """Raise unless the other checkout declares the entry points this
    script calls as it calls them: K2's, K3's and K6's as its own wrappers'
    ctypes tables (other_sigs, by source) say; the RNN head's and the
    encoder layer's with as many parameters as its own wrappers' tables;
    every other entry point it declares with this checkout's parameter
    types."""
    def decl(root, src):
        return declarations(root / "tip_tpu_torch" / "csrc" / f"{src}.cu")
    wrong = [fn for src in TAIL_SOURCES
             for fn, argtypes in other_sigs[src].items()
             if ctypes_of(decl(parent, src).get(fn, "?")) != list(argtypes)]
    for src in RNN_SOURCES + (ENCODER,):
        other = decl(parent, src)
        wrong += [fn for fn, argtypes in other_sigs[src].items()
                  if len(param_types(other.get(fn, "?"))) != len(argtypes)]
    for src in SAME_SOURCES:
        mine = decl(ROOT, src)
        wrong += [fn for fn, params in decl(parent, src).items()
                  if fn not in mine
                  or param_types(params) != param_types(mine[fn])]
    if wrong:
        raise SystemExit(f"{parent}: {wrong} are not declared as this "
                         f"script calls them (K1/K10, K2, K3, K6 and K11/K12 "
                         f"as the checkout's own _SIG tables, the rest as in "
                         f"this checkout)")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def this_signatures():
    """This checkout's wrappers' ctypes signatures, by source."""
    from tip_tpu_torch.ops import encoder_train as ET
    from tip_tpu_torch.ops import fused_forward as FF
    from tip_tpu_torch.ops import fused_rnn as FR
    from tip_tpu_torch.ops import fused_tail as FT
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import streaming_cache as SC
    return {"fused_tail": FT._SIG, "fused_fk": kin._SIG,
            "fused_forward": FF._SIG, "fused_cached": SC._SIG,
            "fused_cached_batch": SC._SIG_BATCH,
            "fused_recompute_batch": FF._SIG_BATCH,
            "fused_rnn": FR._SIG, "fused_rnn_bwd": FR._SIG_BWD,
            "encoder_train": ET._SIG}


# the shared headers' named namespaces, renamed in both builds: the same
# template kernels in both libraries would otherwise share their symbols (a
# launch attribute set on one kernel, the other one launched)
SHARED_NAMESPACES = ("rnnc", "tf3", "tg", "hm", "tipq", "bg")
COMPARED = TAIL_SOURCES + SAME_SOURCES + RNN_SOURCES + (ENCODER,)


def renamed(suffix: str):
    """nvcc's -D flags that rename the shared namespaces to <ns>_<suffix>
    (the two builds' suffixes have one length)."""
    return tuple(f"-D{ns}={ns}_{suffix}" for ns in SHARED_NAMESPACES)


def start_builds(root: Path, out: Path, suffix: str, reuse: bool = False):
    """Start one nvcc a compared source of the checkout at root, all
    together, into out, the namespaces renamed with suffix (reuse: keep the
    libraries an earlier run of this script left there)."""
    from tip_tpu_torch.ops import _kernels as K
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in COMPARED:
        so = out / f"{name}.so"
        if reuse and so.exists():
            procs[name] = (None, so)
            continue
        src = root / "tip_tpu_torch" / "csrc" / f"{name}.cu"
        cmd = [K._nvcc(), *K.NVCC_FLAGS, *renamed(suffix), "-o", str(so),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), so)
    return procs


def load_libs(procs, sigs, side: str):
    """The libraries of one side (``side`` names it in an error), once
    built, with `sigs` (by source) declared."""
    libs = {}
    for name, (proc, so_path) in procs.items():
        log, _ = proc.communicate() if proc else (b"", None)
        if proc and proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {side} {name}.cu:\n"
                               + log.decode(errors="replace"))
        so = ctypes.CDLL(str(so_path))
        for fn, argtypes in sigs[name].items():
            if not hasattr(so, fn):        # only this checkout has it
                continue
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        libs[name] = so
    return libs


class Swapped:
    """The other build's library of `name` in place of this one's inside
    the block: this checkout's wrappers (or the other checkout's, which
    load it by the same name) then call it."""

    def __init__(self, libs, name):
        from tip_tpu_torch.ops import _kernels as K
        self.K, self.name, self.other = K, name, libs[name]

    def __enter__(self):
        self.mine = self.K.lib(self.name, this_signatures()[self.name])
        self.K._libs[self.name] = self.other

    def __exit__(self, *exc):
        self.K._libs[self.name] = self.mine


# which build goes first: its libraries are loaded first, each of its
# kernels is launched before the other build's, and turns run (first,
# second, second, first). The other build, unless --this_first.
THIS_FIRST = False


def with_lib(libs, name, fn):
    """fn() with the other build's library of `name`."""
    with Swapped(libs, name):
        return fn()


def in_order(other, this):
    """(other(), this()), called in the order THIS_FIRST says."""
    if THIS_FIRST:
        m = this()
        return other(), m
    o = other()
    return o, this()


def four(other, this):
    """Two calls of each side in turns, the side THIS_FIRST names first and
    last: ([other's], [this one's])."""
    if THIS_FIRST:
        m1, o1, o2, m2 = this(), other(), other(), this()
    else:
        o1, m1, m2, o2 = other(), this(), this(), other()
    return [o1, o2], [m1, m2]


def both(libs, name, fn):
    """fn() with the other build's library and with this one's."""
    return in_order(lambda: with_lib(libs, name, fn), fn)


# device ms of each build in turns, by case: filled by the bit checks
TURNS = {}


def turns(libs, lib, case, this, other=None):
    """Device ms (chip_smoke.graph_ms) of other() with the other build's
    library of `lib` and of this() with this build's, in turns (``four``),
    into TURNS[case]. other: the other checkout's own wrapper call where it
    differs from this()."""
    other = other or this
    o, m = four(lambda: with_lib(libs, lib, lambda: CS.graph_ms(other)),
                lambda: CS.graph_ms(this))
    TURNS[case] = {"other_ms": o, "this_ms": m,
                   "this_vs_other": min(m) / min(o)}
    print(f"  turns {case}: {json.dumps(TURNS[case])}", flush=True)


def equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
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
            if tag == "timed" and B == CS.POOL_CAPACITY:
                turns(libs, "fused_recompute_batch",
                      f"K9_B{B}_{str(dt).split('.')[1]}",
                      lambda: FF._launch_batch(ws, x, k_dev, cfg))
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


def rings(cache):
    return [getattr(cache, n) for n in ("k", "v", "enc", "h", "valid")]


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
                    return [y] + rings(cc)
                o, m = both(libs, "fused_cached_batch", run)
                var = "carry" if rnn_carry else "replay"
                out[f"{var}_{name}_B{B}"] = equal(o, m)
                if B == CS.POOL_CAPACITY:
                    idle = torch.zeros_like(commit)
                    turns(libs, "fused_cached_batch", f"K8_{var}_{name}_B{B}",
                          lambda: SC.fused_cached_batch(
                              ws, c, x, 7, idle, cfg, rnn_carry=rnn_carry,
                              impl="fused"))
    return out


def k1_bits(libs, pfr, dev):
    """The f32 K1 at chip_smoke.py's batch sizes, each build through its
    own wrapper (pfr: the other checkout's ops/fused_rnn.py)."""
    from tip_tpu_torch.ops import fused_rnn as FR
    gen = torch.Generator(device=dev).manual_seed(4)
    w = torch.randn(512, 512, generator=gen, device=dev) / 512 ** 0.5
    out = {}
    for B in CS.RNN_CHECKED_B:
        xin = torch.randn(B, 40, 512, generator=gen, device=dev)
        o, m = in_order(lambda: with_lib(libs, "fused_rnn", lambda:
                                         pfr.fused_rnn(xin, w, impl="kernel")),
                        lambda: FR.fused_rnn(xin, w, impl="kernel"))
        out[f"B{B}_float32"] = equal(o, m)
        if B in CS.RNN_TIMED_B:
            turns(libs, "fused_rnn", f"K1_B{B}_float32",
                  lambda: FR.fused_rnn(xin, w, impl="kernel"),
                  lambda: pfr.fused_rnn(xin, w, impl="kernel"))
    return out


def k10_bits(libs, pfr, dev):
    """The f32 K10 at (256, 40, 512), each build through its own
    wrapper."""
    from tip_tpu_torch.ops import fused_rnn as FR
    gen = torch.Generator(device=dev).manual_seed(4)
    B, T, H = 256, 40, 512
    hs = torch.tanh(torch.randn(B, T, H, generator=gen, device=dev))
    w = torch.randn(H, H, generator=gen, device=dev) / H ** 0.5
    g = torch.randn(B, T, H, generator=gen, device=dev)
    o, m = in_order(lambda: with_lib(libs, "fused_rnn_bwd", lambda:
                                     pfr.fused_rnn_bwd(hs, w, g,
                                                       impl="kernel")),
                    lambda: FR.fused_rnn_bwd(hs, w, g, impl="kernel"))
    turns(libs, "fused_rnn_bwd", f"K10_B{B}_float32",
          lambda: FR.fused_rnn_bwd(hs, w, g, impl="kernel"),
          lambda: pfr.fused_rnn_bwd(hs, w, g, impl="kernel"))
    return {f"B{B}_T{T}_H{H}_float32": equal(o, m)}


def rnn_bf16_turns(libs, pfr, dev):
    """K1 bf16 and K10 bf16 of both builds, each through its own wrapper
    (pfr: the other checkout's ops/fused_rnn.py), at B 1, 64 and 256 on
    chip_smoke.py's inputs (W uniform in +-1/sqrt(H), xin and g normal,
    K10's hidden states the plain forward's): device and eager ms in turns
    (other, this, this, other), and the share of this build's output
    entries off the other's."""
    from tip_tpu_torch.ops import fused_rnn as FR
    gen = torch.Generator(device=dev).manual_seed(10)
    bf, H, T = torch.bfloat16, 512, 40
    w = ((torch.rand(H, H, generator=gen, device=dev) * 2 - 1)
         / H ** 0.5).to(bf)
    out = {}
    for B in CS.RNN_TIMED_B:
        xin = (torch.randn(B, T, H, generator=gen, device=dev) * 0.5).to(bf)
        hs = FR.fused_rnn_plain(xin, w)
        g = torch.randn(B, T, H, generator=gen, device=dev).to(bf)
        calls = {
            "K1_bf16": ("fused_rnn",
                        lambda: pfr.fused_rnn(xin, w, impl="kernel"),
                        lambda: FR.fused_rnn(xin, w, impl="kernel")),
            "K10_bf16": ("fused_rnn_bwd",
                         lambda: pfr.fused_rnn_bwd(hs, w, g, impl="kernel"),
                         lambda: FR.fused_rnn_bwd(hs, w, g, impl="kernel"))}
        for name, (lib, other, mine) in calls.items():
            t = {}
            for what, timer in (("ms", CS.graph_ms), ("call_ms", CS.time_ms)):
                t[f"other_{what}"], t[f"this_{what}"] = four(
                    lambda: with_lib(libs, lib, lambda: timer(other)),
                    lambda: timer(mine))
            o, m = in_order(lambda: with_lib(libs, lib, other), mine)
            share = CS.OffShare()
            for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                              for x in (m, o))):
                share.add(a, b)
            t["off_other_share"] = share.share()
            t["this_vs_other"] = min(t["this_ms"]) / min(t["other_ms"])
            out[f"{name}_B{B}"] = t
            print(f"  {name} B {B}: {json.dumps(t)}", flush=True)
    return out


def k4_bits(libs, model, dev):
    """K4 (rows 39 and 17) and K5 at (40, 221), both packings."""
    from tip_tpu_torch.ops import fused_forward as FF
    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = model.cfg
    x = torch.randn(40, cfg.input_dim, generator=gen, device=dev)
    x[::3, 100] = float("nan")
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        ws = model.packed_weights(dt)
        dn = str(dt).split(".")[1]
        for k in (39, 17):
            o, m = both(libs, "fused_forward", lambda: FF.fused_forward_last(
                ws, x, k, cfg, impl="fused"))
            out[f"K4_row{k}_{dn}"] = equal(o, m)
        o, m = both(libs, "fused_forward",
                    lambda: FF.fused_forward(ws, x, cfg, impl="fused"))
        out[f"K5_{dn}"] = equal(o, m)
        turns(libs, "fused_forward", f"K4_row39_{dn}",
              lambda: FF.fused_forward_last(ws, x, 39, cfg, impl="fused"))
        turns(libs, "fused_forward", f"K5_{dn}",
              lambda: FF.fused_forward(ws, x, cfg, impl="fused"))
    return out


def k7_bits(libs, model, dev):
    """K7 replay and carry, both packings, at slot 7 of rings filled by 47
    steps: y and the rings after the step."""
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

            def run():
                c = cache.clone()
                _, y = SC.fused_cached_step_slot(ws, c, x, 7, True, cfg,
                                                 rnn_carry=rnn_carry,
                                                 impl="fused")
                return [y] + rings(c)
            o, m = both(libs, "fused_cached", run)
            var = "carry" if rnn_carry else "replay"
            out[f"{var}_{name}"] = equal(o, m)
            turns(libs, "fused_cached", f"K7_{var}_{name}",
                  lambda: SC.fused_cached_step_slot(
                      ws, cache, x, 7, False, cfg, rnn_carry=rnn_carry,
                      impl="fused"))
    return out


def k11_k12_bits(libs, pet, model, dev):
    """The f32 K11 and K12 at the training path's (256, 40, 256), p 0.1,
    and a small case (two tiles), each build through its own wrapper (pet:
    the other checkout's ops/encoder_train.py)."""
    from tip_tpu_torch.ops import encoder_train as ET
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for tag, mdl, B, T in (("full", model, 256, 40),
                           ("small", CS.small_model(dev), 16, 10)):
        ws = tuple(w.detach().contiguous() for w in ET.pack_layer_weights(
            dict(mdl.named_parameters()), "layers.0."))
        nh, d = mdl.cfg.n_heads, ws[2].shape[0]
        x = torch.randn(B, T, d, generator=gen, device=dev)
        dy = torch.randn(B, T, d, generator=gen, device=dev)
        for k, call in (("K11", lambda et: et.encoder_layer_fwd(
                x, ws, -123457, nh, 0.1, True, 8, impl="kernel")),
                        ("K12", lambda et: et.encoder_layer_bwd(
                            x, ws, -123457, dy, nh, 0.1, True, 8,
                            impl="kernel"))):
            o, m = in_order(lambda: with_lib(libs, ENCODER,
                                             lambda: tensors(call(pet))),
                            lambda: tensors(call(ET)))
            out[f"{k}_{tag}"] = equal(o, m)
    return out


def tensors(out):
    """K11's y, or K12's dx and twelve gradients, as a list."""
    return [out] if torch.is_tensor(out) else [out[0], *out[1]]


def encoder_bf16_bits(libs, pet, model, dev):
    """K11 bf16 and K12 bf16 of both builds, each through its own wrapper
    (pet: the other checkout's ops/encoder_train.py), at B 1, 64 and 256 on
    chip_smoke.py's K12 bf16 inputs: {case: equal}."""
    from tip_tpu_torch.ops import encoder_train as ET
    gen = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    ws = list(ET.pack_layer_weights(
        {k: v.detach().to(bf) for k, v in model.named_parameters()},
        "layers.0.", bf))
    ws[5] = ws[5] + CS.K12_FF1_SHIFT
    ws = tuple(w.contiguous() for w in ws)
    nh, d = model.cfg.n_heads, ws[2].shape[0]
    out = {}
    for B in CS.ENC_BWD_BF16_B:
        x = torch.randn(B, 40, d, generator=gen, device=dev).to(bf)
        dy = torch.randn(B, 40, d, generator=gen, device=dev).to(bf)
        for k, call in (("K11_bf16", lambda et: et.encoder_layer_fwd(
                x, ws, 0, nh, 0.0, False, 8, impl="kernel")),
                        ("K12_bf16", lambda et: et.encoder_layer_bwd(
                            x, ws, 0, dy, nh, 0.0, False, 8,
                            impl="kernel"))):
            o, m = in_order(lambda: with_lib(libs, ENCODER,
                                             lambda: tensors(call(pet))),
                            lambda: tensors(call(ET)))
            out[f"{k}_B{B}"] = equal(o, m)
    return out


def flat(out):
    return CS.flat(out)


def tail_times(libs, pft, pkin, dev):
    """K2, K3, K6 of both builds, each through its own wrapper (the other
    one's with its own skeleton), at B 1 and 64: device and eager ms and
    host us in turns, and the largest output difference."""
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import kinematics as kin
    skel = kin.amass_skeleton(device=dev)
    other_skel = pkin.amass_skeleton(device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    lib_of = {"decode_fused": "fused_tail", "tail_fused": "fused_tail",
              "fk_bullet_fused": "fused_fk"}
    out = {}
    for B in (1, CS.POOL_CAPACITY):
        x = CS.tail_inputs(B, dev, gen, skel)
        other_calls = {
            "decode_fused": lambda: pft.decode_fused(
                x["y_t"], x["filt"], x["coeff"], x["flags"], x["local9"],
                impl="fused"),
            "tail_fused": lambda: pft.tail_fused(
                other_skel, x["s"], x["ct"], x["prev"], impl="fused"),
            "fk_bullet_fused": lambda: pkin.fk_bullet_fused(
                other_skel, x["pose"], impl="kernel")}
        for name, (mine, _, _, _) in CS.tail_calls(x, skel).items():
            lib = lib_of[name]
            this_lib = K.lib(lib, this_signatures()[lib])

            def other(call=other_calls[name], lib=lib, this_lib=this_lib):
                K._libs[lib] = libs[lib]
                try:
                    return call()
                finally:
                    K._libs[lib] = this_lib
            t = {}
            for what, timer in (("ms", CS.graph_ms), ("call_ms", CS.time_ms),
                                ("host_us", CS.host_us)):
                o1, m1, m2, o2 = (timer(f) for f in (other, mine, mine,
                                                     other))
                t[f"other_{what}"], t[f"this_{what}"] = [o1, o2], [m1, m2]
            t["max_abs_diff"] = CS.max_err(flat(other()), flat(mine()))
            out[f"{name}_B{B}"] = t
            print(f"  {name} B {B}: {json.dumps(t)}", flush=True)
    return out


def path_profiles(libs, pft, pkin, dev):
    """Paths A, B and E of chip_smoke.py (the runner over the in-tree
    motion, random weights from seed 0) profiled as chip_smoke.py profiles
    them (50 steady frames), with the other build's K2 and K3 (its
    ops/fused_tail.py in the runner, its library) and with this one's, in
    turns: device ms and kernels a frame, and the two kernels' device ms.
    The other build's runs take the other checkout's skeleton (its K3
    reads tables this one's skeleton no longer carries)."""
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import runner as R
    imu, s_init = CS.load_motion()
    skels = {False: kin.amass_skeleton(device=dev),
             True: pkin.amass_skeleton(device=dev)}
    cfgs = {"A": R.RunnerConfig(model=M.ModelConfig(encoder_impl="plain")),
            "B": R.RunnerConfig(model=M.ModelConfig(forward_impl="fused")),
            "E": R.RunnerConfig(model=M.ModelConfig(
                forward_impl="fused", compute_dtype="bfloat16"),
                serving_mode="kv_cache_rnn_carry")}
    base = M.TIPModel(cfgs["A"].model, device=dev,
                      generator=torch.Generator().manual_seed(0))
    this_ft, this_lib = R.FT, K.lib("fused_tail", this_signatures()[
        "fused_tail"])

    def profile(name, model, other):
        if other:
            R.FT, K._libs["fused_tail"] = pft, libs["fused_tail"]
        try:
            ms, n, rows, _ = CS.profile_frames(model, cfgs[name],
                                               skels[other], s_init, imu,
                                               dev)
        finally:
            R.FT, K._libs["fused_tail"] = this_ft, this_lib
        tail = sum(r[1] for r in rows
                   if "decode_kernel" in r[0] or "tail_kernel" in r[0])
        return dict(device_ms=ms, kernels=n, k2_k3_ms=tail)

    out = {}
    for name, cfg in cfgs.items():
        model = M.TIPModel(cfg.model, device=dev)
        model.load_state_dict(base.state_dict())
        runs = [profile(name, model, o) for o in (True, False, False, True)]
        out[name] = {f"{who}_{f}": [r[f] for r in pair]
                     for who, pair in (("other", runs[::3]),
                                       ("this", runs[1:3]))
                     for f in runs[0]}
        print(f"  path {name}: {json.dumps(out[name])}", flush=True)
    return out


# --this_first: the second order, run by the script itself
FLAGS = ("--bits_only", "--this_first")


def crossover(argv, result):
    """Run this script again with this build first (--this_first, on the
    libraries this run built) and pair each case's this_vs_other of both
    orders:
    {case: {"other_first", "this_first", "geomean"}}, and the child's exit
    code. A bias that follows the order (which build's libraries load and
    launch first) cancels in the geometric mean."""
    cmd = [sys.executable, str(Path(__file__).resolve()), *argv,
           "--this_first"]
    child = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
    print(child.stdout, end="", flush=True)
    lines = [ln for ln in child.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        raise SystemExit(f"the --this_first run printed no result "
                         f"(exit {child.returncode})")
    other = json.loads(lines[-1])

    def ratios(res):
        out = {k: v["this_vs_other"] for k, v in res["turns"].items()}
        out.update({k: v["this_vs_other"]
                    for k, v in res["rnn_bf16"].items()})
        return out
    a, b = ratios(result), ratios(other)
    return {k: {"other_first": a[k], "this_first": b[k],
                "geomean": (a[k] * b[k]) ** 0.5} for k in a}, \
        child.returncode


def main():
    global THIS_FIRST
    flags = {a for a in sys.argv[1:] if a in FLAGS}
    args = [a for a in sys.argv[1:] if a not in FLAGS]
    bits_only = "--bits_only" in flags
    THIS_FIRST = "--this_first" in flags
    if not torch.cuda.is_available() or len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    dev = torch.device("cuda")
    card = CS.card_info()
    print(card, flush=True)
    parent = Path(args[0]).resolve()
    ops = parent / "tip_tpu_torch" / "ops"
    pft = load_module(ops / "fused_tail.py", "other_fused_tail")
    pkin = load_module(ops / "kinematics.py", "other_kinematics")
    pet = load_module(ops / "encoder_train.py", "other_encoder_train")
    pfr = load_module(ops / "fused_rnn.py", "other_fused_rnn")
    other_sigs = {"fused_tail": pft._SIG, "fused_fk": pkin._SIG,
                  "fused_rnn": pfr._SIG, "fused_rnn_bwd": pfr._SIG_BWD,
                  ENCODER: pet._SIG}
    check_abi(parent, other_sigs)
    sigs = this_signatures()
    sigs.update(other_sigs)
    procs = start_builds(parent, parent / "build", "other", THIS_FIRST)
    mine = start_builds(ROOT, K.BUILD_DIR / "compare_local", "local",
                        THIS_FIRST)
    # this checkout's wrappers call this side's renamed build; the side
    # that goes first is loaded first
    sides = [(procs, sigs, "the other"),
             (mine, this_signatures(), "this checkout's")]
    loaded = [load_libs(*side) for side in
              (sides[::-1] if THIS_FIRST else sides)]
    libs = loaded[1] if THIS_FIRST else loaded[0]
    K._libs.update(loaded[0] if THIS_FIRST else loaded[1])
    model = M.TIPModel(M.ModelConfig(forward_impl="fused"), device=dev,
                       generator=torch.Generator().manual_seed(0))
    result = {"card": card, "other": args[0], "this_first": THIS_FIRST,
              "rnn_bf16": rnn_bf16_turns(libs, pfr, dev)}
    if not bits_only:
        result.update(tail=tail_times(libs, pft, pkin, dev),
                      paths=path_profiles(libs, pft, pkin, dev))
    bits = {"k1": k1_bits(libs, pfr, dev),
            "k4_k5": k4_bits(libs, model, dev),
            "k7": k7_bits(libs, model, dev), "k8": k8_bits(libs, model, dev),
            "k9": k9_bits(libs, model, dev), "k10": k10_bits(libs, pfr, dev),
            "k11_k12": k11_k12_bits(libs, pet, model, dev),
            "k11_k12_bf16": encoder_bf16_bits(libs, pet, model, dev)}
    result["bit_equal"] = bits
    result["turns"] = TURNS
    print(json.dumps(result), flush=True)
    rc = 0 if all(v for b in bits.values() for v in b.values()) else 2
    if not THIS_FIRST:
        pairs, child_rc = crossover(sys.argv[1:], result)
        print(json.dumps({"card": card, "other": args[0],
                          "crossover": pairs}), flush=True)
        rc = rc or child_rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
