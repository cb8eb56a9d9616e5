#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tip_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. require CUDA, turn TF32 off, print the card's name and power limit;
  2. build the CUDA kernels from tip_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, and time both (and K1's cuDNN yardstick);
  4. run the main path: the full-width model (ModelConfig() defaults, random
     weights from a seeded generator) in the recompute streaming runner over
     the in-tree 720-frame motion, with every launch counter reset just
     before and read just after; compare it with the plain path on the card
     and with a float64 CPU run of the plain path; time frames;
  5. print one {"kernels": [...]} line, then the {"ok": true, ...} line.
"""

import json
import math
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
MOTION = ROOT / "artifacts" / "corpus_run_v3" / "corpus_extra" / \
    "freeform2_0000.pkl"

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores (every kernel here computes in f32 on the
# CUDA cores)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

# tolerances of the kernel checks (f32 on the card, kernel vs plain)
TOL = 1e-5
# residues (and their clipped feet mean) divide a position difference by
# dt = 1/60: rounding of ~1e-7 m is amplified 60x, hence 1e-4
TOL_RES = 1e-4
# main path, kernels vs plain on the card, and card f32 vs CPU f64: an
# autoregressive 40-frame window of a random model feeds rounding back
TOL_PATH = 1e-3
PATH_FRAMES = 300
CPU_FRAMES = 120

# arithmetic per item of K2/K3, counted from csrc/fused_tail.cu (an add,
# multiply, divide, sqrt, compare or transcendental each counts one)
OPS_MATRIX_TO_Q = 40
OPS_SIXD_TO_Q = 71          # two column normalisations + cross + Shepperd
OPS_AA_TO_Q = 15
OPS_TREE_STEP = 61          # rotate the offset, add, compose the quats
OPS_LINK_FRAME = 33         # rotate the CoM offset, add
OPS_HIST_ROW = 27           # normalise + 6 matrix entries
OPS_SBP_RESIDUE = 80
OPS_FEET_MEAN = 15


def log(msg):
    print(msg, flush=True)


def time_ms(fn, n=200, warmup=20):
    """Median time of one eager call on the device stream over n calls
    (CUDA events around each call, so host launch gaps count), after a
    warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def graph_ms(fn, per_graph=20, replays=50):
    """Device time of one call without host launch gaps: per_graph calls
    captured in one CUDA graph, replayed back to back, CUDA events around
    all replays, divided by the number of calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(replays):
        g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (replays * per_graph)


def timings(kernel, plain, library=None):
    """ms (kernel device time), plain_ms and library_ms the same way, and
    the eager per-call times beside them."""
    out = dict(ms=graph_ms(kernel), plain_ms=graph_ms(plain),
               call_ms=time_ms(kernel), plain_call_ms=time_ms(plain),
               library_ms=None, library_call_ms=None)
    if library is not None:
        out.update(library_ms=graph_ms(library),
                   library_call_ms=time_ms(library))
    return out


def bound(nbytes, ops):
    """Least time (ms) for the work on the card, and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_err(a, b):
    """Max |a - b| over entries that are not NaN in both; raises if the NaN
    patterns differ."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        raise AssertionError("NaN patterns differ")
    d = (a - b).abs()[~na]
    return d.max().item() if d.numel() else 0.0


def check(name, errs):
    """errs: {output: (err, tol)}. Raise if any output is out of its
    tolerance; return the max error."""
    for out, (err, tol) in errs.items():
        if not err <= tol:
            raise AssertionError(f"{name}.{out}: max |kernel - plain| = "
                                 f"{err:.3g} > {tol:g}")
    return max(err for err, _ in errs.values())


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip()


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def check_fused_rnn(dev, gen):
    from tip_tpu_torch.ops import fused_rnn as FR
    H, T = 512, 40
    w = ((torch.rand(H, H, generator=gen, device=dev) * 2 - 1)
         / math.sqrt(H))
    errs = {}
    for B in (1, 8):
        xin = torch.randn(B, T, H, generator=gen, device=dev) * 0.5
        out = FR.fused_rnn(xin, w, impl="kernel")
        ref = FR.fused_rnn_plain(xin, w)
        errs[f"B{B}"] = (max_err(out, ref), TOL)
    err = check("fused_rnn", errs)
    # time at the main path's shape
    xin = torch.randn(1, T, H, generator=gen, device=dev) * 0.5
    # yardstick only: cuDNN's tanh RNN with W_ih = I and zero biases is the
    # same function of xin; the port never calls it
    rnn = torch.nn.RNN(H, H, nonlinearity="tanh", batch_first=True).to(dev)
    with torch.no_grad():
        rnn.weight_ih_l0.copy_(torch.eye(H, device=dev))
        rnn.weight_hh_l0.copy_(w.T)
        rnn.bias_ih_l0.zero_()
        rnn.bias_hh_l0.zero_()
        lib_err = max_err(rnn(xin)[0], FR.fused_rnn_plain(xin, w))
        if not lib_err <= TOL:
            raise AssertionError(f"cuDNN yardstick disagrees: {lib_err:.3g}")
        times = timings(lambda: FR.fused_rnn(xin, w, impl="kernel"),
                        lambda: FR.fused_rnn_plain(xin, w),
                        lambda: rnn(xin))
    nbytes = 4 * (2 * T * H + H * H)
    ops = T * H * (2 * H + 2)
    b_ms, b_by = bound(nbytes, ops)
    return dict(name="fused_rnn", route="cuda",
                source="tip_tpu_torch/csrc/fused_rnn.cu",
                replaces="tip_tpu/ops/pallas_kernels.py:67",
                shape=[1, T, H], max_abs_err=err, tol=TOL, bound_ms=b_ms,
                bound_by=b_by, **times)


def check_decode_fused(dev, gen):
    from tip_tpu_torch.ops import fused_tail as FT
    from tip_tpu_torch.ops import rotations as rot
    D, nf, n_sbps = 131, 6, 5
    coeff = torch.tensor([0.6 ** i for i in range(nf - 1, -1, -1)],
                         dtype=torch.float32, device=dev)
    errs = {}
    cases = []
    for i in range(8):
        y_t = torch.randn(D, generator=gen, device=dev)
        filt = torch.randn(nf, D, generator=gen, device=dev)
        aa = torch.randn(3, generator=gen, device=dev)
        if i == 6:                       # near pi: the x/y/z branches
            aa = aa / aa.norm() * (math.pi - 1e-3)
        if i == 7:                       # identity
            aa = torch.zeros(3, device=dev)
        local9 = rot.aa_to_matrix(aa).reshape(9).contiguous()
        for use_filter in (False, True):
            out = FT.decode_fused(y_t, filt, coeff, use_filter, local9,
                                  impl="fused")
            ref = FT.decode_fused_plain(y_t, filt, coeff, use_filter, local9)
            for f in out._fields:
                e = max_err(getattr(out, f), getattr(ref, f))
                errs[f] = (max(e, errs.get(f, (0.0, TOL))[0]), TOL)
        cases.append((y_t, filt, local9))
    err = check("decode_fused", errs)
    y_t, filt, local9 = cases[0]
    times = timings(lambda: FT.decode_fused(y_t, filt, coeff, True, local9,
                                            impl="fused"),
                    lambda: FT.decode_fused_plain(y_t, filt, coeff, True,
                                                  local9))
    # the timed call filters (use_filter=True), so it reads filt and not
    # y_t: filt, coeff, local9 in; y_f, c_t, q out
    nbytes = 4 * (nf * D + nf + 9 + D + 4 * n_sbps + 18 * 4)
    ops = (2 * nf * D + D + nf + 4 * n_sbps + OPS_MATRIX_TO_Q
           + 17 * OPS_SIXD_TO_Q)
    b_ms, b_by = bound(nbytes, ops)
    return dict(name="decode_fused", route="cuda",
                source="tip_tpu_torch/csrc/fused_tail.cu",
                replaces="tip_tpu/ops/fused_tail.py:228", shape=[D],
                max_abs_err=err, tol=TOL, bound_ms=b_ms, bound_by=b_by,
                **times)


def check_tail_fused(dev, gen, skel):
    from tip_tpu_torch.ops import fused_tail as FT
    from tip_tpu_torch.ops import kinematics as kin
    tols = dict(pq_com=TOL, pq_jf=TOL, hist_sixd=TOL, c_locs=TOL,
                active=0.0, vel_res=TOL_RES, raw_res=TOL_RES)
    errs = {}
    inputs = None
    for _ in range(8):
        s = torch.randn(114, generator=gen, device=dev) * 0.4
        s[2] += 0.9
        ct = torch.randn(5, 4, generator=gen, device=dev)
        ct[:, 0] = (ct[:, 0] > 0).float()             # decoded flags
        ct[:, 1:] *= 0.05                             # decoded offsets
        ct = ct.reshape(-1)
        prev_s = s + torch.randn(114, generator=gen, device=dev) * 0.01
        prev_pq = kin.fk_our_state(skel, prev_s).contiguous()
        out = FT.tail_fused(skel, s, ct, prev_pq, impl="fused")
        ref = FT.tail_fused_plain(skel, s, ct, prev_pq)
        for f in out._fields:
            e = max_err(getattr(out, f), getattr(ref, f))
            errs[f] = (max(e, errs.get(f, (0.0, 0.0))[0]), tols[f])
        inputs = (s, ct, prev_pq)
    err = check("tail_fused", errs)
    s, ct, prev_pq = inputs
    times = timings(lambda: FT.tail_fused(skel, s, ct, prev_pq, impl="fused"),
                    lambda: FT.tail_fused_plain(skel, s, ct, prev_pq))
    J, L = skel.n_joints, skel.n_joints + 1
    # what the kernel reads: s[0:57] (root position + 18 axis-angles), the
    # 20 SBP floats, the 5 SBP rows of prev_pq, both offset tables and the
    # three int32 tables (parent, is_fixed, slot); what it writes: TailOut
    nbytes = (4 * (57 + 20 + 5 * 7 + 3 * J + 3 * L + 3 * J)
              + 4 * (2 * 7 * L + 108 + 3 + 15 + 15 + 5))
    ops = (18 * OPS_AA_TO_Q + J * OPS_TREE_STEP + L * OPS_LINK_FRAME
           + 18 * OPS_HIST_ROW + 5 * OPS_SBP_RESIDUE + OPS_FEET_MEAN)
    b_ms, b_by = bound(nbytes, ops)
    return dict(name="tail_fused", route="cuda",
                source="tip_tpu_torch/csrc/fused_tail.cu",
                replaces="tip_tpu/ops/fused_tail.py:341", shape=[114],
                max_abs_err=err, tol=TOL_RES, bound_ms=b_ms, bound_by=b_by,
                **times)


# ---------------------------------------------------------------------------
# 4. the main path
# ---------------------------------------------------------------------------

def load_motion():
    with open(MOTION, "rb") as f:     # in-tree motion written by data gen
        d = pickle.load(f)
    return d["imu"], d["nimble_qdq"][0]


def first_disagreement(a, b, tol):
    bad = ((a - b).abs() > tol).reshape(a.shape[0], -1).any(dim=1)
    idx = torch.nonzero(bad)
    return int(idx[0]) if idx.numel() else None


def compare_runs(what, runs_a, runs_b, frames, tol):
    for name, a, b in zip(("s_traj", "c_traj", "viz"), runs_a, runs_b):
        a, b = a[:frames].double().cpu(), b[:frames].double().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: {name} is not finite")
        err = (a - b).abs().max().item()
        log(f"  {what} {name}: max |diff| over {frames} frames = {err:.3g}")
        if not err <= tol:
            f0 = first_disagreement(a, b, tol)
            c = runs_a[1][:frames].cpu(), runs_b[1][:frames].cpu()
            flags = torch.nonzero((c[0][:, 0::4] != c[1][:, 0::4]).any(1))
            flip = int(flags[0]) if flags.numel() else None
            raise AssertionError(
                f"{what}: {name} differs by {err:.3g} > {tol:g}; first "
                f"frame out of tolerance {f0}, first SBP flag flip {flip}")


def frame_times_ms(model, cfg, skel, s_init, imu, dev):
    """Per-frame host time of runner_step with a synchronise after each
    frame (eager launches), over the frames that run the model."""
    from tip_tpu_torch.runtime import runner as R
    carry = R.runner_init(cfg, skel, s_init, device=dev)
    imu = torch.as_tensor(imu, dtype=torch.float32, device=dev)
    times = []
    with torch.no_grad():
        for t in range(imu.shape[0] - 1):
            t0 = time.perf_counter()
            carry, _ = R.runner_step(model, carry, imu[t], cfg, skel)
            torch.cuda.synchronize()
            if t >= cfg.imu_n_smooth:
                times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_frames(model, cfg, skel, s_init, imu, dev, first=100, n=50):
    """Device time per frame by kernel over n steady frames
    (torch.profiler), from frame `first` on, and the median host time of
    those same frames (synchronised each frame, profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    from tip_tpu_torch.runtime import runner as R
    carry = R.runner_init(cfg, skel, s_init, device=dev)
    imu = torch.as_tensor(imu, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for t in range(first):
            carry, _ = R.runner_step(model, carry, imu[t], cfg, skel)
        torch.cuda.synchronize()
        times = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for t in range(first, first + n):
                t0 = time.perf_counter()
                carry, _ = R.runner_step(model, carry, imu[t], cfg, skel)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return (sum(r[1] for r in rows), sum(r[2] for r in rows), rows,
            statistics.median(times))


def main_path(dev):
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import runner as R

    imu, s_init = load_motion()
    cfg = R.RunnerConfig()                  # rnn_impl / tail_impl "auto"
    model = M.TIPModel(cfg.model, device=dev,
                       generator=torch.Generator().manual_seed(0))
    skel = kin.amass_skeleton(device=dev)
    n_frames = imu.shape[0] - 1
    n_model = sum(1 for t in range(n_frames) if t >= cfg.imu_n_smooth)

    K.reset_launch_counts()
    t0 = time.perf_counter()
    runs = R.run_offline(model, cfg, skel, s_init, imu, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.launch_counts)
    log(f"main path: {n_frames} frames in {wall:.3f} s "
        f"({wall / n_frames * 1e3:.3f} ms/frame, no per-frame sync); "
        f"launches {launches}")
    for name in ("fused_rnn", "decode_fused", "tail_fused"):
        if launches.get(name, 0) != n_model:
            raise AssertionError(
                f"{name} launched {launches.get(name, 0)} times on the main "
                f"path, expected one per model frame ({n_model})")
    for a, shape in zip(runs, [(imu.shape[0], 114), (imu.shape[0], 20),
                               (imu.shape[0], 5, 3)]):
        if tuple(a.shape) != shape or not torch.isfinite(a).all():
            raise AssertionError(f"main path output {tuple(a.shape)} is not "
                                 f"a finite {shape}")

    # the same stream through the plain versions on the card
    cfg_p = R.RunnerConfig(model=M.ModelConfig(rnn_impl="plain"),
                           tail_impl="plain")
    model_p = M.TIPModel(cfg_p.model, device=dev)
    model_p.load_state_dict(model.state_dict())
    K.reset_launch_counts()
    runs_p = R.run_offline(model_p, cfg_p, skel, s_init, imu, device=dev)
    torch.cuda.synchronize()
    if sum(K.launch_counts.values()):
        raise AssertionError(f"plain path launched {dict(K.launch_counts)}")
    compare_runs("kernels vs plain (card)", runs, runs_p, PATH_FRAMES,
                 TOL_PATH)

    # reference: the plain path in float64 on the CPU, first frames
    cfg_c = R.RunnerConfig(model=M.ModelConfig(rnn_impl="plain"),
                           tail_impl="plain")
    model_c = M.TIPModel(cfg_c.model, device="cpu", dtype=torch.float64)
    model_c.load_state_dict(model.state_dict())
    runs_c = R.run_offline(model_c, cfg_c,
                           kin.amass_skeleton(dtype=torch.float64),
                           s_init, imu[:CPU_FRAMES + 1], device="cpu")
    compare_runs("card f32 vs CPU f64", runs, runs_c, CPU_FRAMES, TOL_PATH)

    # per-frame time, eager, kernels and plain in turns
    t_k, t_p = [], []
    for _ in range(2):
        t_k.append(frame_times_ms(model, cfg, skel, s_init, imu, dev))
        t_p.append(frame_times_ms(model_p, cfg_p, skel, s_init, imu, dev))
    log(f"per-frame median ms (eager, sync per frame): kernels {t_k}, "
        f"plain {t_p}")
    frame_ms = statistics.median(t_k)

    dev_ms, n_kernels, rows, prof_frame_ms = profile_frames(
        model, cfg, skel, s_init, imu, dev)
    # busy share of the profiled frames themselves: their device time over
    # their median host time (the profiler's own host cost included)
    log(json.dumps({"profile": {
        "device_ms_per_frame": dev_ms, "kernels_per_frame": n_kernels,
        "frame_ms_profiled": prof_frame_ms,
        "device_busy_share": dev_ms / prof_frame_ms,
        "top": [[k[:70], ms, c] for k, ms, c in rows[:12]]}}))
    return launches, frame_ms, statistics.median(t_p)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import kinematics as kin

    dev = torch.device("cuda")
    card = card_info()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    K.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {K.sources()}")

    gen = torch.Generator(device=dev).manual_seed(1)
    skel = kin.amass_skeleton(device=dev)
    kernels = [check_fused_rnn(dev, gen), check_decode_fused(dev, gen),
               check_tail_fused(dev, gen, skel)]
    torch.cuda.synchronize()
    for k in kernels:
        log(f"  {k['name']}: max err {k['max_abs_err']:.3g} (tol "
            f"{k['tol']:g}), device {k['ms']:.4f} ms (eager call "
            f"{k['call_ms']:.4f}), plain {k['plain_ms']:.4f} "
            f"({k['plain_call_ms']:.4f}), bound {k['bound_ms']:.2e} ms "
            f"({k['bound_by']}), library {k['library_ms']}")

    launches, frame_ms, frame_plain_ms = main_path(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(json.dumps({"frame_ms": frame_ms, "frame_plain_ms": frame_plain_ms,
                    "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
