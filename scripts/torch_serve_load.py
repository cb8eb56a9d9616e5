"""Load the port's serve daemon as chip_smoke.py's path P does in its free
run: --clients clients push 60 Hz wire frames (the in-tree motions) from a
spawned process (tests/torch_wire.py::client_load) and read their lines,
while ServeDaemon.run ticks at 60 Hz for --seconds. Each part of a tick is
timed from outside the daemon: the fill under its lock, the pool step
(synchronised on the card), the encode, the sends and the rest (the host
copy). Beside it: the bare pool step over as many streams with no daemon
around it, the ticker thread's CPU time against its wall time, the threads
the daemon started, the time of each connect's add_stream, and the full
(generation 2) garbage collections once every client connected. Prints
one JSON line.

On cuda the pool takes path P's route at full width (5 SBPs, acc sum,
kv_cache_rnn_carry, the fused cached step K8 in bf16, K2, K3); on the CPU a
1-layer model of width 32 in f32 on the same route's plain versions (the
sandbox's figures in PERF.md). Random weights, seed 0.

  python3 scripts/torch_serve_load.py [--device cpu|cuda] [--clients 64] \
      [--seconds 8] [--cpu_threads 1] [--tree DIR]

--tree imports tip_tpu_torch from another checkout (the parent commit,
unpacked with ``git archive``) to load its daemon through this harness;
parts of a tick that its daemon has no method for are left out of the
split.
"""

import argparse
import gc
import json
import multiprocessing
import os
import pickle
import socket
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "artifacts", "corpus_run_v3", "corpus_extra")
SMALL = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=1,
             rnn_hid_size=32)


def wire_module():
    """tests/torch_wire.py (numpy, scipy and the standard library)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_wire
    return torch_wire


def motion_frames(W, n_clients):
    """Client i replays in-tree motion i % 60 as wire frames."""
    motions = []
    for i in range(min(n_clients, 60)):
        with open(os.path.join(CORPUS, f"freeform2_{i:04d}.pkl"), "rb") as f:
            d = pickle.load(f)    # in-tree motions written by data gen
        motions.append(W.wire_frames(d["imu"]))
    return [motions[i % len(motions)] for i in range(n_clients)]


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def bare_step_ms(pool, W, frames, sync, ticks=100):
    """Median ms of the pool's step (synchronised) over len(frames) streams
    fed their frames, and of its add_stream (synchronised) that adds them,
    with no daemon around it; the streams are removed after."""
    import numpy as np
    from tip_tpu_torch.runtime import calibration as cal
    from tip_tpu_torch.runtime.imu_client import parse_wire_frame
    slots, add_ms = [], []
    for _ in frames:
        t0 = time.perf_counter()
        slots.append(pool.add_stream(cal.t_pose_init_state()))
        sync()
        add_ms.append((time.perf_counter() - t0) * 1e3)
    idle = np.zeros(72, np.float32)
    idle[[0, 4, 8]] = 1.0
    batch = np.tile(idle, (pool.capacity, 1))
    feats = [[parse_wire_frame(np.array(W.wire_text(f[t]).split(),
                                        dtype=float))
              for t in range(ticks + 10)] for f in frames]
    ms = []
    for t in range(ticks + 10):
        for slot, fs in zip(slots, feats):
            batch[slot] = fs[t]
        t0 = time.perf_counter()
        pool.step(batch)
        sync()
        if t >= 10:
            ms.append((time.perf_counter() - t0) * 1e3)
    for slot in slots:
        pool.remove_stream(slot)
    return statistics.median(ms), statistics.median(add_ms)


def free_run(daemon, W, frames, seconds, sync, min_ticks=0,
             max_seconds=120.0, slow=-1, slow_sockbuf=4096, slow_lines=2,
             outbuf=None):
    """ServeDaemon.run at its rate with len(frames) clients in a spawned
    process, for ``seconds`` and at least ``min_ticks`` ticks after every
    client connected (at most ``max_seconds``). Client ``slow`` (-1: none)
    has ``slow_sockbuf`` buffers on both ends and stops reading after
    ``slow_lines`` lines; ``outbuf`` replaces the daemon's MAX_OUTBUF.
    Returns (summary, the daemon's clients once all connected, the slot of
    each client, the lines each read, its non-finite (client, t) pairs)."""
    SD = sys.modules[type(daemon).__module__]
    times = {k: [] for k in ("tick", "fill", "pool_step", "encode", "send",
                             "accept")}

    def timed(fn, key):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if key == "pool_step":
                sync()
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped
    pool = daemon.pool
    hooks = [(o, n, k) for o, n, k in (
        (daemon, "_tick_once", "tick"), (pool, "step", "pool_step"),
        (pool, "add_stream", "accept"), (daemon, "_fill", "fill"),
        (SD, "encode_lines", "encode"), (daemon, "_send", "send"))
        if hasattr(o, n)]
    saved = [(o, n, getattr(o, n)) for o, n, _ in hooks]
    for o, n, k in hooks:
        setattr(o, n, timed(getattr(o, n), k))
    split = [k for _, _, k in hooks if k in ("fill", "encode", "send")]
    max_outbuf = SD.MAX_OUTBUF
    span = {}
    full_gcs = []            # (start, ms) of each full collection

    def on_gc(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                full_gcs.append([time.perf_counter(), None])
            elif full_gcs:
                full_gcs[-1][1] = (time.perf_counter() - full_gcs[-1][0]) * 1e3
    gc.callbacks.append(on_gc)

    def tick_thread():
        span["t0"], c0 = time.perf_counter(), time.thread_time()
        daemon.run()
        span["cpu"] = time.thread_time() - c0
        span["t1"] = time.perf_counter()
    ticker = threading.Thread(target=tick_thread, daemon=True)
    # the clients live in a process of their own, as they would on the
    # network: in the daemon's process their pushing, formatting and
    # parsing would take the interpreter lock from its ticker. The daemon
    # starts once every client sits in its listen backlog
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    load = ctx.Process(target=W.client_load, args=(
        daemon.port, frames, slow, slow_sockbuf, slow_lines, results),
        daemon=True)
    if outbuf is not None:
        SD.MAX_OUTBUF = outbuf
    before = set(threading.enumerate())
    load.start()
    try:
        results.get(timeout=120)
        ticker.start()
        _, slot_of = results.get(timeout=max_seconds)
        t_connected = time.perf_counter()
        connect_s = t_connected - span["t0"]
        connected_at = daemon.ticks
        with daemon._lock:
            served = dict(daemon._clients)
        if slow >= 0:
            served[slot_of[slow]].conn.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDBUF, slow_sockbuf)
        W.wait_until(lambda: time.perf_counter() - span["t0"] >= seconds
                     and daemon.ticks >= connected_at + min_ticks,
                     "the free run's ticks", max_seconds, poll=0.05)
        threads = len(set(threading.enumerate()) - before)
        daemon.stop()
        W.join(ticker, "the ticker", 60.0)
        _, n_lines, bad = results.get(timeout=120)
        load.join(30)
    finally:
        gc.callbacks.remove(on_gc)
        SD.MAX_OUTBUF = max_outbuf
        for o, n, fn in saved:
            setattr(o, n, fn)
        daemon.stop()
        if load.is_alive():
            load.terminate()
    if load.exitcode != 0:
        raise RuntimeError(f"the clients' process exited with "
                           f"{load.exitcode}")
    steady = {k: v[connected_at:] for k, v in times.items() if k != "accept"}
    steady["other"] = [t - sum(steady[k][i] for k in ["pool_step"] + split)
                       for i, t in enumerate(steady["tick"])]
    due = int((span["t1"] - span["t0"]) * daemon.hz)
    summary = dict(
        clients=len(frames), ticks_done=daemon.ticks, ticks_due=due,
        ticks_share=daemon.ticks / due, seconds=span["t1"] - span["t0"],
        connected_at_tick=connected_at, connect_s=connect_s,
        accept_ms_p50=pct(times["accept"], 0.5),
        accept_ms_max=max(times["accept"]),
        accept_ms_total=sum(times["accept"]),
        ticker_cpu_s=span["cpu"], ticker_wall_s=span["t1"] - span["t0"],
        threads=threads,
        lines_received_min=min(n for i, n in enumerate(n_lines)
                               if i != slow),
        lines_dropped={str(c.slot): c.dropped for c in served.values()
                       if c.dropped},
        non_finite_lines=len(bad),
        full_gc_ms_after_connect=[ms for t, ms in full_gcs
                                  if t >= t_connected])
    for k, v in steady.items():
        summary[f"{k}_ms_p50"] = pct(v, 0.5)
        summary[f"{k}_ms_p99"] = pct(v, 0.99)
    return summary, served, slot_of, n_lines, bad


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--cpu_threads", type=int, default=1,
                    help="torch's intra-op threads on the CPU (the clients' "
                         "process shares the cores)")
    ap.add_argument("--tree", default=None,
                    help="import tip_tpu_torch from this checkout")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree or ROOT))
    import torch
    from tip_tpu_torch import constants as cst
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.runtime import calibration as cal
    from tip_tpu_torch.runtime import runner as R
    from tip_tpu_torch.runtime.serve_daemon import ServeDaemon
    from tip_tpu_torch.runtime.serving import StreamPool

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("torch_serve_load: no CUDA device (--device cpu "
                         "runs the plain versions on the CPU)")
    if not on_card:
        torch.set_num_threads(args.cpu_threads)
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    model_cfg = M.ModelConfig(
        size_s=cst.state_dim(5), with_acc_sum=True, forward_impl="fused",
        compute_dtype="bfloat16" if on_card else None,
        **({} if on_card else SMALL))
    model = M.TIPModel(model_cfg, device=dev,
                       generator=torch.Generator().manual_seed(0))
    cfg = R.RunnerConfig(model=model_cfg, n_sbps=5, with_acc_sum=True,
                         serving_mode="kv_cache_rnn_carry")
    pool = StreamPool(model, cfg, capacity=args.clients, device=dev)
    W = wire_module()
    frames = motion_frames(W, args.clients)
    bare, bare_add = bare_step_ms(pool, W, frames, sync)
    logged = []
    daemon = ServeDaemon(pool, cal.t_pose_init_state(), port=0,
                         log=logged.append)
    summary = free_run(daemon, W, frames, args.seconds, sync)[0]
    summary.update(
        device=card() if on_card else "cpu (plain versions)",
        tree=args.tree or "this checkout", bare_step_ms_p50=bare,
        bare_add_stream_ms_p50=bare_add,
        cpu_threads=None if on_card else args.cpu_threads,
        step_over_bare=summary["pool_step_ms_p50"] / bare,
        failed_ticks=sum("failed" in m for m in logged),
        model={k: getattr(model_cfg, k) for k in SMALL},
        compute_dtype=model_cfg.compute_dtype or "float32")
    print(json.dumps({"serve_load": summary}))


if __name__ == "__main__":
    main()
