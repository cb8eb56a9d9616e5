"""The port's live I/O and serving daemon on the CPU, against tip_tpu's:
calibration, the wire format, the seqlock slot, the latency histogram and
the profiler trace; IMUClient against an in-process wire server (and the
native bridge where it is built); ServeDaemon driven in lockstep beside
tip_tpu's on the same float64 weights, a pool-full refusal and a recycled
slot included, at 8 clients and with a malformed client; the port's two
threads; a client the ticker drops and a new one on its descriptor; the
slow-client path; the one-pass line encode; the serve and live-demo CLIs.
Mirrors tests/test_live_io.py. Every socket and thread wait has a deadline
(tests/torch_wire.py).
"""

import builtins
import functools
import json
import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy.spatial.transform import Rotation

import torch_wire as W
from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import calibration as jcal
from tip_tpu.runtime import imu_client as jio
from tip_tpu.runtime import runner as JR
from tip_tpu.runtime import serve_daemon as jsd
from tip_tpu.runtime import serving as JS
from tip_tpu.utils import observability as jobs
from tip_tpu_torch import constants as tcst
from tip_tpu_torch.cli import live_demo as TLD
from tip_tpu_torch.cli import serve as TSV
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import calibration as tcal
from tip_tpu_torch.runtime import full_runner as TFR
from tip_tpu_torch.runtime import imu_client as tio
from tip_tpu_torch.runtime import runner as TR
from tip_tpu_torch.runtime import serve_daemon as tsd
from tip_tpu_torch.runtime import serving as TS
from tip_tpu_torch.utils import observability as tobs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "artifacts" / "corpus_run_v3" / "corpus_extra"
BRIDGE = ROOT / "native" / "build" / "imu_bridge"
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
RNG = np.random.default_rng(17)
# the daemon rounds its poses to 5 places: two runs that differ in the
# last bits of a value can round it either way
TOL_LINE = 1e-5
# the pools' own outputs, float64 arithmetic in another order
TOL_F64 = 1e-8


def _readings(n):
    """n random raw readings (72,): rotation matrices and accs."""
    r = Rotation.from_rotvec(RNG.normal(size=(n * 6, 3))).as_matrix()
    return np.concatenate([r.reshape(n, 54), RNG.normal(size=(n, 18))], 1)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_calibration_equals_tip_tpus():
    aligned, tpose, stream = _readings(3)
    np.testing.assert_array_equal(tcal.aligned_t_pose_bone_rotations(),
                                  jcal.aligned_t_pose_bone_rotations())
    np.testing.assert_array_equal(tcal.t_pose_init_state(),
                                  jcal.t_pose_init_state())
    for a, b in zip(tcal.heading_reset(aligned), jcal.heading_reset(aligned)):
        np.testing.assert_array_equal(a, b)
    tc, jc = tcal.calibrate(aligned, tpose), jcal.calibrate(aligned, tpose)
    for f in ("r_gn_gp", "acc_offset_gp", "r_b0_s0"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    np.testing.assert_array_equal(tcal.transform_reading(tc, stream),
                                  jcal.transform_reading(jc, stream))


def simulate_sensor_stack(rng):
    """Random heading offsets + mount transforms; returns a function mapping
    true bone rotations/accelerations to raw sensor readings (as
    tests/test_live_io.py's)."""
    r_gn_gp = Rotation.from_rotvec(
        np.outer(rng.uniform(-1, 1, 6), [0, 0, 1])).as_matrix()
    r_b0_s0 = Rotation.from_rotvec(rng.normal(size=(6, 3))).as_matrix()
    gravity_gp = np.tile([0, 0, 9.81], (6, 1))

    def reading(r_gp_bt, acc_free_gp):
        r_gp_st = np.einsum("nij,njk->nik", r_gp_bt, r_b0_s0)
        r_gn_st = np.einsum("nij,njk->nik", r_gn_gp, r_gp_st)
        acc_gp = acc_free_gp + gravity_gp
        acc_st = np.einsum("nji,nj->ni", r_gp_st, acc_gp)
        return np.concatenate([r_gn_st.reshape(-1), acc_st.reshape(-1)])

    return reading, r_b0_s0


def test_calibration_recovers_bone_frames():
    rng = np.random.default_rng(13)
    reading, r_b0_s0_true = simulate_sensor_stack(rng)
    mean_aligned = reading(np.transpose(r_b0_s0_true, (0, 2, 1)),
                           np.zeros((6, 3)))
    mean_tpose = reading(tcal.aligned_t_pose_bone_rotations(),
                         np.zeros((6, 3)))
    c = tcal.calibrate(mean_aligned, mean_tpose)
    np.testing.assert_allclose(c.r_b0_s0, r_b0_s0_true, atol=1e-10)
    r_true = Rotation.from_rotvec(rng.normal(size=(6, 3)) * 0.8).as_matrix()
    acc_free = rng.normal(size=(6, 3)) * 2.0
    out = tcal.transform_reading(c, reading(r_true, acc_free))
    np.testing.assert_allclose(out[:54].reshape(6, 3, 3), r_true, atol=1e-10)
    np.testing.assert_allclose(out[54:].reshape(6, 3), acc_free, atol=1e-10)


# ---------------------------------------------------------------------------
# the wire format, the slot, the histogram, the trace
# ---------------------------------------------------------------------------

def test_parse_wire_frame_equals_tip_tpus():
    for frame in W.wire_frames(_readings(8)).astype(np.float64):
        np.testing.assert_array_equal(tio.parse_wire_frame(frame),
                                      jio.parse_wire_frame(frame))


_TEXT = "".join(W.wire_text(f) for f in W.wire_frames(_readings(3)))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, len(_TEXT)), max_size=12))
def test_drain_wire_frames_equals_tip_tpus_at_any_cut(cuts):
    """The same frames and the same tail as tip_tpu's drain, whichever
    characters the buffer is cut at."""
    bounds = [0] + sorted(cuts) + [len(_TEXT)]
    got = {"port": [], "tip_tpu": []}
    tails = {"port": "", "tip_tpu": ""}
    for lo, hi in zip(bounds, bounds[1:]):
        chunk = _TEXT[lo:hi]
        tails["port"] = tio.drain_wire_frames(tails["port"] + chunk,
                                              got["port"].append)
        tails["tip_tpu"] = jio.drain_wire_frames(tails["tip_tpu"] + chunk,
                                                 got["tip_tpu"].append)
    assert tails["port"] == tails["tip_tpu"]
    assert len(got["port"]) == len(got["tip_tpu"]) == 3
    for a, b in zip(got["port"], got["tip_tpu"]):
        np.testing.assert_array_equal(a, b)


def test_seqlock_slot():
    s = tio.SeqlockSlot(4)
    assert s.read() is None
    s.write(np.arange(4.0))
    np.testing.assert_array_equal(s.read(), np.arange(4.0))
    s.write(np.arange(4.0) + 1)
    np.testing.assert_array_equal(s.read(), np.arange(4.0) + 1)


@pytest.mark.parametrize("n", [0, 1, 7, 16, 41])
def test_latency_histogram_summary_equals_tip_tpus(n):
    """The same summary for the same records, past the reservoir's
    capacity (16) too."""
    t, j = tobs.LatencyHistogram(16), jobs.LatencyHistogram(16)
    for v in np.random.default_rng(n).exponential(0.004, n):
        t.record(v)
        j.record(v)
    assert t.summary() == j.summary()
    with t.timed():
        pass
    assert t.summary()["count"] == n + 1


def test_profile_trace_writes_a_trace(tmp_path):
    with tobs.profile_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    with tobs.profile_trace(None):
        torch.ones(4).sum()
    assert not (tmp_path / "None").exists()


# ---------------------------------------------------------------------------
# IMUClient
# ---------------------------------------------------------------------------

def _matches_some_frame(reading, frames):
    got = reading[:54].reshape(6, 3, 3)
    return any(np.abs(got - Rotation.from_quat(f.reshape(6, 7)[:, :4])
                      .as_matrix()).max() < 1e-6 for f in frames)


def test_imu_client_against_an_in_process_server():
    frames = W.wire_frames(_readings(30))
    server = W.ReplayServer(frames, hz=240.0)
    client = tio.IMUClient(port=server.port)
    try:
        client.start()
        W.wait_until(lambda: client.frames_received >= 5, "5 frames", 30.0)
        reading = client.current_reading()
    finally:
        client.stop()
        server.stop()
    assert reading is not None and reading.shape == (72,)
    assert _matches_some_frame(reading, frames)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(not BRIDGE.exists(), reason="native bridge not built "
                    "(make -C native)")
def test_bridge_replay_roundtrip(tmp_path):
    """Native replay server -> the port's IMUClient: frames arrive intact
    (on a free port: the suite runs in parallel workers)."""
    frames = W.wire_frames(_readings(30))
    path = tmp_path / "frames.f32"
    frames.tofile(path)
    port = _free_port()
    proc = subprocess.Popen([str(BRIDGE), "--replay", str(path), "--port",
                             str(port), "--hz", "240"],
                            stderr=subprocess.DEVNULL)
    client = tio.IMUClient(port=port)
    try:
        W.wait_until(lambda: _connects(client), "the bridge to listen", 10.0,
                     poll=0.05)
        W.wait_until(lambda: client.frames_received >= 5, "5 frames", 10.0)
        reading = client.current_reading()
    finally:
        client.stop()
        proc.kill()
        proc.wait(timeout=10)
    assert _matches_some_frame(reading, frames)


def _connects(client):
    try:
        client.start()
    except ConnectionRefusedError:
        client._thread = None
        return False
    return True


# ---------------------------------------------------------------------------
# the serve daemon, in lockstep beside tip_tpu's
# ---------------------------------------------------------------------------

def _pair(mode="recompute", seed=0):
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**TINY), serving_mode=mode)
    tcfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY), serving_mode=mode)
    params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float64),
        JM.init_params(jax.random.PRNGKey(seed), jcfg.model))
    model = TM.TIPModel(tcfg.model, device="cpu", dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return (jcfg, params), (tcfg, model)


def _recording(pool):
    """Record every tick's raw qdq of a pool (the daemon rounds them)."""
    seen, step = [], pool.step

    def recorded(batch):
        out = step(batch)
        seen.append(np.asarray(out["qdq"], np.float64).copy())
        return out
    pool.step = recorded
    return seen


def _motion_frames(i, n):
    with open(CORPUS / f"freeform2_{i:04d}.pkl", "rb") as f:
        d = pickle.load(f)       # in-tree motion written by data gen
    return W.wire_frames(d["imu"][:n])


def _drive(daemon, pool, parse, n1=12, n2=10):
    """Two clients for n1 lockstep ticks; a third is refused (pool full);
    the first leaves and a new client takes its slot; n2 more ticks. Returns
    the lines by client."""
    frames = [_motion_frames(i, n1 + n2) for i in range(3)]
    accept = W.start_accepting(daemon)
    a, b = W.LineClient(daemon.port), W.LineClient(daemon.port)
    lines = {"a": [], "b": [], "c": []}
    try:
        assert {a.slot, b.slot} == {0, 1}
        for t in range(n1):
            la, lb = W.lockstep_tick(daemon, parse,
                                     [(a, frames[0][t]), (b, frames[1][t])])
            lines["a"].append(la)
            lines["b"].append(lb)
        full = W.LineClient(daemon.port)
        assert full.hello == {"error": "pool full"}
        full.close()
        a.close()
        W.wait_dropped(daemon, pool, a.slot)
        c = W.LineClient(daemon.port)
        assert c.slot == a.slot
        for t in range(n2):
            lb, lc = W.lockstep_tick(daemon, parse, [(b, frames[1][n1 + t]),
                                                     (c, frames[2][t])])
            lines["b"].append(lb)
            lines["c"].append(lc)
        c.close()
        b.close()
    finally:
        W.stop_accepting(daemon, accept)
    return lines


@pytest.fixture(scope="module")
def lockstep_runs():
    (jcfg, params), (tcfg, model) = _pair()
    s_init = jcal.t_pose_init_state()
    jpool = JS.StreamPool(params, jcfg, jkin.amass_skeleton(
        dtype=jnp.float64), capacity=2, dtype=jnp.float64)
    tpool = TS.StreamPool(model, tcfg, tkin.amass_skeleton(
        dtype=torch.float64), capacity=2, dtype=torch.float64, device="cpu")
    raws, lines = {}, {}
    for name, pool, daemon_cls, parse in (
            ("tip_tpu", jpool, jsd.ServeDaemon, jio.parse_wire_frame),
            ("port", tpool, tsd.ServeDaemon, tio.parse_wire_frame)):
        raws[name] = _recording(pool)
        daemon = daemon_cls(pool, s_init, port=0, log=lambda *a: None)
        lines[name] = _drive(daemon, pool, parse)
    return lines, raws


def test_serve_daemon_lockstep_lines_equal_tip_tpus(lockstep_runs):
    lines, raws = lockstep_runs
    for who in ("a", "b", "c"):
        got, want = lines["port"][who], lines["tip_tpu"][who]
        assert len(got) == len(want) > 0
        assert [g["t"] for g in got] == [w["t"] for w in want]
        assert all(set(g) == {"t", "qdq"} for g in got)
        q_got = np.array([g["qdq"] for g in got])
        q_want = np.array([w["qdq"] for w in want])
        assert q_got.shape == (len(got), 114)
        assert np.isfinite(q_got).all()
        np.testing.assert_allclose(q_got, q_want, atol=TOL_LINE, rtol=0,
                                   err_msg=who)
    # the ticks: 12 with a, b, then 10 with b and c on a's recycled slot
    assert [g["t"] for g in lines["port"]["c"]] == list(range(12, 22))
    np.testing.assert_allclose(np.array(raws["port"]),
                               np.array(raws["tip_tpu"]), atol=TOL_F64,
                               rtol=0)


def test_serve_daemon_recycled_slot_starts_fresh(lockstep_runs):
    """The client on the recycled slot starts from s_init (its warm-up
    frames return it), not from the departed client's stream."""
    lines, _ = lockstep_runs
    s_init = np.round(tcal.t_pose_init_state(), 5)
    first_c = np.array(lines["port"]["c"][0]["qdq"])
    np.testing.assert_allclose(first_c, s_init, atol=TOL_LINE)
    last_a = np.array(lines["port"]["a"][-1]["qdq"])
    assert np.abs(first_c - last_a).max() > 1e-3


def test_serve_daemon_slow_client_never_stalls_tick(monkeypatch):
    """A client that stops reading must not stall the tick for the others:
    its lines are dropped once its buffers fill, while the fast client
    receives every tick (mirrors tests/test_live_io.py's)."""
    _, (tcfg, model) = _pair()
    pool = TS.StreamPool(model, tcfg, tkin.amass_skeleton(
        dtype=torch.float64), capacity=2, dtype=torch.float64, device="cpu")
    pool.step(np.zeros((2, 72)))
    monkeypatch.setattr(tsd, "MAX_OUTBUF", 4096)
    daemon = tsd.ServeDaemon(pool, tcal.t_pose_init_state(), port=0,
                             hz=240.0, log=lambda *a: None, sndbuf=4096)
    ticker = threading.Thread(target=daemon.run, kwargs={"seconds": 120.0},
                              daemon=True)
    ticker.start()
    fast = slow = None
    try:
        fast, slow = W.LineClient(daemon.port), W.LineClient(daemon.port)
        slow.send(np.tile([0.0, 0, 0, 1, 0, 0, 0], 6))
        ticks = [json.loads(fast.read_line())["t"] for _ in range(120)]
        assert ticks == sorted(ticks)
        W.wait_until(lambda: daemon._clients[slow.slot].dropped > 0,
                     "the slow client's lines to be dropped")
        with daemon._lock:
            slow_client = daemon._clients.get(slow.slot)
        assert slow_client is not None and slow_client.alive
        assert json.loads(slow.read_line())["t"] >= 0
    finally:
        daemon.stop()
        W.join(ticker, "the ticker")
        for c in (fast, slow):
            if c is not None:
                c.close()


def _tiny_pools(capacity):
    """tip_tpu's and the port's pool of capacity streams on the same
    float64 weights."""
    (jcfg, params), (tcfg, model) = _pair()
    jpool = JS.StreamPool(params, jcfg, jkin.amass_skeleton(
        dtype=jnp.float64), capacity=capacity, dtype=jnp.float64)
    tpool = TS.StreamPool(model, tcfg, tkin.amass_skeleton(
        dtype=torch.float64), capacity=capacity, dtype=torch.float64,
        device="cpu")
    return jpool, tpool


def _both_daemons(capacity, drive):
    """drive(daemon, pool, parse) on tip_tpu's daemon and on the port's,
    each over its pool of capacity streams; returns {name: drive's
    result}."""
    jpool, tpool = _tiny_pools(capacity)
    out = {}
    for name, pool, daemon_cls, parse in (
            ("tip_tpu", jpool, jsd.ServeDaemon, jio.parse_wire_frame),
            ("port", tpool, tsd.ServeDaemon, tio.parse_wire_frame)):
        logs = []
        daemon = daemon_cls(pool, jcal.t_pose_init_state(), port=0,
                            log=logs.append)
        out[name] = drive(daemon, pool, parse, logs)
    return out


def _assert_lines_equal(got, want):
    assert len(got) == len(want) > 0
    assert [g["t"] for g in got] == [w["t"] for w in want]
    q_got = np.array([g["qdq"] for g in got])
    assert q_got.shape == (len(got), 114) and np.isfinite(q_got).all()
    np.testing.assert_allclose(q_got, np.array([w["qdq"] for w in want]),
                               atol=TOL_LINE, rtol=0)


def test_serve_daemon_runs_two_named_threads_at_16_clients():
    """The port's daemon serves 16 clients from two threads of its own, the
    ticker and the I/O thread, where tip_tpu's runs a reader a client."""
    _, (tcfg, model) = _pair()
    pool = TS.StreamPool(model, tcfg, tkin.amass_skeleton(
        dtype=torch.float64), capacity=16, dtype=torch.float64, device="cpu")
    daemon = tsd.ServeDaemon(pool, tcal.t_pose_init_state(), port=0,
                             hz=240.0, log=lambda *a: None)
    before = set(threading.enumerate())
    ticker = threading.Thread(target=daemon.run, kwargs={"seconds": 120.0},
                              daemon=True)
    ticker.start()
    clients = []
    try:
        frames = _motion_frames(0, 1)
        for _ in range(16):
            clients.append(W.LineClient(daemon.port))
            clients[-1].send(frames[0])
        for c in clients:
            assert json.loads(c.read_line())["t"] >= 0
        with daemon._lock:
            assert len(daemon._clients) == 16
        ours = set(threading.enumerate()) - before
        assert sorted(t.name for t in ours) == ["serve-io", "serve-tick"]
    finally:
        daemon.stop()
        W.join(ticker, "the ticker")
        for t in set(threading.enumerate()) - before:
            W.join(t, t.name)
        for c in clients:
            c.close()
    assert ticker.name != "serve-tick"       # run() gave the name back


def test_serve_daemon_reads_between_ticks():
    """The I/O thread leaves a frame that arrives during a tick unread
    until the tick ends (at most a tick's period: 1 s at hz 1), so that it
    does not take the interpreter lock from the tick's ops."""
    _, (tcfg, model) = _pair()
    pool = TS.StreamPool(model, tcfg, tkin.amass_skeleton(
        dtype=torch.float64), capacity=1, dtype=torch.float64, device="cpu")
    daemon = tsd.ServeDaemon(pool, tcal.t_pose_init_state(), port=0, hz=1.0,
                             log=lambda *a: None)
    in_step, release = threading.Event(), threading.Event()
    step = pool.step

    def held_step(batch):
        in_step.set()
        assert release.wait(W.DEADLINE_S)
        return step(batch)
    pool.step = held_step
    frames = _motion_frames(0, 2)
    want = tio.parse_wire_frame(np.array(W.wire_text(frames[1]).split(),
                                         dtype=float))
    accept = W.start_accepting(daemon)
    client = None
    try:
        client = W.LineClient(daemon.port)
        W.wait_until(lambda: client.slot in daemon._clients,
                     "the client's registration")
        slot = daemon._clients[client.slot].input
        ticker = threading.Thread(target=daemon._tick_once,
                                  args=(daemon._batch,), daemon=True)
        ticker.start()
        W.wait_until(in_step.is_set, "the tick to step the pool")
        client.send(frames[1])
        assert not release.wait(0.3)            # 0.3 s into the tick
        assert slot.read() is None              # the frame is not read
        release.set()
        W.join(ticker, "the tick")
        W.wait_until(lambda: np.array_equal(slot.read(), want),
                     "the frame after the tick")
        assert json.loads(client.read_line())["t"] == 0
    finally:
        release.set()
        if client is not None:
            client.close()
        W.stop_accepting(daemon, accept)


def test_serve_daemon_lockstep_8_clients_equal_tip_tpus():
    """Eight clients in lockstep on both daemons: every client's lines are
    tip_tpu's to TOL_LINE."""
    n, ticks = 8, 6
    frames = [_motion_frames(i, ticks) for i in range(n)]

    def drive(daemon, pool, parse, logs):
        accept = W.start_accepting(daemon)
        clients = []
        try:
            clients = [W.LineClient(daemon.port) for _ in range(n)]
            assert [c.slot for c in clients] == list(range(n))
            return [W.lockstep_tick(daemon, parse, [
                (c, frames[i][t]) for i, c in enumerate(clients)])
                for t in range(ticks)]
        finally:
            for c in clients:
                c.close()
            W.stop_accepting(daemon, accept)

    lines = _both_daemons(n, drive)
    for i in range(n):
        _assert_lines_equal([tick[i] for tick in lines["port"]],
                            [tick[i] for tick in lines["tip_tpu"]])


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("garbage", [b"\xff\xfe ", b"0.5 not-a-float "],
                         ids=["non-ascii", "not-a-float"])
def test_serve_daemon_malformed_client_keeps_its_slot(garbage):
    """A client that sends bytes the wire format refuses is no longer read
    (tip_tpu's reader thread dies on them; the port's I/O thread stops
    reading that socket only): it keeps its slot and its last frame and
    still gets a line each tick, while the other clients go on being read;
    both daemons write the same lines."""
    ticks = 5
    frames = [_motion_frames(i, ticks + 1) for i in range(3)]

    def drive(daemon, pool, parse, logs):
        accept = W.start_accepting(daemon)
        clients = []
        try:
            clients = a, bad, c = [W.LineClient(daemon.port)
                                   for _ in range(3)]
            out = [W.lockstep_tick(daemon, parse, [
                (a, frames[0][0]), (bad, frames[1][0]), (c, frames[2][0])])]
            # the frame after the garbage is never read
            bad.sock.sendall(garbage + W.wire_text(frames[1][1]).encode())
            if daemon.__module__ == tsd.__name__:
                W.wait_until(lambda: any("malformed input" in m
                                         for m in logs),
                             "the port's daemon to log the malformed input")
            for t in range(1, ticks):
                line_a, line_c = W.lockstep_tick(
                    daemon, parse, [(a, frames[0][t]), (c, frames[2][t])])
                out.append([line_a, json.loads(bad.read_line()), line_c])
            with daemon._lock:
                kept = daemon._clients.get(bad.slot)
            assert kept is not None and kept.alive and pool.active[bad.slot]
            np.testing.assert_array_equal(kept.input.read(), parse(
                np.array(W.wire_text(frames[1][0]).split(), dtype=float)))
            return out
        finally:
            for cl in clients:
                cl.close()
            W.stop_accepting(daemon, accept)

    lines = _both_daemons(3, drive)
    for i in range(3):
        _assert_lines_equal([tick[i] for tick in lines["port"]],
                            [tick[i] for tick in lines["tip_tpu"]])


def test_serve_daemon_client_dropped_by_the_ticker_then_a_new_one(
        monkeypatch):
    """The ticker drops a client whose sends fail (small send buffers, the
    reader gone) while its socket is still registered with the I/O
    thread's selector (held in add_stream meanwhile). A new client then
    gets the dropped socket's descriptor number; the I/O thread must read
    and serve it all the same."""
    _, (tcfg, model) = _pair()
    pool = TS.StreamPool(model, tcfg, tkin.amass_skeleton(
        dtype=torch.float64), capacity=3, dtype=torch.float64, device="cpu")
    monkeypatch.setattr(tsd, "MAX_OUTBUF", 4096)
    daemon = tsd.ServeDaemon(pool, tcal.t_pose_init_state(), port=0,
                             log=lambda *a: None, sndbuf=4096)
    gate, held = threading.Event(), threading.Event()
    gate.set()
    add_stream = pool.add_stream

    def gated(s_init):
        held.set()
        assert gate.wait(W.DEADLINE_S)
        return add_stream(s_init)
    pool.add_stream = gated
    frames = [_motion_frames(i, 4) for i in range(3)]
    parse = tio.parse_wire_frame
    accept = W.start_accepting(daemon)
    a = b = c = None
    spare, b_sock, placeholders = socket.socket(), None, []
    try:
        a = W.LineClient(daemon.port)
        W.lockstep_tick(daemon, parse, [(a, frames[0][0])])
        with daemon._lock:
            dropped_fd = daemon._clients[a.slot].conn.fileno()
        # the I/O thread takes b's connection and waits in add_stream
        gate.clear()
        held.clear()
        b_sock = socket.create_connection(("127.0.0.1", daemon.port),
                                          timeout=W.DEADLINE_S)
        W.wait_until(held.is_set, "the I/O thread to wait in add_stream")
        # a stops reading until its lines are dropped, then resets
        W.wait_until(lambda: (daemon._tick_once(daemon._batch),
                              daemon._clients[a.slot].dropped > 0)[1],
                     "a's lines to be dropped")
        a.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                          struct.pack("ii", 1, 0))
        a.close()

        def a_dropped():
            daemon._tick_once(daemon._batch)
            with daemon._lock:
                return a.slot not in daemon._clients
        W.wait_until(a_dropped, "the ticker to drop a")
        # every lower descriptor taken, so the next accepted socket gets
        # the dropped one's number
        while (fd := os.open(os.devnull, os.O_RDONLY)) < dropped_fd:
            placeholders.append(fd)
        os.close(fd)
        assert fd == dropped_fd
        gate.set()
        b = W.LineClient(daemon.port, sock=b_sock)
        spare.connect(("127.0.0.1", daemon.port))
        c = W.LineClient(daemon.port, sock=spare)
        # the greeting comes before the registration
        W.wait_until(lambda: c.slot in daemon._clients, "c's registration")
        with daemon._lock:
            assert daemon._clients[c.slot].conn.fileno() == dropped_fd
        assert {b.slot, c.slot} == {1, a.slot}
        for t in range(1, 4):
            line_b, line_c = W.lockstep_tick(
                daemon, parse, [(b, frames[1][t]), (c, frames[2][t])])
            assert line_b["t"] == line_c["t"]
            assert np.isfinite(line_c["qdq"]).all()
    finally:
        gate.set()
        for fd in placeholders:
            os.close(fd)
        for cl in (b, c):
            if cl is not None:
                cl.close()
        spare.close()
        if b_sock is not None:
            b_sock.close()
        W.stop_accepting(daemon, accept)


def _encode_rows(dtype):
    """Random rows (64, 114) with values at the fifth place's ties, at
    +0 and -0 (and -1e-7, which rounds to -0), NaN and +-inf."""
    rng = np.random.default_rng(21)
    rows = rng.normal(scale=3.0, size=(64, 114))
    k = rng.integers(-300000, 300000, size=(64, 114))
    ties = (k + 0.5) * 1e-5
    rows = np.where(rng.random((64, 114)) < 0.3, ties, rows)
    rows[0, :5] = [0.0, -0.0, -1e-7, 1e-7, 0.5e-5]
    rows[1, 3], rows[2, 7], rows[2, 8], rows[3, 0] = (np.nan, np.inf,
                                                      -np.inf, np.nan)
    return rows.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_encode_lines_against_the_per_row_json_encoding(dtype):
    """The daemon's one-pass encode against its per-row json.dumps of
    np.round(row, 5) (tip_tpu's encode): the same json, each value within
    TOL_LINE (float64 rows: equal), the same signs of zero and the same
    non-finite entries."""
    rows = _encode_rows(dtype)
    lines = tsd.encode_lines(41, rows)
    assert len(lines) == len(rows)
    for row, line in zip(rows, lines):
        assert line.endswith(b"\n") and line.count(b"\n") == 1
        got = json.loads(line)
        want = json.loads(json.dumps({"t": 41,
                                      "qdq": np.round(row, 5).tolist()}))
        assert list(got) == ["t", "qdq"] and got["t"] == 41
        g, w = np.array(got["qdq"]), np.array(want["qdq"])
        assert g.shape == w.shape == (114,)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(w)
        np.testing.assert_array_equal(g[~fin & ~np.isnan(w)],
                                      w[~fin & ~np.isnan(w)])
        np.testing.assert_allclose(g[fin], w[fin], atol=TOL_LINE, rtol=0)
        np.testing.assert_array_equal(np.signbit(g[fin]), np.signbit(w[fin]))
        if dtype == np.float64:
            np.testing.assert_array_equal(g[fin], w[fin])
    assert b"NaN" in lines[1] and b"-Infinity" in lines[2]
    assert max(len(ln) for ln in lines[4:]) < 1300


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

class _Reference(torch.nn.Module):
    """The reference's TF_RNN_Past_State parameter layout, built from
    torch's own layers (in_linear, tf_encode, rnn, linear)."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.tf_in_dim
        self.in_linear = torch.nn.Linear(cfg.input_dim, d)
        self.tf_encode = torch.nn.TransformerEncoder(
            torch.nn.TransformerEncoderLayer(d, cfg.n_heads, cfg.tf_hid_size),
            cfg.tf_layers, enable_nested_tensor=False)
        self.rnn = torch.nn.RNN(d, cfg.rnn_hid_size)
        self.linear = torch.nn.Linear(cfg.rnn_hid_size, cfg.size_s)


def _reference_pt(path, n_sbps, with_acc_sum, seed=7):
    torch.manual_seed(seed)
    cfg = TM.ModelConfig(size_s=tcst.state_dim(n_sbps),
                         with_acc_sum=with_acc_sum)
    torch.save(_Reference(cfg).state_dict(), path)
    return str(path)


def test_cli_serve_answers_a_client(tmp_path):
    """cli/serve at its defaults (2 SBPs, recompute, the plain forward,
    tail_impl auto) on the CPU answers a client with its pose lines."""
    pt = _reference_pt(tmp_path / "m.pt", 2, False)
    port = _free_port()
    err = []

    def serve():
        try:
            TSV.main(["--ckpt", pt, "--port", str(port), "--capacity", "2",
                      "--seconds", "3", "--device", "cpu"])
        except Exception as e:  # noqa: BLE001 — reported below
            err.append(e)
    th = threading.Thread(target=serve, daemon=True)
    th.start()
    client = None
    try:
        def up():
            nonlocal client
            try:
                client = W.LineClient(port)
            except ConnectionRefusedError:
                return bool(err)
            return True
        W.wait_until(up, "cli/serve to listen", 60.0, poll=0.05)
        assert not err, err
        assert client.slot == 0
        client.send(_motion_frames(0, 1)[0])
        lines = [json.loads(client.read_line()) for _ in range(3)]
    finally:
        W.join(th, "cli/serve", 30.0)
        if client is not None:
            client.close()
    assert not err, err
    ts = [ln["t"] for ln in lines]
    assert ts == sorted(ts)
    assert all(len(ln["qdq"]) == 114 and np.isfinite(ln["qdq"]).all()
               for ln in lines)


def test_cli_serve_and_live_demo_refuse_what_is_not_ported(tmp_path,
                                                           monkeypatch):
    """Both read orbax directories now (tests/test_torch_orbax.py) and
    refuse one that holds no item, naming what is missing; --viz without
    the pybullet wheel names the package and the flag."""
    orbax = tmp_path / "orbax" / "389400"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(FileNotFoundError, match="no _METADATA under"):
        TSV.main(["--ckpt", str(orbax.parent), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no _METADATA under"):
        TLD.main(["--ckpt", str(orbax), "--device", "cpu"])
    pt = _reference_pt(tmp_path / "m.pt", 5, True)
    monkeypatch.setitem(sys.modules, "pybullet", None)
    with pytest.raises(ImportError, match="pybullet is not installed; the "
                       "viewer .*cli/live_demo --viz"):
        TLD.main(["--ckpt", pt, "--port", "0", "--five_sbp",
                  "--with_acc_sum", "--viz", "--device", "cpu"])


def test_cli_live_demo_streams_records_and_replays(tmp_path):
    """cli/live_demo with --skip_calibration against an in-process 60 Hz
    server: the jsonl poses, the recorded frames and the metrics; the
    recorded frames through run_offline_full give the same poses."""
    pt = _reference_pt(tmp_path / "m.pt", 5, True)
    server = W.ReplayServer(_motion_frames(0, 300), hz=60.0)
    out, rec, met = (tmp_path / n for n in ("poses.jsonl", "rec.f32",
                                            "m.jsonl"))
    try:
        frames, summ = TLD.main([
            "--ckpt", pt, "--port", str(server.port), "--five_sbp",
            "--with_acc_sum", "--skip_calibration", "--seconds", "1.5",
            "--out", str(out), "--record", str(rec), "--metrics", str(met),
            "--device", "cpu"])
    finally:
        server.stop()
    poses = [json.loads(ln) for ln in out.read_text().splitlines()]
    fed = np.fromfile(rec, np.float32).reshape(-1, 72)
    assert frames == len(poses) == len(fed) == summ["count"] > 10
    assert [p["t"] for p in poses] == list(range(frames))
    records = [json.loads(ln) for ln in met.read_text().splitlines()]
    assert records[-1]["kind"] == "final"
    assert records[-1]["frames"] == frames
    assert all(r["kind"] == "latency" for r in records[:-1])

    cfg = TFR.FullRunnerConfig(base=TR.RunnerConfig(
        model=TM.ModelConfig(with_acc_sum=True)))
    from tip_tpu_torch.cli.evaluate import load_model
    model = load_model(pt, cfg.base.model, 5, "cpu")
    s_traj = TFR.run_offline_full(
        model, cfg, tkin.amass_skeleton(), tcal.t_pose_init_state(),
        np.concatenate([fed, fed[-1:]]), device="cpu")[0]
    np.testing.assert_array_equal(np.array([p["qdq"] for p in poses]),
                                  s_traj[1:].numpy())


def test_cli_live_demo_calibrated(tmp_path, monkeypatch):
    """The two-stage calibration on a simulated sensor stack, answered
    through a monkeypatched input(): the recorded frames are the bone
    frames and free accelerations the stack was given.

    Each stage change waits until the demo's own client reads a frame of
    the new stage (the client keeps the latest frame, and the server's
    count of frames sent says nothing of what the client has parsed), and
    the streaming loop runs a budget of frames, not of seconds, so that a
    loaded host neither mixes two stages into one calibration mean nor
    records too few frames."""
    pt = _reference_pt(tmp_path / "m.pt", 2, False)
    reading, r_b0_s0 = simulate_sensor_stack(np.random.default_rng(5))
    r_true = Rotation.from_rotvec(
        np.random.default_rng(6).normal(size=(6, 3)) * 0.8).as_matrix()
    acc_free = np.random.default_rng(7).normal(size=(6, 3))
    # the stream's stages: aligned with the room, T pose, streaming
    frames = [W.wire_frames(r[None])[0] for r in (
        reading(np.transpose(r_b0_s0, (0, 2, 1)), np.zeros((6, 3))),
        reading(tcal.aligned_t_pose_bone_rotations(), np.zeros((6, 3))),
        reading(r_true, acc_free))]
    # each stage's frame as the client parses it off the wire
    parsed = [tio.parse_wire_frame(np.array(W.wire_text(f).split(),
                                            dtype=float)) for f in frames]
    stage = [0]
    server = W.ReplayServer(hz=240.0, source=lambda i: frames[stage[0]])
    clients = []

    class Client(tio.IMUClient):
        def start(self):
            clients.append(self)
            super().start()
    monkeypatch.setattr(tio, "IMUClient", Client)

    def move_to(k):
        """Switch the stream to stage k and wait until the demo's client
        reads it: from then on every frame it reads is of stage k."""
        stage[0] = k
        W.wait_until(lambda: np.array_equal(clients[0].current_reading(),
                                            parsed[k]),
                     f"the client to read stage {k}")

    prompts = []

    def answer(p=""):
        prompts.append(p)
        if "T-pose" in p:
            move_to(1)
        return ""
    monkeypatch.setattr(builtins, "input", answer)
    # each stage held 0.3 s, not the protocol's 3 s
    monkeypatch.setattr(TLD, "calibrate_client", functools.partial(
        TLD.calibrate_client, seconds=0.3))
    orig = TLD.run_loop
    n_frames = 12

    def run_loop(*a, **kw):
        move_to(2)
        return orig(*a, **dict(kw, seconds=0.0, max_frames=n_frames))
    monkeypatch.setattr(TLD, "run_loop", run_loop)
    rec = tmp_path / "rec.f32"
    try:
        TLD.main(["--ckpt", pt, "--port", str(server.port),
                  "--record", str(rec), "--device", "cpu"])
    finally:
        server.stop()
    assert len(clients) == 1
    assert len(prompts) == 2 and "T-pose" in prompts[1]
    fed = np.fromfile(rec, np.float32).reshape(-1, 72)
    assert len(fed) == n_frames
    # the wire carries float32 quaternions and accs (a relative 6e-8), so
    # the calibrated frames hold the truth to float32's precision: the
    # rotations to 1e-5, the accs (norm ~10 with gravity) to 1e-4
    np.testing.assert_allclose(fed[:, :54].reshape(-1, 6, 3, 3),
                               np.broadcast_to(r_true, (len(fed), 6, 3, 3)),
                               atol=1e-5)
    np.testing.assert_allclose(fed[:, 54:].reshape(-1, 6, 3),
                               np.broadcast_to(acc_free, (len(fed), 6, 3)),
                               atol=1e-4)
