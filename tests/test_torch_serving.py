"""The port's StreamPool (tip_tpu_torch.runtime.serving) on the CPU at a
small size; mirrors tests/test_serving.py.

Each pooled stream equals the port's own single-stream ``run_offline`` and
tip_tpu's ``StreamPool`` tick by tick (float64), in recompute and KV-cache
modes, a remove/re-add and a failed tick included; chunked equals unchunked;
concurrent add_stream calls claim unique slots; the fused pool (K8's and
K9's plain versions here, tip_tpu's Pallas kernels in interpret mode) equals
the plain pool and tip_tpu's fused pool.
"""

import dataclasses
import pickle
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import runner as JR
from tip_tpu.runtime import serving as JS
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import runner as TR
from tip_tpu_torch.runtime.serving import StreamPool

torch.set_num_threads(1)

CORPUS = (Path(__file__).resolve().parents[1] / "artifacts" / "corpus_run_v3"
          / "corpus_extra")
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
MODES = ("recompute", "kv_cache", "kv_cache_rnn_carry")


@pytest.fixture(scope="module")
def motions():
    """(imu (4, 80, 72), s_init (4, 114)) from four in-tree motions."""
    imus, s_inits = [], []
    for i in range(4):
        with open(CORPUS / f"freeform2_{i:04d}.pkl", "rb") as f:
            d = pickle.load(f)     # in-tree motions written by data gen
        imus.append(np.asarray(d["imu"][:80], np.float64))
        s_inits.append(np.asarray(d["nimble_qdq"][0], np.float64))
    return np.stack(imus), np.stack(s_inits)


def _pair(mode, dtype64=True, seed=0, **model_kw):
    """The same weights as a tip_tpu param tree and a port model."""
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**TINY, **model_kw),
                           serving_mode=mode)
    tcfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY, **model_kw),
                           serving_mode=mode)
    jdt, tdt = (jnp.float64, torch.float64) if dtype64 else \
        (jnp.float32, torch.float32)
    params = jax.tree_util.tree_map(
        lambda p: p.astype(jdt),
        JM.init_params(jax.random.PRNGKey(seed), jcfg.model))
    model = TM.TIPModel(tcfg.model, device="cpu", dtype=tdt)
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return (jcfg, params, jkin.amass_skeleton(dtype=jdt), jdt), \
        (tcfg, model, tkin.amass_skeleton(dtype=tdt), tdt)


def _port_pool(port, capacity, **kw):
    tcfg, model, skel, tdt = port
    return StreamPool(model, tcfg, skel, capacity=capacity, dtype=tdt,
                      device="cpu", **kw)


@pytest.mark.parametrize("mode", MODES)
def test_stream_pool_add_remove_and_isolation(motions, mode):
    """Two streams of a pool of four, the second joining at tick 9: each
    equals its own single-stream run and tip_tpu's pool tick by tick; a
    removed slot is handed out again and restarts from s_init; a full pool
    raises RuntimeError."""
    imu, s_inits = motions
    (jcfg, params, jskel, jdt), port = _pair(mode)
    tcfg, model, tskel, _ = port
    jpool = JS.StreamPool(params, jcfg, jskel, capacity=4, dtype=jdt)
    tpool = _port_pool(port, 4)
    T, JOIN = 60, 9
    a = tpool.add_stream(s_inits[0])
    assert a == jpool.add_stream(s_inits[0]) == 0
    K.reset_launch_counts()
    got = {0: [], 1: []}
    for t in range(T):
        if t == JOIN:
            b = tpool.add_stream(s_inits[1])
            assert b == jpool.add_stream(s_inits[1]) == 1
            assert tpool.n_active == 2
        batch = np.zeros((4, 72))
        batch[0] = imu[0, t]
        if t >= JOIN:
            batch[1] = imu[1, t - JOIN]
        jo = jpool.step(batch)
        to = tpool.step(batch)
        for name in ("qdq", "viz_locs", "ct"):
            # f64 on both sides, sums in another order
            np.testing.assert_allclose(to[name].numpy()[:2],
                                       np.asarray(jo[name])[:2], atol=1e-8,
                                       rtol=0, err_msg=f"{name} tick {t}")
        got[0].append(to["qdq"][0].numpy())
        if t >= JOIN:
            got[1].append(to["qdq"][1].numpy())
    assert sum(K.launch_counts.values()) == 0
    # slot isolation: each stream matches its own single-stream run
    for slot, n in ((0, T), (1, T - JOIN)):
        solo = TR.run_offline(model, tcfg, tskel, s_inits[slot],
                              imu[slot, :n + 1], device="cpu")[0].numpy()
        np.testing.assert_allclose(np.stack(got[slot]), solo[1:n + 1],
                                   atol=1e-7, rtol=0)

    # remove + re-add resets the slot
    tpool.remove_stream(a)
    assert tpool.n_active == 1
    c = tpool.add_stream(s_inits[2])
    assert c == a
    out = tpool.step(np.zeros((4, 72)))
    np.testing.assert_allclose(out["qdq"][c].numpy(), s_inits[2], atol=1e-9)
    tpool.add_stream(s_inits[3])
    tpool.add_stream(s_inits[3])
    with pytest.raises(RuntimeError, match="full"):
        tpool.add_stream(s_inits[3])


@pytest.mark.parametrize("mode", ["recompute", "kv_cache"])
def test_stream_pool_chunked_matches_unchunked(motions, mode):
    """chunk= processes the pool in sub-batches; the results are those of
    the whole-pool tick."""
    imu, s_inits = motions
    _, port = _pair(mode)
    pool_a = _port_pool(port, 4)
    pool_b = _port_pool(port, 4, chunk=2)
    for p in (pool_a, pool_b):
        for s in s_inits:
            p.add_stream(s)
    for t in range(50):
        oa = pool_a.step(imu[:, t])
        ob = pool_b.step(imu[:, t])
        for name in oa:
            np.testing.assert_allclose(ob[name].numpy(), oa[name].numpy(),
                                       atol=1e-12, rtol=0)
    with pytest.raises(ValueError, match="divide"):
        _port_pool(port, 4, chunk=3)


@pytest.mark.parametrize("mode", ["recompute", "kv_cache"])
def test_stream_pool_failed_tick_recovery(motions, mode):
    """A tick that raises may leave the in-place rings half written: the
    pool is rebuilt (sessions restart from their stored init poses) before
    the error goes on, and stays usable."""
    imu, s_inits = motions
    _, port = _pair(mode)
    pool = _port_pool(port, 2)
    pool.add_stream(s_inits[0])
    for t in range(8):
        pool.step(np.stack([imu[0, t]] * 2))
    orig = pool._step

    def boom(*a, **k):
        raise RuntimeError("injected tick failure")

    pool._step = boom
    with pytest.raises(RuntimeError, match="injected"):
        pool.step(np.stack([imu[0, 8]] * 2))
    pool._step = orig
    assert pool._carries.t.tolist() == [0, 0]
    # the pool is usable and slot 0 restarted its session from s_init
    out = pool.step(np.stack([imu[0, 9]] * 2))
    np.testing.assert_allclose(out["qdq"][0].numpy(), s_inits[0], atol=1e-9)
    assert pool.n_active == 1
    # and runs on to real frames
    for t in range(10, 20):
        out = pool.step(np.stack([imu[0, t]] * 2))
    assert torch.isfinite(out["qdq"]).all()
    assert np.abs(out["qdq"][0].numpy() - s_inits[0]).max() > 1e-6


def test_stream_pool_concurrent_add_claims_unique_slots(motions):
    """The free-slot scan and claim are inside the carry lock: concurrent
    add_stream calls are never handed the same slot."""
    _, s_inits = motions
    _, port = _pair("kv_cache")
    N = 8
    pool = _port_pool(port, N)
    slots, errors = [], []
    barrier = threading.Barrier(N)

    def add():
        try:
            barrier.wait()
            slots.append(pool.add_stream(s_inits[0]))
        except Exception as e:     # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=add) for _ in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert sorted(slots) == list(range(N))


@pytest.mark.parametrize("mode", MODES)
def test_stream_pool_fused_matches_plain_and_tip_tpu(motions, mode):
    """forward_impl="fused" in float32: the pool tick goes through the
    batched kernel's wrapper (its plain version on the CPU) and matches the
    plain pool; against tip_tpu's fused pool (its Pallas kernels in
    interpret mode) over the first 40 model frames, where tip_tpu's fused
    recompute is still right (it reads a row past the window once the
    window slides)."""
    imu, s_inits = motions
    fused = dict(forward_impl="fused", compute_dtype="float32")
    (jcfg, params, jskel, jdt), port = _pair(mode, dtype64=False, **fused)
    plain_cfg = dataclasses.replace(
        port[0], model=TM.ModelConfig(**TINY, compute_dtype="float32"))
    plain_model = TM.TIPModel(plain_cfg.model, device="cpu")
    plain_model.load_state_dict(port[1].state_dict())
    pools = {"jax": JS.StreamPool(params, jcfg, jskel, capacity=2, dtype=jdt),
             "fused": _port_pool(port, 2),
             "plain": _port_pool((plain_cfg, plain_model, port[2], port[3]),
                                 2)}
    for p in pools.values():
        p.add_stream(s_inits[0])
    T, JOIN = 45, 3             # 40 model frames of the first stream
    outs = {n: [] for n in pools}
    for t in range(T):
        if t == JOIN:
            for p in pools.values():
                p.add_stream(s_inits[1])
        batch = np.stack([imu[0, t], imu[1, max(t - JOIN, 0)]])
        for n, p in pools.items():
            outs[n].append(np.asarray(p.step(batch.astype(np.float32))["qdq"]))
    outs = {n: np.stack(v) for n, v in outs.items()}
    assert np.isfinite(outs["fused"]).all()
    # f32, the same casts, sums in another order, fed back through the
    # autoregressive window of a random model: tip_tpu's tolerance for its
    # fused pool against its XLA pool
    np.testing.assert_allclose(outs["fused"], outs["plain"], atol=5e-3,
                               rtol=0)
    np.testing.assert_allclose(outs["fused"], outs["jax"], atol=5e-3, rtol=0)


def test_stream_pool_arguments(motions):
    _, s_inits = motions
    _, port = _pair("recompute")
    tcfg, model, skel, tdt = port
    # mesh=None is one process's pool (the meshed pool: test_torch_mesh.py)
    assert StreamPool(model, tcfg, skel, capacity=2, dtype=tdt, device="cpu",
                      mesh=None)._carries.n_streams == 2
    other = TR.RunnerConfig(model=TM.ModelConfig())
    with pytest.raises(ValueError, match="ModelConfig"):
        StreamPool(model, other, skel, capacity=2, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        StreamPool(model, tcfg, skel, capacity=2, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamPool(model, tcfg, skel, capacity=2)
    pool = StreamPool(model, tcfg, capacity=3, dtype=tdt, device="cpu")
    assert pool.capacity == 3 and pool.n_active == 0 and pool._packed is None
    assert pool.skel.joint_offset.dtype == tdt
