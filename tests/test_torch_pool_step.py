"""The pool's batched frame step (tip_tpu_torch.runtime.runner.pool_step /
make_multi_stream_step) against tip_tpu's ``make_multi_stream_step`` (its
``vmap`` of ``runner_step``), on the CPU in float64 at a small size.

Twin of tests/test_streaming_cache.py::test_kv_cache_pool_mid_stream_join,
in all three serving modes: two streams read from the in-tree motions tick
together under a global tick, one of them rejoins mid-session with a fresh
slot of the carry, and every output of every tick agrees with tip_tpu's; the
port's pool can also go on from tip_tpu's stacked mid-session carry
(``pool_carry_from_jax``). The rejoined stream equals its solo run.
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import runner as JR
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import runner as TR

torch.set_num_threads(1)

CORPUS = (Path(__file__).resolve().parents[1] / "artifacts" / "corpus_run_v3"
          / "corpus_extra")
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
MODES = ("recompute", "kv_cache", "kv_cache_rnn_carry")
B, T, JOIN = 2, 60, 7           # the join comes after the warm-up; the
#                                 cursor wraps and the window slides
HANDOVER = 23                   # tick at which the port takes over the state
OUTS = ("qdq", "viz_locs", "ct")


@pytest.fixture(scope="module")
def streams():
    imus, s_inits = [], []
    for i in range(B):
        with open(CORPUS / f"freeform2_{i:04d}.pkl", "rb") as f:
            d = pickle.load(f)     # in-tree motions written by data gen
        imus.append(np.asarray(d["imu"][:T + JOIN], np.float64))
        s_inits.append(np.asarray(d["nimble_qdq"][0], np.float64))
    return np.stack(imus), np.stack(s_inits)


def _jax_side(mode):
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**TINY), serving_mode=mode)
    params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float64),
        JM.init_params(jax.random.PRNGKey(0), jcfg.model))
    return jcfg, params, jkin.amass_skeleton(dtype=jnp.float64)


def _port_side(mode, params):
    tcfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY), serving_mode=mode)
    model = TM.TIPModel(tcfg.model, device="cpu", dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return tcfg, model, tkin.amass_skeleton(dtype=torch.float64)


def _jax_carry_leaves(jc):
    """tip_tpu's stacked RunnerCarry as numpy leaves by name."""
    d = {n: (None if getattr(jc, n) is None else np.asarray(getattr(jc, n)))
         for n in ("t", "k", "n_out") + TR._TENSOR_LEAVES}
    d["cache"] = None if jc.cache is None else {
        n: np.asarray(getattr(jc.cache, n)) for n in ("k", "v", "enc", "h",
                                                      "valid")}
    return d


@pytest.fixture(scope="module")
def runs(streams):
    """Per mode: tip_tpu's outputs tick by tick; the port's from tick 0; the
    port's from tip_tpu's carry at HANDOVER; the rejoined stream solo."""
    imu, s_inits = streams
    out = {}
    for mode in MODES:
        jcfg, params, jskel = _jax_side(mode)
        tcfg, model, tskel = _port_side(mode, params)
        jstep = JR.make_multi_stream_step(jcfg, jskel)
        tstep = TR.make_multi_stream_step(tcfg, tskel)
        jc = jax.vmap(lambda s: JR.runner_init(jcfg, jskel, s,
                                               dtype=jnp.float64))(
            jnp.asarray(s_inits))
        tc = TR.pool_init(tcfg, tskel, s_inits, dtype=torch.float64,
                          device="cpu")
        handed = None
        jo, to, ho = [], [], []
        K.reset_launch_counts()
        for t in range(T + JOIN):
            if t == JOIN:       # stream 1 rejoins: a fresh slot of the carry
                fresh = JR.runner_init(jcfg, jskel, jnp.asarray(s_inits[1]),
                                       dtype=jnp.float64)
                jc = jax.tree_util.tree_map(lambda p, x: p.at[1].set(x), jc,
                                            fresh)
                TR.pool_write_slot(tc, 1, TR.runner_init(
                    tcfg, tskel, s_inits[1], dtype=torch.float64,
                    device="cpu"))
            if t == HANDOVER:
                handed = TR.pool_carry_from_jax(_jax_carry_leaves(jc))
            # stream 1 restarts its motion at the join
            x = np.stack([imu[0, t], imu[1, t - JOIN if t >= JOIN else t]])
            jc, o = jstep(params, jc, jnp.asarray(x),
                          jnp.asarray(t, jnp.int32))
            jo.append({n: np.asarray(o[n]) for n in OUTS})
            tc, o = tstep(model, tc, torch.as_tensor(x), t)
            to.append({n: o[n].numpy() for n in OUTS})
            if handed is not None:
                handed, o = tstep(model, handed, torch.as_tensor(x), t)
                ho.append({n: o[n].numpy() for n in OUTS})
        assert sum(K.launch_counts.values()) == 0
        solo = TR.run_offline(model, tcfg, tskel, s_inits[1], imu[1, :T],
                              device="cpu")[0].numpy()
        out[mode] = (jo, to, ho, solo, tc)
    return out


@pytest.mark.parametrize("name", OUTS)
@pytest.mark.parametrize("mode", MODES)
def test_pool_step_matches_tip_tpu_with_a_mid_session_join(runs, mode, name):
    jo, to = runs[mode][:2]
    j = np.stack([o[name] for o in jo])
    t = np.stack([o[name] for o in to])
    assert t.shape == j.shape and np.isfinite(t).all()
    # the same f64 arithmetic in another order
    np.testing.assert_allclose(t, j, atol=1e-9, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_pool_step_goes_on_from_tip_tpus_stacked_carry(runs, mode):
    """From tick HANDOVER on the port runs from tip_tpu's mid-session state:
    counters, windows, rings and all."""
    jo, _, ho = runs[mode][:3]
    for name in OUTS:
        j = np.stack([o[name] for o in jo[HANDOVER:]])
        h = np.stack([o[name] for o in ho])
        np.testing.assert_allclose(h, j, atol=1e-9, rtol=0, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_rejoined_stream_equals_its_solo_run(runs, mode):
    """The stream that joined at tick 7 of a running pool (its ring cursor
    nowhere near 0 in the cached modes) gives its single-stream
    trajectory."""
    _, to, _, solo, carries = runs[mode]
    qdq = np.stack([o["qdq"][1] for o in to])
    np.testing.assert_allclose(qdq[JOIN:-1], solo[1:T], atol=1e-9, rtol=0)
    assert carries.t.tolist() == [T + JOIN, T]
    assert carries.k.tolist() == [T + JOIN - 5, T - 5]


def test_pool_step_argument_checks(streams):
    imu, s_inits = streams
    cfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY),
                          serving_mode="kv_cache")
    model = TM.TIPModel(cfg.model, device="cpu")
    skel = tkin.amass_skeleton()
    carries = TR.pool_init(cfg, skel, s_inits, device="cpu")
    assert carries.n_streams == B and carries.cache.k.shape == (B, 2, 40, 32)
    x = torch.as_tensor(imu[:, 0], dtype=torch.float32)
    with pytest.raises(ValueError, match="tick"):
        TR.pool_step(model, carries, x, cfg, skel)
    with pytest.raises(ValueError, match="imu_batch"):
        TR.pool_step(model, carries, x[:1], cfg, skel, tick=0)
    with pytest.raises(ValueError, match="s_inits"):
        TR.pool_init(cfg, skel, s_inits[0], device="cpu")
    # the fused forward's weights are packed once and handed in
    fcfg = TR.RunnerConfig(
        model=TM.ModelConfig(**TINY, forward_impl="fused"),
        serving_mode="kv_cache")
    with pytest.raises(ValueError, match="packed_ws"):
        TR.make_multi_stream_step(fcfg, skel)
    with pytest.raises(ValueError, match="packed_ws"):
        TR.pool_step(model, carries, x, fcfg, skel, tick=0)
    fstep = TR.make_multi_stream_step(
        fcfg, skel, TR.pack_fused_weights(model, fcfg))
    fused = fstep(model, carries.streams(0, B), x, 0)[1]
    plain = TR.make_multi_stream_step(cfg, skel)(
        model, TR.pool_init(cfg, skel, s_inits, device="cpu"), x, 0)[1]
    assert all(torch.equal(fused[n], plain[n]) for n in OUTS)   # warm-up tick
    # a pool's fresh carry is its streams' fresh carries, stacked
    singles = [TR.runner_init(cfg, skel, s, device="cpu") for s in s_inits]
    for n in TR._TENSOR_LEAVES:
        b = getattr(carries, n)
        assert (b is None and getattr(singles[0], n) is None) or torch.equal(
            torch.stack([getattr(c, n) for c in singles]), b.float())
    part = carries.streams(1, 2)
    assert part.n_streams == 1 and part.cache.valid.shape == (1, 40)
