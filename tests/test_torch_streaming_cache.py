"""The port's KV-cache serving (tip_tpu_torch.runtime.streaming_cache and the
cached modes of tip_tpu_torch.runtime.runner) against tip_tpu's, on the CPU
at a small size.

The same tokens, weights and IMU stream, made from a seed with numpy or read
from the in-tree motion, go through both packages. tip_tpu's fused cached
step (a Pallas kernel) runs in interpret mode, as its own tests run it; the
port's wrappers run K7's plain version for CPU tensors. The port updates
its cache in place, so a comparison before/after clones first.
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.ops import fused_forward as JFF
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import runner as JR
from tip_tpu.runtime import streaming_cache as JSC
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import runner as TR
from tip_tpu_torch.runtime import streaming_cache as TSC

torch.set_num_threads(1)

MOTION = (Path(__file__).resolve().parents[1] / "artifacts" / "corpus_run_v3"
          / "corpus_extra" / "freeform2_0000.pkl")
# the d 32 / 2-layer model of tip_tpu's runner tests
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
W = 8                       # ring slots of the op tests
N_FRAMES = 80               # runner tests: past the slide
SLIDE_T = 5 + 40 + 1        # first trajectory row after the window slid
LEAVES = ("k", "v", "enc", "h", "valid")
MODES = ("kv_cache", "kv_cache_rnn_carry")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, None: jnp.float64}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       None: torch.float64}


def _jax_params(cfg, seed, dtype):
    return jax.tree_util.tree_map(
        lambda p: p.astype(dtype),
        JM.init_params(jax.random.PRNGKey(seed), cfg))


def _state_dict(params):
    return TM.params_from_jax(jax.tree_util.tree_map(
        lambda p: np.asarray(p.astype(jnp.float32)
                             if p.dtype == jnp.bfloat16 else p), params))


def _leaf(a):
    """A tip_tpu cache leaf as numpy (bf16 widened to f32)."""
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    return np.asarray(a)


def _cache_to_port(jcache, dtype):
    c = TSC.cache_from_jax(*(_leaf(getattr(jcache, n)) for n in LEAVES))
    for n in LEAVES[:4]:
        setattr(c, n, getattr(c, n).to(dtype))
    return c


def _assert_caches(tc, jc, atol, msg):
    for n in LEAVES[:4]:
        np.testing.assert_allclose(getattr(tc, n).double().numpy(),
                                   _leaf(getattr(jc, n)).astype(np.float64),
                                   atol=atol, rtol=0, err_msg=f"{n} {msg}")
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid),
                                  err_msg=f"valid {msg}")


def _cache_equal(a, b):
    return all(torch.equal(getattr(a, n), getattr(b, n)) for n in LEAVES)


# ---------------------------------------------------------------------------
# (a) the plain cached step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rnn_carry", [False, True])
@pytest.mark.parametrize("cursor", ["own", "global"])
def test_cached_forward_step_matches_tip_tpu(rnn_carry, cursor):
    """float64, 2 W committed steps (the cursor wraps) with an uncommitted
    one in the middle; the port starts from tip_tpu's mid-stream cache
    (``cache_from_jax``). With the global cursor the ring is entered at
    slot 3 and validity comes from the cache's own ring."""
    jcfg, tcfg = JM.ModelConfig(**TINY), TM.ModelConfig(**TINY)
    params = _jax_params(jcfg, 0, jnp.float64)
    sd = _state_dict(params)
    model = TM.TIPModel(tcfg, device="cpu", dtype=torch.float64)
    model.load_state_dict(sd)
    rng = np.random.default_rng(0)
    jc = JSC.cache_init(jcfg, W, jnp.float64)
    tc = None
    k = 0
    for step in range(2 * W + 1):
        x = rng.normal(size=jcfg.input_dim)
        x[rng.random(x.shape) < 0.05] = np.nan
        commit = step != W + 2
        over = k + 3 if cursor == "global" else None
        if step == 3:           # the port joins here, from tip_tpu's state
            tc = _cache_to_port(jc, torch.float64)
        jc, jy = JSC.cached_forward_step(
            params, jc, jnp.asarray(x), jnp.asarray(k, jnp.int32), jcfg,
            rnn_carry=rnn_carry,
            slot_override=None if over is None else jnp.asarray(over,
                                                                jnp.int32),
            commit=jnp.asarray(commit))
        if tc is None:
            k += 1
            continue
        before = tc.clone()
        # a state dict and the module are both accepted
        out, ty = TSC.cached_forward_step(
            sd if step % 2 else model, tc, torch.as_tensor(x), k, tcfg,
            rnn_carry=rnn_carry, slot_override=over, commit=commit)
        assert out is tc                        # updated in place
        _assert_caches(tc, jc, 1e-9, f"step {step}")
        if commit:
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-9,
                                       rtol=0, err_msg=f"step {step}")
            k += 1
        else:
            assert _cache_equal(tc, before)
    if not rnn_carry:
        assert not tc.h.any()                   # replay leaves h alone


def test_cached_forward_step_compute_dtype_casts_the_parameters():
    """compute_dtype="bfloat16": float32 parameters and token are cast, the
    rings are bf16 and so is y, as in tip_tpu (2e-2: bf16 rounds at other
    places in the two frameworks)."""
    kw = dict(TINY, compute_dtype="bfloat16")
    jcfg, tcfg = JM.ModelConfig(**kw), TM.ModelConfig(**kw)
    params = _jax_params(jcfg, 1, jnp.float32)
    model = TM.TIPModel(tcfg, device="cpu")
    model.load_state_dict(_state_dict(params))
    rng = np.random.default_rng(1)
    jc = JSC.cache_init(jcfg, W)
    tc = TSC.cache_init(tcfg, W, device="cpu")
    assert tc.k.dtype == tc.h.dtype == torch.bfloat16
    for k in range(W + 2):
        x = rng.normal(size=jcfg.input_dim).astype(np.float32)
        jc, jy = JSC.cached_forward_step(params, jc, jnp.asarray(x),
                                         jnp.asarray(k, jnp.int32), jcfg)
        tc, ty = TSC.cached_forward_step(model, tc, torch.as_tensor(x), k,
                                         tcfg)
        assert ty.dtype == torch.bfloat16
        np.testing.assert_allclose(ty.float().numpy(), _leaf(jy), atol=2e-2,
                                   rtol=0, err_msg=f"k={k}")


# ---------------------------------------------------------------------------
# (b) K7's plain version against tip_tpu's fused kernel in interpret mode
# ---------------------------------------------------------------------------

# f32 packing: tip_tpu's own tolerance for its fused step against its
# unfused one. bf16 packing: a sum that lands on the other side of a
# rounding boundary moves an activation by one bf16 step (2^-8 relative)
# before it is multiplied on and stored in the rings
ATOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.mark.parametrize("rnn_carry", [False, True])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_cached_step_plain_matches_pallas(rnn_carry, dt):
    """2 W + 3 steps at an explicit cursor that starts at slot 5, with an
    uncommitted step in the middle that leaves the rings and h exactly as
    they were."""
    kw = dict(TINY, compute_dtype=dt)
    jcfg, tcfg = JM.ModelConfig(**kw), TM.ModelConfig(**kw)
    params = _jax_params(jcfg, 0, jnp.float32)
    jws = tuple(JFF.pack_weights(params, jcfg, dtype=JDT[dt]))
    model = TM.TIPModel(tcfg, device="cpu")
    model.load_state_dict(_state_dict(params))
    tws = model.packed_weights(TDT[dt])
    rng = np.random.default_rng(2)
    jc = JSC.cache_init(jcfg, W)
    tc = TSC.cache_init(tcfg, W, device="cpu")
    assert tc.k.dtype == TDT[dt]
    for step in range(2 * W + 3):
        x = rng.normal(size=jcfg.input_dim).astype(np.float32)
        x[rng.random(x.shape) < 0.05] = np.nan
        x[90 + 108:90 + 111] = 5.0
        commit = step != W + 1
        slot = (step + 5) % W
        jc, jy = JSC.fused_cached_forward_step(
            jws, jc, jnp.asarray(x), jnp.asarray(step + 5, jnp.int32),
            jnp.asarray(commit), jcfg, rnn_carry=rnn_carry, interpret=True)
        before = tc.clone()
        out, ty = TSC.fused_cached_step_slot(
            tws, tc, torch.as_tensor(x), slot, commit, tcfg,
            rnn_carry=rnn_carry)
        assert out is tc and ty.dtype == torch.float32
        _assert_caches(tc, jc, ATOL[dt], f"step {step}")
        if commit:
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                       atol=ATOL[dt], rtol=0,
                                       err_msg=f"step {step}")
        else:
            assert _cache_equal(tc, before)
    assert torch.equal(tc.valid, torch.ones(W, dtype=torch.bool))


def test_fused_cached_forward_step_cursor_is_k_prev():
    """The form without a global cursor writes slot k_prev % W, and its
    "auto" on a CPU token is the plain version."""
    tcfg = TM.ModelConfig(**TINY, compute_dtype="float32")
    model = TM.TIPModel(tcfg, device="cpu")
    ws = model.packed_weights(torch.float32)
    x = torch.as_tensor(np.random.default_rng(3).normal(size=221)
                        .astype(np.float32))
    a = TSC.cache_init(tcfg, W, device="cpu")
    b = TSC.cache_init(tcfg, W, device="cpu")
    K.reset_launch_counts()
    _, ya = TSC.fused_cached_forward_step(ws, a, x, W + 2, True, tcfg)
    _, yb = TSC.fused_cached_forward_step_plain(ws, b, x, 2, True, tcfg)
    assert torch.equal(ya, yb) and _cache_equal(a, b)
    assert a.valid.tolist() == [i == 2 for i in range(W)]
    assert sum(K.launch_counts.values()) == 0


# ---------------------------------------------------------------------------
# (c) the runner in the cached modes against tip_tpu's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream():
    with open(MOTION, "rb") as f:      # in-tree motion written by data gen
        d = pickle.load(f)
    return (np.asarray(d["imu"][:N_FRAMES], np.float64),
            np.asarray(d["nimble_qdq"][0], np.float64))


def _port_model(mcfg, dtype=torch.float64, seed=4):
    """A seeded model with W_hh doubled: at the initial scale the tanh RNN
    forgets its state within 40 steps to 1e-15, and the carried hidden
    would be indistinguishable from the replay."""
    model = TM.TIPModel(mcfg, device="cpu", dtype=dtype,
                        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.rnn.w_hh.mul_(2.0)
    return model


def _port_run(stream, mode, n_frames=N_FRAMES, sd=None, dtype=torch.float64,
              **model_kw):
    imu, s_init = stream
    cfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY, **model_kw),
                          serving_mode=mode)
    model = _port_model(cfg.model, dtype)
    if sd is not None:
        model.load_state_dict(sd)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    K.reset_launch_counts()
    out = TR.run_offline(model, cfg, tkin.amass_skeleton(dtype=dtype),
                         s_init.astype(np_dt), imu[:n_frames].astype(np_dt),
                         device="cpu")
    assert sum(K.launch_counts.values()) == 0
    return [a.numpy() for a in out]


@pytest.fixture(scope="module")
def port_runs(stream):
    """float64, plain, 80 frames, the three serving modes on one model."""
    return {m: _port_run(stream, m) for m in ("recompute",) + MODES}


@pytest.mark.parametrize("mode", MODES)
def test_run_offline_cached_matches_tip_tpu(stream, mode):
    """float64 over 80 frames, past the slide: s_traj, c_traj and viz."""
    imu, s_init = stream
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**TINY), serving_mode=mode)
    params = _jax_params(jcfg.model, 0, jnp.float64)
    j_out = JR.run_offline(params, jcfg,
                           jkin.amass_skeleton(dtype=jnp.float64),
                           jnp.asarray(s_init), jnp.asarray(imu))
    t_out = _port_run(stream, mode, sd=_state_dict(params))
    for name, j, t in zip(("s_traj", "c_traj", "viz"), j_out, t_out):
        assert t.shape == j.shape, name
        # the same f64 arithmetic in another order
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-8, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_run_offline_fused_cached_matches_tip_tpu(stream, mode):
    """forward_impl="fused" in float32 (K7's plain version here, tip_tpu's
    kernel in interpret mode) over 14 frames, at tip_tpu's own tolerance
    for its fused cached runner."""
    imu, s_init = (a.astype(np.float32) for a in stream)
    kw = dict(forward_impl="fused", compute_dtype="float32")
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**TINY, **kw),
                           serving_mode=mode)
    params = _jax_params(jcfg.model, 0, jnp.float32)
    j_out = JR.run_offline(params, jcfg, jkin.amass_skeleton(),
                           jnp.asarray(s_init), jnp.asarray(imu[:14]))
    t_out = _port_run(stream, mode, 14, sd=_state_dict(params),
                      dtype=torch.float32, **kw)
    for j, t in zip(j_out, t_out):
        assert t.shape == j.shape and np.isfinite(t).all()
        np.testing.assert_allclose(t, np.asarray(j), atol=2e-3, rtol=0)


# ---------------------------------------------------------------------------
# (d) inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_cached_modes_equal_recompute_until_the_window_slides(port_runs,
                                                              mode):
    """While the window grows a past token's context never changes, so the
    cached step is the windowed forward; after the slide it is another
    mode."""
    for ref, got in zip(port_runs["recompute"], port_runs[mode]):
        np.testing.assert_allclose(got[:SLIDE_T], ref[:SLIDE_T], atol=1e-9,
                                   rtol=0)
        assert np.isfinite(got).all()
    assert np.abs(port_runs[mode][0] - port_runs["recompute"][0]).max() > 1e-6


def test_rnn_carry_equals_kv_cache_until_the_slide_then_diverges(port_runs):
    """The carried hidden is the replay's recurrence while the encoder ring
    only grows; afterwards it keeps history the replay forgets."""
    cached, carry = port_runs["kv_cache"][0], port_runs[MODES[1]][0]
    np.testing.assert_allclose(carry[:SLIDE_T], cached[:SLIDE_T], atol=1e-9,
                               rtol=0)
    assert np.abs(carry[SLIDE_T + 2:] - cached[SLIDE_T + 2:]).max() > 1e-6


def _step_through(stream, cfg_of_frame, model, n_frames, tick0=None):
    imu, s_init = stream
    skel = tkin.amass_skeleton(dtype=torch.float64)
    carry = TR.runner_init(cfg_of_frame(0), skel, s_init, dtype=torch.float64,
                           device="cpu")
    outs = [np.asarray(s_init)]
    with torch.no_grad():
        for t in range(n_frames - 1):
            carry, out = TR.runner_step(
                model, carry, torch.as_tensor(imu[t]), cfg_of_frame(t), skel,
                tick=None if tick0 is None else tick0 + t)
            outs.append(out["qdq"].numpy())
    return np.stack(outs), carry


def test_mode_switch_before_the_slide_continues_the_kv_cache_run(stream,
                                                                 port_runs):
    """The rnn_carry step keeps the encoder ring although it never replays
    it, so a stream can switch to the replay mode mid-stream: switched
    before the slide, it continues the all-kv_cache trajectory, through
    and beyond the slide."""
    cfgs = {m: TR.RunnerConfig(model=TM.ModelConfig(**TINY), serving_mode=m)
            for m in MODES}
    model = _port_model(cfgs[MODES[0]].model)
    got, carry = _step_through(
        stream, lambda t: cfgs[MODES[1] if t < 20 else MODES[0]], model, 70)
    np.testing.assert_allclose(got, port_runs["kv_cache"][0][:70], atol=1e-9,
                               rtol=0)
    assert carry.cache.h.abs().max() > 0      # carried for 15 model frames
    assert carry.accsum_win is None and carry.s_and_c_win.shape == (131,)
    assert carry.imu_win.shape == (40, 18)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_global_tick_equals_the_streams_own_cursor(stream, mode, impl):
    """One stream driven with tick = t + 7 (the acc ring, the output ring
    and the cache entered at another slot, validity from the cache's own
    ring) gives the trajectory of the same stream without a tick: the
    single-stream form of a join of a running pool. 60 frames: the
    cursor wraps."""
    dtype = torch.float64 if impl == "plain" else torch.float32
    cfg = TR.RunnerConfig(
        model=TM.ModelConfig(**TINY, forward_impl=impl,
                             compute_dtype=None if impl == "plain"
                             else "float32"),
        serving_mode=mode)
    model = _port_model(cfg.model, dtype, seed=5)
    imu, s_init = stream
    skel = tkin.amass_skeleton(dtype=dtype)
    runs = []
    for tick0 in (None, 7):
        carry = TR.runner_init(cfg, skel, s_init, dtype=dtype, device="cpu")
        outs = []
        with torch.no_grad():
            for t in range(60):
                carry, out = TR.runner_step(
                    model, carry, torch.as_tensor(imu[t]), cfg, skel,
                    tick=None if tick0 is None else tick0 + t)
                outs.append(out["qdq"])
        runs.append(torch.stack(outs))
    # the same values meet in the same order: only the ring slots differ
    assert torch.isfinite(runs[1]).all()
    np.testing.assert_allclose(runs[1].numpy(), runs[0].numpy(),
                               atol=1e-9 if impl == "plain" else 1e-5, rtol=0)


# ---------------------------------------------------------------------------
# (e) the wrappers' rules
# ---------------------------------------------------------------------------

def test_explicit_fused_on_cpu_raises_and_unknown_impl_too():
    tcfg = TM.ModelConfig(**TINY, compute_dtype="float32")
    ws = TM.TIPModel(tcfg, device="cpu").packed_weights(torch.float32)
    cache = TSC.cache_init(tcfg, W, device="cpu")
    before = cache.clone()
    x = torch.zeros(221)
    for fn in (TSC.fused_cached_forward_step, TSC.fused_cached_step_slot):
        with pytest.raises(ValueError, match="CUDA"):
            fn(ws, cache, x, 0, True, tcfg, impl="fused")
        with pytest.raises(ValueError, match="auto"):
            fn(ws, cache, x, 0, True, tcfg, impl="pallas")
    assert _cache_equal(cache, before)


def test_ring_dtype_must_equal_packing_dtype():
    tcfg = TM.ModelConfig(**TINY, compute_dtype="bfloat16")
    model = TM.TIPModel(tcfg, device="cpu")
    cache = TSC.cache_init(tcfg, W, device="cpu")          # bf16 rings
    with pytest.raises(TypeError, match="rings"):
        TSC.fused_cached_step_slot(model.packed_weights(torch.float32),
                                   cache, torch.zeros(221), 0, True, tcfg)
    with pytest.raises(ValueError, match="packed weights"):
        TSC.fused_cached_step_slot(model.packed_weights(torch.bfloat16)[:-1],
                                   cache, torch.zeros(221), 0, True, tcfg)


def test_unknown_serving_mode_raises_value_error():
    with pytest.raises(ValueError, match="serving_mode"):
        TR.RunnerConfig(serving_mode="paged")
    for mode in ("recompute",) + MODES:
        assert TR.RunnerConfig(serving_mode=mode).cached == (
            mode != "recompute")


@pytest.mark.parametrize("dt,want", [(None, torch.float32),
                                     ("bfloat16", torch.bfloat16)])
def test_cached_runner_packs_in_the_rings_dtype(dt, want):
    """Cached modes: the packing dtype is compute_dtype, else the carry's
    dtype (float32), not the windowed fused forward's bfloat16 default."""
    mcfg = TM.ModelConfig(**TINY, forward_impl="fused", compute_dtype=dt)
    cfg = TR.RunnerConfig(model=mcfg, serving_mode="kv_cache")
    model = TM.TIPModel(mcfg, device="cpu")
    assert TR.pack_dtype(cfg) == want
    assert TR.pack_fused_weights(model, cfg)[0].dtype == want
    carry = TR.runner_init(cfg, tkin.amass_skeleton(), torch.zeros(114),
                           device="cpu")
    assert carry.cache.k.dtype == want and carry.cache.k.shape == (2, 40, 32)
    windowed = TR.RunnerConfig(model=mcfg)
    assert TR.pack_dtype(windowed) == (want if dt else torch.bfloat16)


def test_phase_split_reads_k7s_clock_rows():
    """K7's per-phase clock rows split under ``K7_PHASES`` (a replay: its
    walk has no barrier and no arrivals, and is counted whole)."""
    from tip_tpu_torch.ops import fused_forward as TFF
    assert TSC.K7_PHASES == ("start", "in_proj", "qkv", "attn_out", "ff1",
                             "ff2", "rnn_in", "rnn", "out_proj")
    big = 2 ** 62
    rows = [[2_000_000, big, 0, 0],
            [2_004_000, 2_001_000, 2_003_000, 1],     # in_proj
            [2_008_000, 2_005_000, 2_007_000, 2],     # qkv with attention
            [2_011_000, 2_009_000, 2_010_000, 3],     # attn_out
            [2_014_000, 2_012_000, 2_013_000, 4],     # ff1
            [2_017_000, 2_015_000, 2_016_000, 5],     # ff2
            [2_020_000, 2_018_000, 2_019_000, 6],     # rnn_in
            [2_060_000, big, 0, 7],                   # the walk
            [2_063_000, 2_061_000, 2_062_000, 8],     # out_proj
            [0, big, 0, 0]]
    split, n = TFF.phase_split(rows, TSC.K7_PHASES)
    assert n == 8
    assert split["qkv"] == pytest.approx(0.003)
    assert split["rnn"] == pytest.approx(0.04)
    assert split["out_proj"] == pytest.approx(0.002)
    assert split["barrier"] == pytest.approx(7 * 0.001)
    assert split["total"] == pytest.approx(0.063)
    assert sum(split[k] for k in TSC.K7_PHASES[1:]) + split["barrier"] \
        == pytest.approx(split["total"])
