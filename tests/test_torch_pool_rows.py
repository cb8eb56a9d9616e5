"""tip_tpu's twelve throughput rows (bench_throughput.py:39-54) at the
settings the port serves them in, on the CPU at a small size.

The rows that differ only in their number of streams are one case: each of
the seven settings (compute dtype, serving mode, forward) runs the port's
StreamPool at capacity 8 beside tip_tpu's, tick by tick over 60 ticks of
chip_smoke.py's row schedule (every slot joins at tick 0 but for four that
join mid-session; one stream leaves at tick 30 and its slot is handed out
again at 33), on the 60 in-tree motions. tip_tpu runs its Pallas kernels
(``encoder_impl="pallas"``, ``rnn_impl="pallas"``, the fused batch kernels)
in interpret mode, as its own tests run them on the CPU; the port runs its
kernels' plain versions.

The f32 setting runs both pools free, held within 5e-3, the f32 tolerance of
tests/test_torch_serving.py. A free-running bf16 trajectory of a random
model drifts from any other run chaotically once a rounding flip feeds back
through the history (tests/test_torch_bf16_route.py), so the bf16 settings
are held tick by tick from one state: before every tick the port's pool
takes tip_tpu's whole carry (windows, counters, cache rings), then both
step. The model's output of the tick (its newest row of the output ring in
tip_tpu's carry) is held within TOL_MODEL, test_torch_bf16_route.py's model
tolerance, on the kernels' routes, and within 2e-2 on the plain cached step
(rows 5 and 6), test_torch_streaming_cache.py's for that step in bf16; the
decode and the tail that follow it run in f32, so the port's
are fed tip_tpu's model output and their outputs held within the f32
tolerance. Each pool's own add_stream is held too: the slot it writes
equals tip_tpu's. tip_tpu's fused recompute reads a row past the window
once a stream's window slides (ROADMAP C3): there its outputs are left
out.

Beside that, chip_smoke.run_pool_row (checks (a)-(c)) runs
each setting on the CPU, and the launches a tick it expects are the
routing's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as CS
from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import runner as JR
from tip_tpu.runtime import serving as JS
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import runner as TR
from tip_tpu_torch.runtime import streaming_cache as TSC
from tip_tpu_torch.runtime.serving import StreamPool

torch.set_num_threads(1)

TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
JAX_KERNELS = dict(encoder_impl="pallas", rnn_impl="pallas")
CAPACITY, TICKS = 8, 60
# tests/test_torch_serving.py's f32 pools against tip_tpu's
TOL_F32 = 5e-3
# tests/test_torch_bf16_route.py's model tolerance (the kernels' routes:
# their plain versions round where tip_tpu's kernels do)
TOL_MODEL = 1e-2
# the plain cached step in bf16 (rows 5 and 6; no kernel of its own) rounds
# at every op in both frameworks, which order their sums otherwise:
# tests/test_torch_streaming_cache.py's bf16 step against tip_tpu's
TOL_PLAIN_BF16 = 2e-2
OUTS = ("qdq", "viz_locs", "ct")
SETTINGS = sorted({(dt, mode, fwd) for _, _, dt, mode, fwd in CS.POOL_ROWS})


def _id(s):
    return "-".join(s)


@pytest.fixture(scope="module")
def motions():
    return CS.load_motions()


def _jax_leaves(jc):
    """tip_tpu's stacked RunnerCarry as numpy leaves by name, bf16 widened
    to f32."""
    def arr(a):
        a = jnp.asarray(a)
        return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                          else a)
    d = {n: (None if getattr(jc, n) is None else arr(getattr(jc, n)))
         for n in TR._COUNTERS + TR._TENSOR_LEAVES}
    d["cache"] = None if jc.cache is None else {
        n: arr(getattr(jc.cache, n)) for n in TSC._LEAVES}
    return d


def _handover(tpool, jpool):
    """The port's pool takes tip_tpu's whole carry, the rings in the
    dtypes of its own."""
    mine = tpool._carries
    c = TR.pool_carry_from_jax(_jax_leaves(jpool._carries),
                               dtype=torch.float32)
    if c.cache is not None:
        c.cache = TSC.KVCache(*(getattr(c.cache, n).to(
            getattr(mine.cache, n).dtype) for n in TSC._LEAVES))
    tpool._carries = c


def _slot_equal(tpool, jpool, slot):
    """The slot add_stream wrote: every leaf of the port's equals
    tip_tpu's."""
    j = _jax_leaves(jpool._carries)
    t = tpool._carries
    for n in TR._COUNTERS:
        assert getattr(t, n)[slot] == j[n][slot], n
    for n in TR._TENSOR_LEAVES:
        if j[n] is not None:
            np.testing.assert_allclose(getattr(t, n)[slot].double().numpy(),
                                       j[n][slot], atol=1e-6, rtol=0,
                                       err_msg=n)
    if j["cache"] is not None:
        for n in TSC._LEAVES:
            np.testing.assert_array_equal(
                getattr(t.cache, n)[slot].float().numpy(),
                j["cache"][n][slot], err_msg=n)


def _newest_output(jpool, tick, cfg):
    """The model's output of the tick just stepped, for every stream: the
    row of tip_tpu's output ring the tick wrote (newest last in recompute
    mode, at the global tick in the cached ones)."""
    buf = np.asarray(jnp.asarray(jpool._carries.out_buf, jnp.float32))
    return buf[:, tick % cfg.filter_len] if cfg.cached else buf[:, -1]


class _TeacherY:
    """Within this context the port pool's model call runs as it does and
    keeps its output of each stream (``y``), then returns ``y_given``
    instead (float32), so that the decode and the tail see tip_tpu's model
    output."""

    def __init__(self, model, cfg, y_given, k_last):
        self.model, self.cfg = model, cfg
        self.y_given = torch.as_tensor(np.array(y_given))
        self.k = torch.as_tensor(k_last)
        self.y = None

    def __enter__(self):
        where = CS.model_call(self.cfg)
        rows = torch.arange(len(self.k))
        if where is None:
            model = self.model

            def forward(x_imu, x_s):
                y = type(model).forward(model, x_imu, x_s)
                self.y = y[rows, self.k]
                y = y.clone()
                y[rows, self.k] = self.y_given.to(y.dtype)
                return y
            model.forward = forward
            self.ctx = CS.patched()
        elif self.cfg.cached:
            orig = getattr(*where)

            def call(*a, **kw):
                cache, self.y = orig(*a, **kw)
                # f32, as the runner takes it on (tip_tpu's y is f32 where
                # the port's plain step answers in the rings' bf16)
                return cache, self.y_given
            self.ctx = CS.patched((*where, call))
        else:
            orig = getattr(*where)

            def call(*a, **kw):
                self.y = orig(*a, **kw)
                return self.y_given.to(self.y.dtype)
            self.ctx = CS.patched((*where, call))
        self.ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self.ctx.__exit__(*exc)
        self.model.__dict__.pop("forward", None)


@pytest.mark.parametrize("setting", SETTINGS, ids=_id)
def test_pool_setting_matches_tip_tpus_pool(setting, motions):
    dt, mode, fwd = setting
    bf16 = dt == "bfloat16"
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(
        **TINY, **JAX_KERNELS, compute_dtype=dt,
        forward_impl="xla" if fwd == "plain" else fwd), serving_mode=mode)
    tcfg = CS.row_config(dt, mode, fwd, **TINY)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32),
        JM.init_params(jax.random.PRNGKey(0), jcfg.model))
    model = TM.TIPModel(tcfg.model, device="cpu")
    model.load_state_dict(TM.params_from_jax(params))
    jpool = JS.StreamPool(params, jcfg, jkin.amass_skeleton(
        dtype=np.float32), capacity=CAPACITY, dtype=jnp.float32)
    tpool = StreamPool(model, tcfg, tkin.amass_skeleton(), capacity=CAPACITY,
                       device="cpu")
    batch, events, motion = CS.row_schedule(CAPACITY, motions)
    s_inits = motions[1]
    K.reset_launch_counts()
    held = 0
    for t in range(TICKS):
        for kind, slot, m in events.get(t, ()):
            if kind == "remove":
                jpool.remove_stream(slot)
                tpool.remove_stream(slot)
                continue
            assert jpool.add_stream(s_inits[m]) == slot
            assert tpool.add_stream(s_inits[m]) == slot
            _slot_equal(tpool, jpool, slot)
        assert (tpool.active == jpool.active).all()
        on = tpool.active.copy()
        if fwd == "fused" and mode == "recompute":
            # ROADMAP C3: tip_tpu's fused recompute past the window
            jc = jpool._carries
            have = np.asarray(jc.t) >= tcfg.imu_n_smooth
            on &= np.asarray(jc.k) + have <= tcfg.window
        if bf16:
            _handover(tpool, jpool)      # tip_tpu's state before the tick
        _, _, ran, k_last = TR._pool_counters(tcfg, tpool._carries)
        ran &= on                        # the streams the model ran for
        jo = jpool.step(batch[t])
        if bf16:
            y_j = _newest_output(jpool, t, tcfg)
            with _TeacherY(model, tcfg, y_j, k_last) as ty:
                to = tpool.step(batch[t])
            tol = TOL_PLAIN_BF16 if mode != "recompute" and fwd == "plain" \
                else TOL_MODEL
            np.testing.assert_allclose(ty.y.float().numpy()[ran], y_j[ran],
                                       atol=tol, rtol=0,
                                       err_msg=f"the model, tick {t}")
        else:
            to = tpool.step(batch[t])
        for n in OUTS:
            a, b = to[n].numpy()[on], np.asarray(jo[n])[on]
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, b, atol=TOL_F32, rtol=0,
                                       err_msg=f"{n}, tick {t}")
        held += int(on.sum())
    assert sum(K.launch_counts.values()) == 0
    assert held > CAPACITY * (TICKS - 40)


@pytest.mark.parametrize("setting", SETTINGS, ids=_id)
def test_run_pool_row_on_the_cpu(setting, motions):
    """chip_smoke.run_pool_row at capacity 8 on the CPU: the schedule, the
    sentinels and checks (b) and (c) run (the plain versions against
    themselves here: exact, but for the single-stream ops' other sum
    order)."""
    dt, mode, fwd = setting
    model = TM.TIPModel(TM.ModelConfig(**TINY), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    dev = torch.device("cpu")
    s = CS.run_pool_row(0, CAPACITY, dt, mode, fwd, model.state_dict(),
                        tkin.amass_skeleton(), dev, motions, model_kw=TINY)
    assert s["checked_ticks"] == list(CS.ROW_CHECKED_TICKS)
    assert (s["ticks"], s["timed_ticks"]) == (CS.ROW_TICKS, CS.ROW_TIMED)
    assert max(s["worst_b"].values()) == 0.0
    # the single-stream ops sum in another order than the pool's
    assert s["worst_c"] <= 1e-5
    assert set(s["sentinels"]) == {str(x) for x in CS.row_sentinels(
        CAPACITY)}
    assert s["rebuild_streams"] == CAPACITY and s["fill_streams"] == 4
    if dt == "float32":
        assert s["free_running_worst"] <= 1e-5


def test_row_kernels_are_the_routing_of_each_row():
    """The launches a tick chip_smoke holds each row to."""
    want = {
        1: {"encoder_layer_fwd": 4, "fused_rnn": 1},
        2: {"encoder_layer_fwd_bf16": 4, "fused_rnn_bf16": 1},
        3: {"encoder_layer_fwd_bf16": 4, "fused_rnn_bf16": 1},
        4: {"fused_recompute_batch": 1}, 5: {}, 6: {},
        **{r: {"fused_cached_batch": 1} for r in (7, 8, 9, 10, 11, 12)}}
    for row, B, dt, mode, fwd in CS.POOL_ROWS:
        got = CS.row_kernels(CS.row_config(dt, mode, fwd))
        assert got == dict(want[row], decode_fused=1, tail_fused=1), row
        assert set(got) <= set(CS.KERNELS)
    assert [r[1] for r in CS.POOL_ROWS] == [256, 256, 512, 512, 256, 256,
                                            256, 512, 1024, 512, 2048, 4096]


@pytest.mark.parametrize("B", [8, 256, 4096])
def test_row_schedule(B, motions):
    """Every slot joins once (four late), slot 5 leaves and rejoins; the
    sentinels are distinct slots at the pool's edges and middle; a slot
    with no stream is fed zeros."""
    batch, events, motion = CS.row_schedule(B, motions)
    adds = [(t, s) for t, ev in events.items() for k, s, _ in ev
            if k == "add"]
    assert sorted(s for _, s in adds) == sorted(list(range(B)) + [5])
    assert sorted(t for t, s in adds if t > 0) == sorted(
        list(CS.ROW_JOINS) + [CS.ROW_READD])
    assert events[CS.ROW_REMOVE[0]] == [("remove", 5, None)]
    assert len(set(CS.row_sentinels(B))) == 4
    assert batch.shape == (CS.ROW_TICKS, B, 72)
    late = B - 1
    assert not batch[:CS.ROW_JOINS[-1], late].any()
    np.testing.assert_array_equal(batch[CS.ROW_JOINS[-1]:, late],
                                  motions[0][motion[late], :CS.ROW_TICKS
                                             - CS.ROW_JOINS[-1]])
    assert not batch[CS.ROW_REMOVE[0]:CS.ROW_READD, 5].any()
    assert max(CS.ROW_CHECKED_TICKS) < CS.ROW_CHECKED < CS.ROW_TICKS
    assert max(events) < CS.ROW_CHECKED
