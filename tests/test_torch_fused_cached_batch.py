"""The pool's cached step (tip_tpu_torch.runtime.streaming_cache, its batched
part) against tip_tpu's, on the CPU at a small size.

B streams at one global ring cursor join at staggered steps (``commit`` is
False before a stream's join). The same tokens and weights, made from a
seed with numpy, go through

  * ``fused_cached_batch`` on CPU tensors, which is K8's plain version
    ``fused_cached_batch_plain``, against tip_tpu's ``fused_cached_batch``
    (a Pallas kernel, in interpret mode as tip_tpu's own tests run it);
  * the same against the port's batched plain step
    ``cached_forward_step_batch`` and against the single-stream K7 plain
    version stream by stream;
  * ``cached_forward_step_batch`` in float64 against tip_tpu's ``vmap`` of
    its plain step.

An uncommitted stream's ring rows differ by design (tip_tpu writes the
cursor row unconditionally and relies on ``valid``; the port leaves them
alone), so rings are compared where valid, as tip_tpu's own test does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.ops import fused_forward as JFF
from tip_tpu.runtime import streaming_cache as JSC
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import fused_forward as TFF
from tip_tpu_torch.runtime import streaming_cache as TSC

torch.set_num_threads(1)

TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
W = 8
STEPS = 2 * W + 3               # the cursor wraps twice
JOINS = {4: [0, 0, 3, 5], 6: [0, 0, 3, 5, 9, 1]}   # 6: no tile divides it
LEAVES = ("k", "v", "enc", "h", "valid")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32 packing: sums in another order through 2 layers and up to 8 RNN
# steps; bf16 packing: a sum on the other side of a rounding boundary moves
# an activation by one bf16 step (2^-8 relative) before it is multiplied on
ATOL = {"float32": 2e-4, "bfloat16": 1e-2}
PLAIN_STEP_ATOL = {"float32": 2e-4, "bfloat16": 2e-2}
# a stored bf16 ring row differs by a bf16 step or two where a sum rounded
# the other way, 2^-8 of the value each: held relative to the ring's
# largest magnitude
RING_BF16_REL = 2.0 ** -7


def _ring_atol(ref, atol, rel=RING_BF16_REL):
    return atol if atol < 1e-3 else \
        max(atol, rel * max(1.0, float(np.abs(ref).max())))


def _np(a):
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    return np.asarray(a)


def _models(dt, seed=0):
    kw = dict(TINY, compute_dtype=dt)
    jcfg, tcfg = JM.ModelConfig(**kw), TM.ModelConfig(**kw)
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TM.TIPModel(tcfg, device="cpu")
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, tcfg, params, model


def _tokens(rng, B, input_dim, dtype=np.float32):
    x = rng.normal(size=(B, input_dim)).astype(dtype)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[:, 90 + 108:90 + 111] = 5.0        # the zeroed root-velocity columns
    return x


def _assert_masked(tc, jc, atol, msg):
    """valid equal; h close; rings close where valid."""
    valid = np.asarray(jc.valid)
    np.testing.assert_array_equal(tc.valid.numpy(), valid, err_msg=msg)
    np.testing.assert_allclose(tc.h.double().numpy(), _np(jc.h), atol=atol,
                               rtol=0, err_msg=f"h {msg}")
    for n, m in (("k", valid[:, None, :, None]), ("v", valid[:, None, :, None]),
                 ("enc", valid[:, :, None])):
        ref = _np(getattr(jc, n)) * m
        np.testing.assert_allclose(getattr(tc, n).double().numpy() * m, ref,
                                   atol=_ring_atol(ref, atol), rtol=0,
                                   err_msg=f"{n} {msg}")


@pytest.mark.parametrize("B", [4, 6])
@pytest.mark.parametrize("rnn_carry", [False, True],
                         ids=["replay", "carry"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_cached_batch_plain_matches_pallas(dt, rnn_carry, B):
    jcfg, tcfg, params, model = _models(dt)
    jws = tuple(JFF.pack_weights(params, jcfg, dtype=JDT[dt]))
    tws = model.packed_weights(TDT[dt])
    rng = np.random.default_rng(10 + B)
    jc = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape),
        JSC.cache_init(jcfg, W))
    tc = TSC.cache_init(tcfg, W, device="cpu", batch=B)
    assert tc.k.shape == (B, 2, W, 32) and tc.k.dtype == TDT[dt]
    joins = np.asarray(JOINS[B])
    K.reset_launch_counts()
    for step in range(STEPS):
        x = _tokens(rng, B, jcfg.input_dim)
        commit = joins <= step
        slot = (step + 5) % W
        jc, jy = JSC.fused_cached_batch(
            jws, jc, jnp.asarray(x), jnp.asarray(slot, jnp.int32),
            jnp.asarray(commit), jcfg, rnn_carry=rnn_carry, b_tile=2,
            interpret=True)
        out, ty = TSC.fused_cached_batch(
            tws, tc, torch.as_tensor(x), slot + W, torch.as_tensor(commit),
            tcfg, rnn_carry=rnn_carry)      # the cursor is taken mod W
        assert out is tc and ty.dtype == torch.float32
        np.testing.assert_allclose(ty.numpy()[commit], np.asarray(jy)[commit],
                                   atol=ATOL[dt], rtol=0,
                                   err_msg=f"step {step}")
        _assert_masked(tc, jc, ATOL[dt], f"step {step}")
    assert tc.valid.all()
    assert sum(K.launch_counts.values()) == 0


@pytest.mark.parametrize("rnn_carry", [False, True],
                         ids=["replay", "carry"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_cached_batch_plain_matches_the_batched_plain_step_and_k7(
        dt, rnn_carry):
    """K8's plain version against the port's own references on the same
    tokens: the batched plain cached step, and K7's plain version run
    stream by stream at the global cursor from each stream's join on."""
    _, tcfg, _, model = _models(dt, seed=1)
    tws = model.packed_weights(TDT[dt])
    B = 4
    joins = np.asarray(JOINS[B])
    rng = np.random.default_rng(3)
    fused = TSC.cache_init(tcfg, W, device="cpu", batch=B)
    plain = TSC.cache_init(tcfg, W, device="cpu", batch=B)
    single = [TSC.cache_init(tcfg, W, device="cpu") for _ in range(B)]
    for step in range(STEPS):
        x = torch.as_tensor(_tokens(rng, B, tcfg.input_dim))
        commit = joins <= step
        slot = (step + 2) % W
        untouched = fused.clone()
        _, yf = TSC.fused_cached_batch(tws, fused, x, slot,
                                       torch.as_tensor(commit), tcfg,
                                       rnn_carry=rnn_carry)
        _, yp = TSC.cached_forward_step_batch(model, plain, x, slot,
                                              torch.as_tensor(commit), tcfg,
                                              rnn_carry=rnn_carry)
        # the plain step in bf16 rounds every intermediate and y itself to
        # bf16 (K8 keeps f32 sums): 2e-2 there, as for the single stream
        np.testing.assert_allclose(yf.numpy()[commit],
                                   yp.float().numpy()[commit],
                                   atol=PLAIN_STEP_ATOL[dt], rtol=0)
        for b in range(B):
            if not commit[b]:
                # an uncommitted stream keeps its rings and h bit for bit
                for n in LEAVES[:4]:
                    assert torch.equal(getattr(fused, n)[b],
                                       getattr(untouched, n)[b])
                assert not fused.valid[b, slot]
                continue
            _, y7 = TSC.fused_cached_step_slot(tws, single[b], x[b], slot,
                                               True, tcfg,
                                               rnn_carry=rnn_carry)
            # the same casts on the same values, batched products (in
            # bf16 a sum in another order can flip a rounding)
            np.testing.assert_allclose(
                yf[b].numpy(), y7.numpy(), rtol=0,
                atol=1e-5 if dt == "float32" else ATOL[dt])
    assert torch.equal(fused.valid, plain.valid)
    valid = fused.valid
    for n, m in (("k", valid[:, None, :, None]), ("v", valid[:, None, :, None]),
                 ("enc", valid[:, :, None])):
        ref = (getattr(plain, n).float() * m).numpy()
        np.testing.assert_allclose((getattr(fused, n).float() * m).numpy(),
                                   ref, rtol=0,
                                   atol=_ring_atol(ref, PLAIN_STEP_ATOL[dt],
                                                   2 * RING_BF16_REL))
    for b in range(B):
        assert torch.equal(fused.valid[b], single[b].valid)


@pytest.mark.parametrize("rnn_carry", [False, True],
                         ids=["replay", "carry"])
def test_cached_forward_step_batch_matches_tip_tpu_vmap(rnn_carry):
    """float64: the batched plain step is tip_tpu's vmap of its plain step
    with a shared slot_override and a batched commit; the port starts from
    tip_tpu's mid-session cache (``cache_from_jax`` with a leading B)."""
    jcfg, tcfg = JM.ModelConfig(**TINY), TM.ModelConfig(**TINY)
    params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float64),
        JM.init_params(jax.random.PRNGKey(0), jcfg))
    model = TM.TIPModel(tcfg, device="cpu", dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    B = 4
    joins = np.asarray(JOINS[B])
    jstep = jax.jit(jax.vmap(
        lambda c, x, slot, cm: JSC.cached_forward_step(
            params, c, x, jnp.zeros((), jnp.int32), jcfg,
            rnn_carry=rnn_carry, slot_override=slot, commit=cm),
        in_axes=(0, 0, None, 0)))
    jc = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape),
        JSC.cache_init(jcfg, W, jnp.float64))
    rng = np.random.default_rng(5)
    tc = None
    for step in range(STEPS):
        x = _tokens(rng, B, jcfg.input_dim, np.float64)
        commit = joins <= step
        if step == 4:           # the port joins here, from tip_tpu's state
            tc = TSC.cache_from_jax(*(np.asarray(getattr(jc, n))
                                      for n in LEAVES))
            assert tc.k.shape == (B, 2, W, 32)
        jc, jy = jstep(jc, jnp.asarray(x), jnp.asarray(step + 3, jnp.int32),
                       jnp.asarray(commit))
        if tc is None:
            continue
        _, ty = TSC.cached_forward_step_batch(
            model, tc, torch.as_tensor(x), step + 3, torch.as_tensor(commit),
            tcfg, rnn_carry=rnn_carry)
        np.testing.assert_allclose(ty.numpy()[commit], np.asarray(jy)[commit],
                                   atol=1e-9, rtol=0, err_msg=f"step {step}")
        for n in LEAVES[:4]:
            np.testing.assert_allclose(getattr(tc, n).numpy(),
                                       np.asarray(getattr(jc, n)), atol=1e-9,
                                       rtol=0, err_msg=f"{n} step {step}")
        np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))


@pytest.mark.parametrize("rnn_carry", [False, True],
                         ids=["replay", "carry"])
def test_uncommitted_step_on_a_full_ring_pins_each_steps_state(rnn_carry):
    """The two pool steps leave an uncommitted stream different validity
    bits, each as its tip_tpu twin does: the plain batched step keeps the
    bit under the cursor (the stream goes on attending the old row there),
    K8 and its plain version clear it (the row is evicted). Both keep the
    stream's ring rows and h bit for bit. In a pool ``commit`` is False only
    for a freshly joined slot, whose ring is empty, so the difference never
    shows there; here it is False on a full ring."""
    jcfg, tcfg, params, model = _models("float32", seed=2)
    jws = tuple(JFF.pack_weights(params, jcfg, dtype=jnp.float32))
    tws = model.packed_weights(torch.float32)
    B = 3
    jstep = jax.jit(jax.vmap(
        lambda c, x, slot, cm: JSC.cached_forward_step(
            params, c, x, jnp.zeros((), jnp.int32), jcfg,
            rnn_carry=rnn_carry, slot_override=slot, commit=cm),
        in_axes=(0, 0, None, 0)))
    empty = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape),
        JSC.cache_init(jcfg, W))
    j_plain, j_fused = empty, empty
    plain = TSC.cache_init(tcfg, W, device="cpu", batch=B)
    fused = TSC.cache_init(tcfg, W, device="cpu", batch=B)
    rng = np.random.default_rng(8)
    held = np.array([True, False, True])     # stream 1 sits the last step out
    for step in range(W + 1):
        x = _tokens(rng, B, jcfg.input_dim)
        commit = held if step == W else np.ones(B, bool)
        slot = (step + 3) % W                # step W: back on a full ring
        before_p, before_f = plain.clone(), fused.clone()
        j_plain, jyp = jstep(j_plain, jnp.asarray(x),
                             jnp.asarray(slot, jnp.int32),
                             jnp.asarray(commit))
        j_fused, jyf = JSC.fused_cached_batch(
            jws, j_fused, jnp.asarray(x), jnp.asarray(slot, jnp.int32),
            jnp.asarray(commit), jcfg, rnn_carry=rnn_carry, b_tile=1,
            interpret=True)
        _, yp = TSC.cached_forward_step_batch(
            model, plain, torch.as_tensor(x), slot, torch.as_tensor(commit),
            tcfg, rnn_carry=rnn_carry)
        _, yf = TSC.fused_cached_batch(
            tws, fused, torch.as_tensor(x), slot, torch.as_tensor(commit),
            tcfg, rnn_carry=rnn_carry)
    assert before_p.valid.all() and before_f.valid.all()
    # the committed streams agree across all four, as on any other step
    for y in (yf.numpy(), np.asarray(jyp), np.asarray(jyf)):
        np.testing.assert_allclose(y[held], yp.numpy()[held],
                                   atol=ATOL["float32"], rtol=0)
    # the plain batched step and tip_tpu's vmapped step keep the bit
    assert plain.valid.all()
    np.testing.assert_array_equal(np.asarray(j_plain.valid), plain.valid)
    # K8's plain version and tip_tpu's batched kernel evict the cursor row
    want = np.ones((B, W), bool)
    want[1, slot] = False
    np.testing.assert_array_equal(fused.valid.numpy(), want)
    np.testing.assert_array_equal(np.asarray(j_fused.valid), want)
    # both of the port's steps leave the stream's rings and h untouched
    for cache, before in ((plain, before_p), (fused, before_f)):
        for n in LEAVES[:4]:
            assert torch.equal(getattr(cache, n)[1], getattr(before, n)[1]), n
    # and the two caches still agree wherever both call a slot valid
    both = plain.valid & fused.valid
    for n, m in (("k", both[:, None, :, None]), ("v", both[:, None, :, None]),
                 ("enc", both[:, :, None])):
        np.testing.assert_allclose((getattr(fused, n) * m).numpy(),
                                   (getattr(plain, n) * m).numpy(),
                                   atol=ATOL["float32"], rtol=0, err_msg=n)


def test_fused_cached_batch_wrapper_rules():
    """An explicit kernel request on CPU tensors raises, an unknown impl
    too; the rings' dtype must be the packing's; a single stream's cache is
    refused."""
    tcfg = TM.ModelConfig(**TINY, compute_dtype="float32")
    model = TM.TIPModel(tcfg, device="cpu")
    ws = model.packed_weights(torch.float32)
    cache = TSC.cache_init(tcfg, W, device="cpu", batch=3)
    before = cache.clone()
    x = torch.zeros(3, 221)
    commit = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        TSC.fused_cached_batch(ws, cache, x, 0, commit, tcfg, impl="fused")
    with pytest.raises(ValueError, match="auto"):
        TSC.fused_cached_batch(ws, cache, x, 0, commit, tcfg, impl="pallas")
    with pytest.raises(TypeError, match="rings"):
        TSC.fused_cached_batch(model.packed_weights(torch.bfloat16), cache, x,
                               0, commit, tcfg)
    with pytest.raises(ValueError, match="stream axis"):
        TSC.fused_cached_batch(ws, TSC.cache_init(tcfg, W, device="cpu"), x,
                               0, commit, tcfg)
    assert all(torch.equal(getattr(cache, n), getattr(before, n))
               for n in LEAVES)
    part = cache.streams(1, 3)
    TSC.fused_cached_batch(ws, part, x[1:], 2, commit[1:], tcfg)
    assert cache.valid[:, 2].tolist() == [False, True, True]   # views


def test_phase_split_reads_k8s_clock_rows():
    """K8's per-phase clock rows split under ``K8_PHASES``: each kind of
    phase named as csrc/fused_cached_batch.cu numbers it, a replay's walk
    (no arrivals) counted whole, barriers and the first-to-last arrival
    summed apart, rows after the last end not read."""
    assert TSC.K8_PHASES == ("start", "in_proj", "qkv", "attention",
                             "attn_out", "ln1", "ff1", "ff2", "ln2",
                             "rnn_in", "rnn", "out_proj")
    big = 2 ** 62
    rows = [[1_000_000, big, 0, 0],
            [1_400_000, 1_100_000, 1_300_000, 1],     # in_proj
            [1_600_000, 1_450_000, 1_550_000, 3],     # attention
            [1_800_000, 1_650_000, 1_700_000, 9],     # rnn_in
            [2_800_000, big, 0, 10],                  # the replay's walk
            [2_900_000, 2_820_000, 2_880_000, 11],    # out_proj
            [0, big, 0, 0], [7, 7, 7, 7]]
    split, n = TFF.phase_split(rows, TSC.K8_PHASES)
    assert n == 5
    assert set(split) == set(TSC.K8_PHASES[1:]) | {"barrier", "imbalance",
                                                   "total"}
    assert split["in_proj"] == pytest.approx(0.3)
    assert split["attention"] == pytest.approx(0.15)
    assert split["rnn_in"] == pytest.approx(0.1)
    assert split["rnn"] == pytest.approx(1.0)
    assert split["out_proj"] == pytest.approx(0.08)
    assert split["barrier"] == pytest.approx(0.1 + 0.05 + 0.1 + 0.02)
    assert split["imbalance"] == pytest.approx(0.2 + 0.1 + 0.05 + 0.06)
    assert split["total"] == pytest.approx(1.9)
    assert sum(split[k] for k in TSC.K8_PHASES[1:]) + split["barrier"] \
        == pytest.approx(split["total"])
    assert split["qkv"] == split["ff2"] == 0.0
