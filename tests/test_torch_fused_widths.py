"""The whole-model kernels past the old row, slot and head limits (ROADMAP
C13): the plain versions of K4/K5, K7, K8 and K9 at T and W 80 (rings
through a wrap) and with two heads of 128 at d 256, against tip_tpu's fused
Pallas kernels in interpret mode, and the wrappers' refusal, which now
comes only from the launch and states the bytes. The kernels themselves
run only on the card (chip_smoke.py)."""

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

# a narrow model for the long windows, and one of two heads of 128
LONG = dict(tf_in_dim=16, tf_hid_size=32, n_heads=2, tf_layers=1,
            rnn_hid_size=16)
WIDE = dict(tf_in_dim=256, tf_hid_size=64, n_heads=2, tf_layers=1,
            rnn_hid_size=16)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: sums in another order (at most 9.5e-7 over these cases, 5.1e-7 for
# K7 at W 80; a TF32 product would miss by far more); bf16: a sum on the
# other side of a rounding boundary moves an activation by a bf16 step
# before it is multiplied on
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
LEAVES = ("k", "v", "enc", "h", "valid")


def _models(kw, dt, seed=0):
    kw = dict(kw, compute_dtype=dt)
    jcfg, tcfg = JM.ModelConfig(**kw), TM.ModelConfig(**kw)
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TM.TIPModel(tcfg, device="cpu")
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    jws = tuple(JFF.pack_weights(params, jcfg, dtype=JDT[dt]))
    return jcfg, tcfg, jws, model.packed_weights(TDT[dt])


def _np(a):
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    return np.asarray(a)


def _rows(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    x[..., 90 + 108:90 + 111] = 5.0      # the zeroed root-velocity columns
    return x


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw,T", [(LONG, 80), (WIDE, 6)],
                         ids=["T80", "heads128"])
def test_k4_k5_k9_plain_match_pallas(kw, T, dt):
    """K5 (every row), K4 (the last row and one inside) and K9 (two
    streams, their own rows) at T 80, and with heads 128 wide."""
    jcfg, tcfg, jws, tws = _models(kw, dt)
    rng = np.random.default_rng(T)
    x = _rows(rng, (2, T, jcfg.input_dim))
    j = JFF.fused_forward(jws, jnp.asarray(x[0]), jcfg, interpret=True)
    t = TFF.fused_forward(tws, torch.as_tensor(x[0]), tcfg)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL[dt],
                               rtol=0)
    for k in (T - 1, T // 2):
        jl = JFF.fused_forward_last(jws, jnp.asarray(x[0]), k, jcfg,
                                    interpret=True)
        tl = TFF.fused_forward_last(tws, torch.as_tensor(x[0]), k, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=ATOL[dt], rtol=0, err_msg=f"k {k}")
    ks = [T - 1, T // 3]
    jb = JFF.fused_recompute_batch(jws, jnp.asarray(x),
                                   jnp.asarray(ks, jnp.int32), jcfg, bt=2,
                                   bt_rnn=2, interpret=True)
    K.reset_launch_counts()
    tb = TFF.fused_recompute_batch(tws, torch.as_tensor(x), ks, tcfg)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL[dt],
                               rtol=0)
    assert sum(K.launch_counts.values()) == 0


def _full_rings(jcfg, W, B, rng, dt):
    """tip_tpu caches (B streams, or one where B is None) of random rows,
    every slot valid but slot 3 of each."""
    c = JSC.cache_init(jcfg, W)
    if B is not None:
        c = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (B,) + a.shape), c)
    fields = {}
    for n in LEAVES[:4]:
        a = getattr(c, n)
        fields[n] = jnp.asarray(rng.normal(size=a.shape) * 0.5, JDT[dt])
    valid = np.ones(c.valid.shape, bool)
    valid[..., 3] = False
    fields["valid"] = jnp.asarray(valid)
    return c.replace(**fields)


def _port_cache(jc, dt, batch):
    leaves = [_np(getattr(jc, n)) for n in LEAVES]
    if batch:
        c = TSC.cache_init(TM.ModelConfig(**LONG), leaves[2].shape[1],
                           device="cpu", batch=leaves[2].shape[0])
        for n, a in zip(LEAVES, leaves):
            getattr(c, n).copy_(torch.as_tensor(a.copy()))
    else:
        c = TSC.cache_from_jax(*leaves)
    for n in LEAVES[:4]:
        setattr(c, n, getattr(c, n).to(TDT[dt]))
    return c


def _assert_cache(tc, jc, atol, msg):
    """valid equal; h close; the rings close where valid (a stream that did
    not commit leaves its slot's row to no reader)."""
    valid = np.asarray(jc.valid)
    np.testing.assert_array_equal(tc.valid.numpy(), valid,
                                  err_msg=f"valid {msg}")
    np.testing.assert_allclose(tc.h.double().numpy(), _np(jc.h), atol=atol,
                               rtol=0, err_msg=f"h {msg}")
    for n in LEAVES[:3]:
        m = valid[..., None] if n == "enc" else valid[..., None, :, None]
        np.testing.assert_allclose(getattr(tc, n).double().numpy() * m,
                                   _np(getattr(jc, n)) * m, atol=atol,
                                   rtol=0, err_msg=f"{n} {msg}")


# the cursor's slots: the ring's end, the wrap, the start, then the
# uncommitted step's, the token at the invalid slot
SLOTS = (78, 79, 0, 1, 3)


@pytest.mark.parametrize("rnn_carry", [False, True],
                         ids=["replay", "carry"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_k7_plain_matches_pallas_at_w80_through_the_wrap(dt, rnn_carry):
    """K7 on full rings of 80 slots: the cursor crosses the wrap, one step
    is not committed (the rings stay as they were), one lands on an
    invalid slot."""
    jcfg, tcfg, jws, tws = _models(LONG, dt, seed=1)
    rng = np.random.default_rng(80)
    jc = _full_rings(jcfg, 80, None, rng, dt)
    tc = _port_cache(jc, dt, batch=False)
    for i, slot in enumerate(SLOTS):
        x = _rows(rng, (jcfg.input_dim,))
        commit = i != 3
        jc, jy = JSC.fused_cached_forward_step(
            jws, jc, jnp.asarray(x), jnp.asarray(slot, jnp.int32),
            jnp.asarray(commit), jcfg, rnn_carry=rnn_carry, interpret=True)
        before = tc.clone()
        _, ty = TSC.fused_cached_step_slot(tws, tc, torch.as_tensor(x), slot,
                                           commit, tcfg, rnn_carry=rnn_carry)
        if commit:
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                       atol=ATOL[dt], rtol=0,
                                       err_msg=f"slot {slot}")
            _assert_cache(tc, jc, ATOL[dt], f"slot {slot}")
        else:
            assert all(torch.equal(getattr(tc, n), getattr(before, n))
                       for n in LEAVES)


@pytest.mark.parametrize("rnn_carry", [False, True],
                         ids=["replay", "carry"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_k8_plain_matches_pallas_at_w80_through_the_wrap(dt, rnn_carry):
    """K8 for two streams on full rings of 80 slots, the cursor across the
    wrap, one stream not committed at one step."""
    jcfg, tcfg, jws, tws = _models(LONG, dt, seed=2)
    rng = np.random.default_rng(81)
    B = 2
    jc = _full_rings(jcfg, 80, B, rng, dt)
    tc = _port_cache(jc, dt, batch=True)
    for i, slot in enumerate(SLOTS[:4]):
        x = _rows(rng, (B, jcfg.input_dim))
        commit = np.array([True, i != 2])
        jc, jy = JSC.fused_cached_batch(
            jws, jc, jnp.asarray(x), jnp.asarray(slot, jnp.int32),
            jnp.asarray(commit), jcfg, rnn_carry=rnn_carry, b_tile=2,
            interpret=True)
        _, ty = TSC.fused_cached_batch(tws, tc, torch.as_tensor(x), slot,
                                       torch.as_tensor(commit), tcfg,
                                       rnn_carry=rnn_carry)
        np.testing.assert_allclose(ty.numpy()[commit],
                                   np.asarray(jy)[commit], atol=ATOL[dt],
                                   rtol=0, err_msg=f"slot {slot}")
        _assert_cache(tc, jc, ATOL[dt], f"slot {slot}")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_k7_k8_plain_match_pallas_with_heads_128_wide(dt):
    """K7 and K8 (replay) with two heads of 128 on rings of 8 slots."""
    jcfg, tcfg, jws, tws = _models(WIDE, dt, seed=3)
    rng = np.random.default_rng(128)
    jc = _full_rings(jcfg, 8, None, rng, dt)
    tc = _port_cache(jc, dt, batch=False)
    x = _rows(rng, (jcfg.input_dim,))
    jc, jy = JSC.fused_cached_forward_step(
        jws, jc, jnp.asarray(x), jnp.asarray(5, jnp.int32),
        jnp.asarray(True), jcfg, rnn_carry=False, interpret=True)
    _, ty = TSC.fused_cached_step_slot(tws, tc, torch.as_tensor(x), 5, True,
                                       tcfg, rnn_carry=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL[dt],
                               rtol=0)
    jb = _full_rings(jcfg, 8, 2, rng, dt)
    tb = TSC.cache_init(tcfg, 8, device="cpu", batch=2)
    for n in LEAVES:
        getattr(tb, n).copy_(torch.as_tensor(_np(getattr(jb, n)).copy()))
    xb = _rows(rng, (2, jcfg.input_dim))
    commit = np.array([True, True])
    jb, jyb = JSC.fused_cached_batch(
        jws, jb, jnp.asarray(xb), jnp.asarray(6, jnp.int32),
        jnp.asarray(commit), jcfg, rnn_carry=False, b_tile=2,
        interpret=True)
    _, tyb = TSC.fused_cached_batch(tws, tb, torch.as_tensor(xb), 6,
                                    torch.as_tensor(commit), tcfg,
                                    rnn_carry=False)
    np.testing.assert_allclose(tyb.numpy(), np.asarray(jyb), atol=ATOL[dt],
                               rtol=0)


class _FakeLib:
    """A stand-in for a built library: every launch returns -2 (too little
    shared memory), the *_smem_bytes entry points a size."""

    def __init__(self, need):
        self.need, self.calls = need, []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append(name)
            if name.endswith("_smem_bytes"):
                return self.need
            if name.endswith("_scratch_floats") or name.endswith("_bytes"):
                return 64
            return -2
        return call


class _Props:
    shared_memory_per_block_optin = 232448


def _fake_cuda(monkeypatch, need):
    fake = _FakeLib(need)
    monkeypatch.setattr(K, "lib", lambda name, sig: fake)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props())
    return fake


def test_refusal_comes_from_the_launch_and_states_the_bytes(monkeypatch):
    """The wrappers hold no row, slot or head limit of their own: T 256, W
    256 and heads 128 wide reach the launch, and a launch that finds too
    little shared memory raises with the bytes the kernel's *_smem_bytes
    gives and the bytes a block has."""
    fake = _fake_cuda(monkeypatch, 300000)
    cfg = TM.ModelConfig(**WIDE)
    err = r"need 300000 bytes of shared memory a block, more than the 232448"
    with pytest.raises(ValueError, match=err) as e:
        TFF.check_launch(TFF._ERR_SMEM, "fused_forward", cfg, "T=256, ",
                         lambda: TFF.smem_bytes(fake,
                                                "fused_forward_smem_bytes"),
                         "cpu")
    assert "T=256" in str(e.value) and "(2 heads)" in str(e.value)
    with pytest.raises(ValueError, match="refused the shape"):
        TFF.check_launch(TFF._ERR_SHAPE, "fused_forward", cfg, "", None,
                         "cpu")
    assert not hasattr(TFF, "MAX_T") and not hasattr(TFF, "MAX_HEAD_DIM")
    assert not hasattr(TSC, "MAX_WINDOW")
    assert TFF.MAX_LAYERS == 8


@pytest.mark.parametrize("kernel", ["K4", "K7", "K8", "K9"])
def test_wrappers_reach_the_launch_past_the_old_limits(monkeypatch, kernel):
    """T 256 (K4, K9), W 256 (K7, K8) at heads 128 wide: the wrapper's
    checks pass, the (fake) launch refuses, and the message states the
    kernel's own bytes."""
    cfg = TM.ModelConfig(**WIDE)
    model = TM.TIPModel(cfg, device="cpu")
    ws = model.packed_weights(torch.float32)
    fake = _fake_cuda(monkeypatch, 250000)
    monkeypatch.setattr(K, "check_input", lambda *a, **k: None)
    monkeypatch.setattr(K, "stream_of", lambda dev: 0)
    monkeypatch.setattr(TFF, "check_packed", lambda *a: None)
    monkeypatch.setattr(TFF, "tile_major",
                        lambda *a: torch.zeros(4, dtype=torch.uint8))

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    with pytest.raises(ValueError, match="need 250000 bytes"):
        if kernel == "K4":
            TFF._launch(ws, torch.zeros(256, cfg.input_dim), 255, cfg,
                        "fused_forward_last")
        elif kernel == "K9":
            TFF._launch_batch(ws, torch.zeros(2, 256, cfg.input_dim),
                              torch.zeros(2, dtype=torch.int32), cfg)
        elif kernel == "K7":
            c = TSC.cache_init(cfg, 256, device="cpu")
            monkeypatch.setattr(TSC, "_check_cache", lambda *a: 256)
            TSC._launch(ws, c, torch.zeros(cfg.input_dim), 5, True, cfg,
                        False)
        else:
            c = TSC.cache_init(cfg, 256, device="cpu", batch=2)
            TSC._launch_batch(ws, c, torch.zeros(2, cfg.input_dim), 5,
                              torch.ones(2, dtype=torch.bool), cfg, False)
    assert any(n.endswith("_smem_bytes") for n in fake.calls)
