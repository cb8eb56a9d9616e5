"""The port's whole-model fused forward (tip_tpu_torch.ops.fused_forward)
against tip_tpu's Pallas kernels run in interpret mode, at a small size.

``fused_forward_plain`` / ``fused_forward_last_plain`` are what the
wrappers run for CPU tensors and what chip_smoke.py holds kernels K4 and K5
against on the card. They repeat the Pallas kernels' arithmetic cast by
cast, so both packing dtypes agree to float32 summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.ops import fused_forward as JFF
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import fused_forward as TFF

torch.set_num_threads(1)

TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
JCFG = JM.ModelConfig(**TINY)
TCFG = TM.ModelConfig(**TINY)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# Both sides take exact products of the same rounded values and sum them in
# float32, in another order: 1e-5 covers that for f32 packing. With bf16
# packing a sum that lands on the other side of a rounding boundary moves
# an activation by one bf16 step (2^-8 relative) before it is multiplied
# on, hence 2e-3 on outputs of order 1.
ATOL = {"f32": 1e-5, "bf16": 2e-3}


def _params(seed):
    params = JM.init_params(jax.random.PRNGKey(seed), JCFG)
    sd = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return params, sd


def _window(rng, T):
    """A window with NaN history entries and non-zero root-velocity
    columns, which both sides must zero."""
    x = rng.normal(size=(T, JCFG.input_dim)).astype(np.float32)
    hist = x[:, 90:]
    hist[rng.random(hist.shape) < 0.1] = np.nan
    x[:, 90 + 108:90 + 111] = rng.normal(size=(T, 3)) * 3.0
    return x


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_pack_weights_equals_tip_tpu(dt):
    jd, td = DTYPES[dt]
    params, sd = _params(0)
    jws = JFF.pack_weights(params, JCFG, dtype=jd)
    tws = TFF.pack_weights(sd, TCFG, dtype=td)
    assert len(tws) == len(jws) == TFF.n_packed(TCFG) == 31
    for i, (j, t) in enumerate(zip(jws, tws)):
        assert t.dtype == (torch.float32 if j.dtype == jnp.float32 else td), i
        assert t.is_contiguous()
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(j.astype(jnp.float32)), err_msg=i)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("T", [7, 40])
def test_fused_forward_plain_matches_pallas(dt, T):
    jd, td = DTYPES[dt]
    params, sd = _params(1)
    x = _window(np.random.default_rng(T), T)
    j = JFF.fused_forward(tuple(JFF.pack_weights(params, JCFG, dtype=jd)),
                          jnp.asarray(x), JCFG, interpret=True)
    t = TFF.fused_forward(TFF.pack_weights(sd, TCFG, dtype=td),
                          torch.as_tensor(x), TCFG)
    assert t.shape == (T, 131) and t.dtype == torch.float32
    assert torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL[dt], rtol=0)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fused_forward_last_plain_matches_pallas(dt):
    jd, td = DTYPES[dt]
    params, sd = _params(2)
    T = 10
    x = _window(np.random.default_rng(2), T)
    jws = tuple(JFF.pack_weights(params, JCFG, dtype=jd))
    tws = TFF.pack_weights(sd, TCFG, dtype=td)
    full = TFF.fused_forward_plain(tws, torch.as_tensor(x), TCFG)
    for k in (0, 3, T - 1):
        j = JFF.fused_forward_last(jws, jnp.asarray(x), k, JCFG,
                                   interpret=True)
        t = TFF.fused_forward_last(tws, torch.as_tensor(x), k, TCFG)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL[dt],
                                   rtol=0)
        # one index of the every-index version; a 0-d tensor index too
        np.testing.assert_allclose(t.numpy(), full[k].numpy(),
                                   atol=ATOL[dt], rtol=0)
        t2 = TFF.fused_forward_last_plain(tws, torch.as_tensor(x),
                                          torch.tensor(k, dtype=torch.int32),
                                          TCFG)
        assert torch.equal(t2, t)


def test_root_velocity_columns_do_not_reach_the_output():
    _, sd = _params(3)
    tws = TFF.pack_weights(sd, TCFG, dtype=torch.float32)
    rng = np.random.default_rng(3)
    x = _window(rng, 9)
    x2 = x.copy()
    x2[:, 90 + 108:90 + 111] = 0.0
    a = TFF.fused_forward_plain(tws, torch.as_tensor(x), TCFG)
    b = TFF.fused_forward_plain(tws, torch.as_tensor(x2), TCFG)
    assert torch.equal(a, b)


def test_k_last_outside_the_window_raises_where_tip_tpu_returns_the_bias():
    """A fault of the reference, on record: tip_tpu's fused_forward_last
    with k_last >= T selects no hidden state and returns the bare output
    bias (its runner passes such an index once the window slides). The
    port raises instead."""
    params, sd = _params(4)
    T = 6
    x = _window(np.random.default_rng(4), T)
    jws = tuple(JFF.pack_weights(params, JCFG, dtype=jnp.float32))
    tws = TFF.pack_weights(sd, TCFG, dtype=torch.float32)
    j = JFF.fused_forward_last(jws, jnp.asarray(x), T, JCFG, interpret=True)
    np.testing.assert_array_equal(np.asarray(j),
                                  np.asarray(params["out"]["b"]))
    for k in (T, T + 35, -1):
        with pytest.raises(IndexError, match="outside"):
            TFF.fused_forward_last(tws, torch.as_tensor(x), k, TCFG)
        with pytest.raises(IndexError, match="outside"):
            TFF.fused_forward_last_plain(tws, torch.as_tensor(x), k, TCFG)


def test_fused_matches_the_models_plain_forward():
    """f32 packing is the model's own forward in another order
    (tip_tpu's tests/test_fused_forward.py holds 1e-4 for the same pair)."""
    _, sd = _params(5)
    model = TM.TIPModel(TM.ModelConfig(**TINY, forward_impl="fused",
                                       compute_dtype="float32"), device="cpu")
    model.load_state_dict(sd)
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(16, 221)).astype(np.float32))
    with torch.no_grad():
        ref = model(x[None, :, :90], x[None, :, 90:])[0]
    out = TFF.fused_forward(model.packed_weights(torch.float32), x, model.cfg)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("fn", ["last", "all"])
def test_explicit_fused_on_cpu_raises(fn):
    """The kernel asked for by name on CPU tensors raises, never falls
    back; an unknown impl raises too."""
    _, sd = _params(6)
    tws = TFF.pack_weights(sd, TCFG, dtype=torch.float32)
    x = torch.zeros(5, 221)

    def call(impl):
        if fn == "last":
            return TFF.fused_forward_last(tws, x, 4, TCFG, impl=impl)
        return TFF.fused_forward(tws, x, TCFG, impl=impl)

    with pytest.raises(ValueError, match="CUDA"):
        call("fused")
    with pytest.raises(ValueError, match="auto"):
        call("pallas")
    assert torch.equal(call("auto"), call("plain"))


def test_pack_weights_rejects_other_dtypes_and_counts():
    _, sd = _params(7)
    with pytest.raises(TypeError, match="bfloat16"):
        TFF.pack_weights(sd, TCFG, dtype=torch.float16)
    tws = TFF.pack_weights(sd, TCFG, dtype=torch.float32)
    with pytest.raises(ValueError, match="31"):
        TFF.fused_forward_plain(tws[:-1], torch.zeros(4, 221), TCFG)
    assert TFF.scratch_floats(40, TM.ModelConfig()) == 40 * (6 * 256 + 1024
                                                             + 2 * 512)
