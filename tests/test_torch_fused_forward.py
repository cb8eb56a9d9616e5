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
    # x, qkv, att, the pre-norm sum, ff, the RNN input and the walk's
    # (value, step) pairs, two floats each
    assert TFF.scratch_floats(40, TM.ModelConfig()) == 40 * (6 * 256 + 1024
                                                             + 3 * 512)


def test_phase_split_reads_k4s_clock_rows():
    """K4's and K5's per-phase clock rows split under ``K4_PHASES``: each
    kind named as csrc/fused_forward.cu numbers it, the walk (no arrivals,
    no barrier) counted whole, barriers and the first-to-last arrival
    summed apart, rows after the last end not read."""
    assert TFF.K4_PHASES == ("start", "in_proj", "qkv", "attention",
                             "attn_out", "ln1", "ff1", "ff2", "ln2", "w_ih",
                             "rnn", "out_proj")
    big = 2 ** 62
    rows = [[1_000_000, big, 0, 0],
            [1_010_000, 1_002_000, 1_008_000, 1],     # in_proj
            [1_020_000, 1_012_000, 1_018_000, 2],     # qkv
            [1_030_000, 1_022_000, 1_027_000, 3],     # attention
            [1_040_000, 1_032_000, 1_036_000, 4],     # attn_out
            [1_050_000, 1_042_000, 1_047_000, 6],     # ff1
            [1_060_000, 1_051_000, 1_058_000, 7],     # ff2
            [1_070_000, 1_062_000, 1_068_000, 9],     # w_ih
            [1_110_000, big, 0, 10],                  # the walk
            [1_115_000, 1_112_000, 1_114_000, 11],    # out_proj
            [0, big, 0, 0], [5, 5, 5, 5]]
    split, n = TFF.phase_split(rows, TFF.K4_PHASES)
    assert n == 9
    assert set(split) == set(TFF.K4_PHASES[1:]) | {"barrier", "imbalance",
                                                   "total"}
    assert split["in_proj"] == pytest.approx(0.008)
    assert split["ff2"] == pytest.approx(0.008)
    assert split["rnn"] == pytest.approx(0.04)
    assert split["out_proj"] == pytest.approx(0.004)
    assert split["ln1"] == split["ln2"] == 0.0        # folded into staging
    assert split["barrier"] == pytest.approx(
        0.002 + 0.002 + 0.003 + 0.004 + 0.003 + 0.002 + 0.002 + 0.001)
    assert split["imbalance"] == pytest.approx(
        0.006 + 0.006 + 0.005 + 0.004 + 0.005 + 0.007 + 0.006 + 0.002)
    assert split["total"] == pytest.approx(0.115)
    assert sum(split[k] for k in TFF.K4_PHASES[1:]) + split["barrier"] \
        == pytest.approx(split["total"])


def test_checked_packed_list_still_raises_after_a_good_list_passed():
    """``check_packed`` checks a list once and then knows it by its tensors
    (K4's, K5's and K7's wrappers call it every launch): the same list
    passes again and gives the same pointer array, and a wrong dtype, a
    wrong count or a replaced tensor is checked again and raises."""
    _, sd = _params(8)
    cpu = torch.device("cpu")
    ws = TFF.pack_weights(sd, TCFG, dtype=torch.float32)
    first = TFF.check_packed(ws, TCFG, cpu, "fused_forward_last")
    assert [p for p in first] == [t.data_ptr() for t in ws]
    assert TFF.check_packed(ws, TCFG, cpu, "fused_forward_last") is first
    # another dtype in place of one tensor of the same list
    good = ws[4]
    ws[4] = good.to(torch.bfloat16)
    with pytest.raises(TypeError, match="packed_ws\\[4\\]"):
        TFF.check_packed(ws, TCFG, cpu, "fused_forward_last")
    # a replaced tensor of the right dtype but another shape
    ws[4] = torch.zeros(good.numel() + 1)
    with pytest.raises(ValueError, match="packed_ws\\[4\\]"):
        TFF.check_packed(ws, TCFG, cpu, "fused_forward_last")
    ws[4] = good
    assert [p for p in TFF.check_packed(ws, TCFG, cpu, "x")] == \
        [t.data_ptr() for t in ws]
    # a wrong count, and a tensor on another device
    with pytest.raises(ValueError, match="packed weights"):
        TFF.check_packed(ws[:-1], TCFG, cpu, "fused_forward_last")
    meta = list(ws)
    meta[0] = ws[0].to("meta")
    with pytest.raises(ValueError, match="packed_ws\\[0\\]"):
        TFF.check_packed(meta, TCFG, cpu, "fused_forward_last")
    # the list itself on another device than the one asked for
    with pytest.raises(ValueError, match="packed_ws\\[0\\]"):
        TFF.check_packed(ws, TCFG, torch.device("meta"), "fused_forward_last")
