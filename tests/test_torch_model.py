"""The port's TIP model (tip_tpu_torch.models.tip_model) against tip_tpu's.

Weights cross from tip_tpu's param pytree through ``params_from_jax``; the
inputs are made from a seed with numpy. In float64 the full-width forward
agrees to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu_torch.models import tip_model as TM

torch.set_num_threads(1)

TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)


def _jax_params(cfg, seed=0):
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float64),
        JM.init_params(jax.random.PRNGKey(seed), cfg))


def _port(cfg_kw, params):
    model = TM.TIPModel(TM.ModelConfig(**cfg_kw), device="cpu",
                        dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(params))
    return model


def _inputs(rng, cfg, B, T):
    x_imu = rng.normal(size=(B, T, 90))
    x_s = rng.normal(size=(B, T, cfg.size_s))
    return x_imu, x_s


def _run_both(cfg_kw, params, x_imu, x_s):
    j = JM.forward(params, jnp.asarray(x_imu), jnp.asarray(x_s),
                   JM.ModelConfig(**cfg_kw))
    with torch.no_grad():
        t = _port(cfg_kw, params)(torch.as_tensor(x_imu),
                                  torch.as_tensor(x_s))
    return t.numpy(), np.asarray(j)


def test_full_width_forward_matches_tip_tpu():
    """ModelConfig() defaults (d 256, 16 heads, ff 1024, 4 layers, RNN 512),
    B=2, T=40."""
    cfg = JM.ModelConfig()
    params = _jax_params(cfg)
    x_imu, x_s = _inputs(np.random.default_rng(0), cfg, 2, 40)
    t, j = _run_both({}, params, x_imu, x_s)
    assert t.shape == (2, 40, 131)
    np.testing.assert_allclose(t, j, atol=1e-10, rtol=0)


@pytest.mark.parametrize("rnn_impl", ["auto", "plain"])
def test_tiny_forward_nan_history_matches_tip_tpu(rnn_impl):
    """NaN history entries are zeroed and the root-velocity channels
    108:111 ignored, as in tip_tpu."""
    cfg = JM.ModelConfig(**TINY)
    params = _jax_params(cfg, seed=1)
    rng = np.random.default_rng(1)
    x_imu, x_s = _inputs(rng, cfg, 3, 40)
    x_s[rng.random(x_s.shape) < 0.1] = np.nan
    t, j = _run_both(dict(TINY, rnn_impl=rnn_impl), params, x_imu, x_s)
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, atol=1e-12, rtol=0)
    # channels 108:111 of the history do not reach the output
    x_s2 = x_s.copy()
    x_s2[..., 108:111] = rng.normal(size=x_s2[..., 108:111].shape)
    t2, _ = _run_both(dict(TINY, rnn_impl=rnn_impl), params, x_imu, x_s2)
    np.testing.assert_array_equal(t2, t)


@pytest.mark.parametrize("cd", ["bfloat16", "float32", None])
def test_plain_forward_compute_dtype_matches_tip_tpu(cd):
    """With compute_dtype set the plain forward casts float32 parameters
    and inputs to it, computes there and answers in the inputs' dtype, as
    tip_tpu's forward does (bf16: 2e-2, the two frameworks round at other
    places); float32 and None leave a float32 model's forward bit for bit
    as it was. Both run the plain layer loop (tip_tpu's default "xla",
    the port's "plain"): the encoder kernel's route takes float32 only."""
    plain = dict(TINY, encoder_impl="plain")
    kw = dict(plain, compute_dtype=cd)
    cfg = JM.ModelConfig(**dict(TINY, compute_dtype=cd))
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32),
        JM.init_params(jax.random.PRNGKey(6), cfg))
    rng = np.random.default_rng(6)
    x_imu, x_s = (a.astype(np.float32) for a in _inputs(rng, cfg, 2, 12))
    j = JM.forward(params, jnp.asarray(x_imu), jnp.asarray(x_s), cfg)
    model = TM.TIPModel(TM.ModelConfig(**kw), device="cpu")
    model.load_state_dict(TM.params_from_jax(params))
    own = TM.TIPModel(TM.ModelConfig(**plain), device="cpu")
    own.load_state_dict(model.state_dict())
    with torch.no_grad():
        t = model(torch.as_tensor(x_imu), torch.as_tensor(x_s))
        t_own = own(torch.as_tensor(x_imu), torch.as_tensor(x_s))
    assert t.dtype == torch.float32 and j.dtype == jnp.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j),
                               atol=2e-2 if cd == "bfloat16" else 1e-5,
                               rtol=0)
    if cd == "bfloat16":
        assert not torch.equal(t, t_own)          # it did compute in bf16
        assert model.params_as()["out.w"].dtype == torch.bfloat16
        assert model.params_as() is model.params_as()     # cast once
    else:
        assert torch.equal(t, t_own)


@pytest.mark.parametrize("k", [1, 7, 40])
def test_left_aligned_padding_equals_short_window(k):
    """Output at the last valid row of a zero-padded 40-frame window equals
    the output of the k-frame window itself (causal attention, RNN from
    zero) — the runner's recompute mode relies on it."""
    cfg = JM.ModelConfig(**TINY)
    params = _jax_params(cfg, seed=2)
    x_imu, x_s = _inputs(np.random.default_rng(2), cfg, 1, k)
    pad_imu = np.zeros((1, 40, 90))
    pad_s = np.zeros((1, 40, cfg.size_s))
    pad_imu[:, :k], pad_s[:, :k] = x_imu, x_s
    t_pad, j_pad = _run_both(TINY, params, pad_imu, pad_s)
    t_short, _ = _run_both(TINY, params, x_imu, x_s)
    np.testing.assert_allclose(t_pad[0, k - 1], t_short[0, k - 1],
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(t_pad, j_pad, atol=1e-12, rtol=0)


def _reference_state_dict(rng, cfg):
    """A synthetic reference ``TF_RNN_Past_State.state_dict()`` (torch
    layouts: Linear (out, in), q/k/v packed row-wise)."""
    d, H = cfg.tf_in_dim, cfg.rnn_hid_size
    sd = {"in_linear.weight": rng.normal(size=(d, cfg.input_dim)),
          "in_linear.bias": rng.normal(size=d),
          "linear.weight": rng.normal(size=(cfg.size_s, H)),
          "linear.bias": rng.normal(size=cfg.size_s),
          "rnn.weight_ih_l0": rng.normal(size=(H, d)),
          "rnn.weight_hh_l0": rng.normal(size=(H, H)),
          "rnn.bias_ih_l0": rng.normal(size=H),
          "rnn.bias_hh_l0": rng.normal(size=H)}
    for i in range(cfg.tf_layers):
        p = f"tf_encode.layers.{i}."
        sd[p + "self_attn.in_proj_weight"] = rng.normal(size=(3 * d, d))
        sd[p + "self_attn.in_proj_bias"] = rng.normal(size=3 * d)
        sd[p + "self_attn.out_proj.weight"] = rng.normal(size=(d, d))
        sd[p + "self_attn.out_proj.bias"] = rng.normal(size=d)
        sd[p + "linear1.weight"] = rng.normal(size=(cfg.tf_hid_size, d))
        sd[p + "linear1.bias"] = rng.normal(size=cfg.tf_hid_size)
        sd[p + "linear2.weight"] = rng.normal(size=(d, cfg.tf_hid_size))
        sd[p + "linear2.bias"] = rng.normal(size=d)
        for n in ("norm1", "norm2"):
            sd[p + n + ".weight"] = rng.normal(size=d)
            sd[p + n + ".bias"] = rng.normal(size=d)
    return {k: torch.as_tensor(v) for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["", "module."])
def test_params_from_torch_state_dict_matches_tip_tpu(prefix):
    cfg_kw = TINY
    rng = np.random.default_rng(3)
    sd = _reference_state_dict(rng, JM.ModelConfig(**cfg_kw))
    sd = {prefix + k: v for k, v in sd.items()}
    j = JM.params_from_torch_state_dict(sd, JM.ModelConfig(**cfg_kw),
                                        dtype=jnp.float64)
    t = TM.params_from_torch_state_dict(sd, TM.ModelConfig(**cfg_kw),
                                        dtype=torch.float64)
    j_flat = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, j))
    assert sorted(t) == sorted(j_flat)
    for k in t:
        np.testing.assert_array_equal(t[k].numpy(), j_flat[k].numpy(),
                                      err_msg=k)
    model = TM.TIPModel(TM.ModelConfig(**cfg_kw), device="cpu",
                        dtype=torch.float64)
    model.load_state_dict(t)               # every key, every shape


def test_init_params_distributions():
    """init_params draws the tip_tpu/torch distributions: U(±1/√fan_in)
    linears, xavier-uniform q/k/v, zero q/k/v biases, LayerNorm ones and
    zeros; the keys are exactly the module's."""
    cfg = TM.ModelConfig()
    sd = TM.init_params(cfg, torch.Generator().manual_seed(0))
    model = TM.TIPModel(TM.ModelConfig(**TINY), device="cpu")
    assert set(TM.init_params(model.cfg, torch.Generator())) == \
        set(model.state_dict())
    d = cfg.tf_in_dim
    assert sd["in_linear.w"].abs().max() <= 1 / np.sqrt(cfg.input_dim)
    assert sd["in_linear.w"].abs().max() > 0.9 / np.sqrt(cfg.input_dim)
    xb = np.sqrt(6.0 / (2 * d))
    assert 0.9 * xb < sd["layers.0.w_q"].abs().max() <= xb
    assert (sd["layers.3.b_v"] == 0).all()
    assert (sd["layers.1.ln2_s"] == 1).all()
    assert sd["rnn.w_hh"].abs().max() <= 1 / np.sqrt(cfg.rnn_hid_size)
    again = TM.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_head_interleave_perm_matches_tip_tpu():
    for kw in ({}, TINY):
        np.testing.assert_array_equal(
            TM.head_interleave_perm(TM.ModelConfig(**kw)),
            JM.head_interleave_perm(JM.ModelConfig(**kw)))


def test_causal_mask_matches_tip_tpu():
    np.testing.assert_array_equal(
        TM.causal_mask(7, torch.float64).numpy(),
        np.asarray(JM.causal_mask(7, jnp.float64)))


def test_unported_modes_raise():
    """tip_tpu's rng dropout is ported: the model builds, its training
    forward without a generator is deterministic, and it refuses hash seeds
    (tests/test_torch_dropout.py holds its masks); forward_impl="fused" is:
    the model builds, and its own forward stays the plain one."""
    rng = TM.TIPModel(TM.ModelConfig(**TINY, dropout_impl="rng"),
                      device="cpu")
    x = torch.zeros(1, 4, 90)
    with torch.no_grad():
        assert torch.equal(rng(x, torch.ones(1, 4, 131), train=True),
                           rng(x, torch.ones(1, 4, 131), train=True))
        with pytest.raises(TypeError, match="Generator"):
            rng(x, torch.ones(1, 4, 131), train=True, seeds=(1, [2, 3]))
    model = TM.TIPModel(TM.ModelConfig(**TINY, forward_impl="fused"),
                        device="cpu")
    plain = TM.TIPModel(TM.ModelConfig(**TINY), device="cpu")
    plain.load_state_dict(model.state_dict())
    x = torch.zeros(1, 4, 90)
    with torch.no_grad():
        assert torch.equal(model(x, torch.ones(1, 4, 131), train=True),
                           model(x, torch.ones(1, 4, 131), train=True))
    with torch.no_grad():
        assert torch.equal(model(x, torch.ones(1, 4, 131)),
                           plain(x, torch.ones(1, 4, 131)))


@pytest.mark.parametrize("kw", [dict(forward_impl="xla"),
                                dict(compute_dtype="float16"),
                                dict(dropout_impl="bernoulli"),
                                dict(encoder_impl="pallas")])
def test_model_config_rejects_unknown_values(kw):
    with pytest.raises(ValueError):
        TM.ModelConfig(**kw)


def test_packed_weights_cached_until_the_parameters_change():
    model = TM.TIPModel(TM.ModelConfig(**TINY, forward_impl="fused"),
                        device="cpu")
    a = model.packed_weights(torch.float32)
    assert model.packed_weights(torch.float32) is a
    b = model.packed_weights(torch.bfloat16)
    assert b[0].dtype == torch.bfloat16 and a[0].dtype == torch.float32
    assert model.packed_weights(torch.float32) is a       # one per dtype
    # load_state_dict writes in place: the pack is made again, new values
    sd = {k: v + 1.0 for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    c = model.packed_weights(torch.float32)
    assert c is not a
    assert torch.equal(c[-1], sd["out.b"])
    assert model.packed_weights(torch.float32) is c
    # .to() replaces the storage
    model.to(torch.float64)
    d = model.packed_weights(torch.float32)
    assert d is not c and d[0].dtype == torch.float32
    # an in-place write to one parameter
    with torch.no_grad():
        model.out.b.zero_()
    assert torch.equal(model.packed_weights(torch.float32)[-1],
                       torch.zeros(131))
