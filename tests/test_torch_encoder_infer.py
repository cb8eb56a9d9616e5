"""The inference forward's encoder route (tip_tpu_torch.models.tip_model,
``TIPModel._encoder_layers``) against tip_tpu's forward, float64 on the CPU.

tip_tpu runs its Pallas encoder layer in the inference forward whenever
``encoder_impl="pallas"`` and no custom mask is given (dropout off, seed 0,
batch tiles of 8); its twin here is ``encoder_impl`` "auto" or "kernel"
(K11, whose plain version ``encoder_layer_train_plain`` runs for a CPU
tensor). ``encoder_impl="plain"`` is the twin of tip_tpu's "xla" loop, and
a custom mask takes the plain loop in both packages. Inputs are made from
a seed with numpy; tip_tpu's Pallas layer runs in interpret mode.
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
T = 10
TOL = 1e-9


def _params(seed=0):
    import jax
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float64),
        JM.init_params(jax.random.PRNGKey(seed), JM.ModelConfig(**TINY)))


def _inputs(B, seed=1):
    cfg = JM.ModelConfig(**TINY)
    rng = np.random.default_rng(seed)
    x_imu = rng.normal(size=(B, T, cfg.input_dim - cfg.size_s))
    x_s = rng.normal(size=(B, T, cfg.size_s))
    x_s[:, ::3, 5] = np.nan                   # the NaN quirk
    return x_imu, x_s


def _port(params, **kw):
    model = TM.TIPModel(TM.ModelConfig(**TINY, **kw), device="cpu",
                        dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(params))
    return model


def _jax(params, x_imu, x_s, impl, mask=None):
    return np.asarray(JM.forward(params, jnp.asarray(x_imu),
                                 jnp.asarray(x_s),
                                 JM.ModelConfig(**TINY, encoder_impl=impl),
                                 mask=None if mask is None
                                 else jnp.asarray(mask)))


class _Calls:
    """Counts the calls of one of tip_model's encoder-layer entry points and
    records whether any tensor it was handed requires grad."""

    def __init__(self, monkeypatch, name):
        self.n, self.grad = 0, False
        fn = getattr(TM, name)

        def counted(x, ws, *a, **kw):
            self.n += 1
            self.grad |= x.requires_grad or any(w.requires_grad for w in ws)
            return fn(x, ws, *a, **kw)

        monkeypatch.setattr(TM, name, counted)


@pytest.mark.parametrize("B", [1, 4, 16])
def test_auto_route_matches_tip_tpu_pallas_layer(B, monkeypatch):
    """encoder_impl="auto" on a CPU tensor: each layer through K11's plain
    version, equal to tip_tpu's forward with its Pallas layer (B 16: two
    batch tiles of 8; B 1: a tile of 1)."""
    params = _params()
    x_imu, x_s = _inputs(B)
    calls = _Calls(monkeypatch, "encoder_layer_fwd")
    with torch.no_grad():
        t = _port(params)(torch.as_tensor(x_imu), torch.as_tensor(x_s))
    assert calls.n == TINY["tf_layers"] and not calls.grad
    j = _jax(params, x_imu, x_s, "pallas")
    np.testing.assert_allclose(t.numpy(), j, atol=TOL, rtol=0)


def test_plain_impl_matches_tip_tpu_xla_loop(monkeypatch):
    params = _params(2)
    x_imu, x_s = _inputs(3, seed=2)
    calls = _Calls(monkeypatch, "encoder_layer_fwd")
    with torch.no_grad():
        t = _port(params, encoder_impl="plain")(torch.as_tensor(x_imu),
                                                torch.as_tensor(x_s))
    assert calls.n == 0
    np.testing.assert_allclose(t.numpy(), _jax(params, x_imu, x_s, "xla"),
                               atol=TOL, rtol=0)


def test_custom_mask_takes_the_plain_loop(monkeypatch):
    """A custom mask (here: attend to the previous 4 rows only) keeps the
    plain loop in both packages, whatever encoder_impl says."""
    params = _params(3)
    x_imu, x_s = _inputs(4, seed=3)
    i, j = np.arange(T)[:, None], np.arange(T)[None, :]
    mask = np.where((j > i) | (j < i - 3), -np.inf, 0.0)
    calls = _Calls(monkeypatch, "encoder_layer_fwd")
    with torch.no_grad():
        t = _port(params, encoder_impl="auto")(
            torch.as_tensor(x_imu), torch.as_tensor(x_s),
            mask=torch.as_tensor(mask))
    assert calls.n == 0
    np.testing.assert_allclose(t.numpy(),
                               _jax(params, x_imu, x_s, "pallas", mask),
                               atol=TOL, rtol=0)


def test_grad_through_the_route_equals_the_plain_loop(monkeypatch):
    """With grad on and weights that require it the route takes the
    differentiable layer (K11 forward, K12 backward: their plain versions
    here); every parameter's gradient equals the plain loop's. Under
    no_grad the same model hands the layer detached tensors."""
    params = _params(4)
    x_imu, x_s = _inputs(4, seed=4)
    tgt = torch.as_tensor(np.random.default_rng(5).normal(
        size=(4, T, JM.ModelConfig(**TINY).size_s)))
    calls = _Calls(monkeypatch, "encoder_layer_train")
    grads, models = {}, {}
    for impl in ("auto", "plain"):
        model = models[impl] = _port(params,
                                     encoder_impl=impl).requires_grad_(True)
        out = model(torch.as_tensor(x_imu), torch.as_tensor(x_s))
        torch.sum((out - tgt) ** 2).backward()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
    assert calls.n == TINY["tf_layers"] and calls.grad
    for k, g in grads["plain"].items():
        scale = max(1.0, g.abs().max().item())
        assert (grads["auto"][k] - g).abs().max().item() <= TOL * scale, k
    fwd = _Calls(monkeypatch, "encoder_layer_fwd")
    with torch.no_grad():
        models["auto"](torch.as_tensor(x_imu), torch.as_tensor(x_s))
    assert fwd.n == TINY["tf_layers"] and not fwd.grad


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_bf16_compute_dtype_on_the_route_raises(impl):
    """compute_dtype="bfloat16" on the route: "auto" runs K11's bf16 plain
    version on a CPU tensor and matches tip_tpu's forward with its Pallas
    layer in bf16 (1e-2: bf16 products outside the layer sum in another
    order; tests/test_torch_bf16_route.py holds the rest of the bf16
    route); "kernel" on a CPU tensor raises, as in float32.
    encoder_impl="plain" keeps the bf16 plain loop."""
    params = _params(7)
    x_imu, x_s = _inputs(2, seed=7)
    x_imu, x_s = x_imu.astype(np.float32), x_s.astype(np.float32)
    model = _port(params, compute_dtype="bfloat16",
                  encoder_impl=impl).float()
    x_imu_t, x_s_t = torch.as_tensor(x_imu), torch.as_tensor(x_s)
    if impl == "kernel":
        with pytest.raises(ValueError, match="CUDA"):
            model(x_imu_t, x_s_t)
    else:
        with torch.no_grad():
            t = model(x_imu_t, x_s_t)
        j = np.asarray(JM.forward(
            jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32),
                                   params),
            jnp.asarray(x_imu), jnp.asarray(x_s),
            JM.ModelConfig(**TINY, compute_dtype="bfloat16",
                           encoder_impl="pallas")))
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), j, atol=1e-2, rtol=0)
    plain = TM.TIPModel(TM.ModelConfig(**TINY, compute_dtype="bfloat16",
                                       encoder_impl="plain"), device="cpu")
    assert torch.isfinite(plain(x_imu_t, x_s_t)).all()


def test_kernel_impl_on_a_cpu_tensor_raises():
    model = TM.TIPModel(TM.ModelConfig(**TINY, encoder_impl="kernel"),
                        device="cpu")
    x_imu, x_s = (torch.as_tensor(a, dtype=torch.float32)
                  for a in _inputs(2))
    with pytest.raises(ValueError, match="CUDA"):
        model(x_imu, x_s)
