"""The differentiable RNN head (tip_tpu_torch.ops.fused_rnn.fused_rnn_train,
the plain version of K10) against tip_tpu's Pallas BPTT kernel in interpret
mode, float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.ops import pallas_kernels as PK
from tip_tpu_torch.ops import fused_rnn as FR

torch.set_num_threads(1)


def _inputs(B=3, T=9, H=24, seed=0):
    rng = np.random.default_rng(seed)
    xin = rng.normal(size=(B, T, H)) * 0.7
    w = rng.normal(size=(H, H)) / np.sqrt(H)
    g = rng.normal(size=(B, T, H))
    return xin, w, g


@pytest.mark.parametrize("shape", [(3, 9, 24), (1, 40, 32), (16, 10, 32)])
def test_bwd_plain_matches_pallas_rnn_bwd(shape):
    xin, w, g = _inputs(*shape)
    hs = PK.fused_rnn(jnp.asarray(xin), jnp.asarray(w), interpret=True)
    dx_j, dw_j = PK._rnn_bwd(hs, jnp.asarray(w), jnp.asarray(g), True)
    dx_t, dw_t = FR.fused_rnn_bwd_plain(torch.as_tensor(np.array(hs)),
                                        torch.as_tensor(w),
                                        torch.as_tensor(g))
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(dw_t.numpy(), np.asarray(dw_j), atol=1e-12,
                               rtol=0)


def test_fused_rnn_train_gradients_match_jax_grad():
    xin, w, g = _inputs(4, 11, 20, seed=1)

    def loss(x, w):
        return jnp.sum(PK.fused_rnn_train(x, w, True) * jnp.asarray(g))

    gx_j, gw_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xin),
                                                jnp.asarray(w))
    x_t = torch.tensor(xin, requires_grad=True)
    w_t = torch.tensor(w, requires_grad=True)
    hs = FR.fused_rnn_train(x_t, w_t)
    np.testing.assert_allclose(
        hs.detach().numpy(),
        np.asarray(PK.fused_rnn(jnp.asarray(xin), jnp.asarray(w),
                                interpret=True)), atol=1e-13, rtol=0)
    torch.sum(hs * torch.as_tensor(g)).backward()
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(gx_j),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(gw_j),
                               atol=1e-12, rtol=0)


def test_kernel_impl_on_a_cpu_tensor_raises():
    xin, w, g = (torch.as_tensor(a) for a in _inputs())
    with pytest.raises(ValueError, match="CUDA"):
        FR.fused_rnn_bwd(xin, w, g, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        FR.fused_rnn_train(xin.clone().requires_grad_(True), w,
                           impl="kernel")


def test_plain_impl_equals_auto_on_the_cpu():
    xin, w, g = (torch.as_tensor(a) for a in _inputs(seed=2))
    a = FR.fused_rnn_bwd(xin, w, g, impl="auto")
    b = FR.fused_rnn_bwd(xin, w, g, impl="plain")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
