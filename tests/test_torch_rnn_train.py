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


@pytest.mark.parametrize("B,T,H", [(256, 40, 512), (1, 40, 512), (3, 7, 40),
                                   (17, 40, 512), (64, 40, 256),
                                   (1000, 40, 512), (2, 5, 4)])
def test_fused_rnn_bwd_plan_fits_and_covers_every_row(B, T, H):
    """K10's plan: the walk's cluster of 8 blocks covers H with 32 or 64
    columns each (64 only above 256), its slice and row buffers fit in a
    block's shared memory, the clusters' tiles cover every batch row once
    and B <= 256 takes at most the H100's 132 SMs; dW's splits are whole
    32-row slices that cover the B T rows once."""
    plan = FR.fused_rnn_bwd_plan(B, T, H)
    walk = plan.walk
    assert walk.cluster == 8
    assert walk.cols == (64 if H > 256 else 32)
    assert walk.cluster * walk.cols >= H
    assert walk.smem_bytes <= FR.MAX_SMEM
    tiles = [range(i * walk.batch_tile, min(B, (i + 1) * walk.batch_tile))
             for i in range(walk.clusters)]
    assert [r for rows in tiles for r in rows] == list(range(B))
    assert all(len(rows) > 0 for rows in tiles)
    if B <= 256:
        assert walk.cluster * walk.clusters <= 132
    rows = B * T
    assert plan.dw_rows % 32 == 0
    assert plan.dw_rows * plan.dw_splits >= rows
    assert plan.dw_rows * (plan.dw_splits - 1) < rows
    if rows <= 256:
        assert plan.dw_splits == 1


def test_fused_rnn_bwd_plan_at_the_training_shape():
    """(256, 40, 512): K1's walk plan (16 clusters of 16 rows, 229,376
    bytes a block), dW in 17 splits of 608 rows (17 x 16 tiles of 128 x
    128: about two blocks an SM)."""
    plan = FR.fused_rnn_bwd_plan(256, 40, 512)
    assert plan.walk == FR.fused_rnn_plan(256, 512)
    assert (plan.walk.batch_tile, plan.walk.clusters,
            plan.walk.smem_bytes) == (16, 16, 229376)
    assert (plan.dw_rows, plan.dw_splits) == (608, 17)


@pytest.mark.parametrize("H", [1024, 2048, 516, 42, 0])
def test_fused_rnn_bwd_plan_raises_where_the_slice_cannot_fit(H):
    """H 1024 and 2048 (W's f32 slice alone is past a block's shared
    memory) and 0 raise, naming the bytes; H 516 (96 columns a block, the
    tile shrunk to fit) and 42 (rows not a multiple of 4: dW's operands
    padded to 44) plan."""
    if H in (516, 42):
        plan = FR.fused_rnn_bwd_plan(4, 40, H)
        walk = plan.walk
        assert walk.cols == FR.block_cols(H) == (96 if H == 516 else 32)
        assert walk.smem_bytes <= FR.MAX_SMEM
        assert walk.batch_tile * walk.clusters >= 4
        assert FR.pad_scratch(4, 40, H, torch.float32) == (
            0 if H == 516 else 2 * 4 * 40 * 44)
        return
    with pytest.raises(ValueError, match="fused_rnn_bwd"):
        FR.fused_rnn_bwd_plan(4, 40, H)
    if H:
        with pytest.raises(ValueError, match=f"{FR.MAX_SMEM} a block"):
            FR.fused_rnn_bwd_plan(4, 40, H)
