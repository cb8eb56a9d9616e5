"""K1 and K10 at every RNN width that fits a cluster (ROADMAP C12): the
launch plans of the f32 and the bf16 walk at narrow, odd and wide H, the
refusal past a block's shared memory with its bytes, and the plain
versions at H 24 and 384 against tip_tpu's Pallas kernels in interpret
mode. The kernels themselves run only on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.ops import pallas_kernels as PK
from tip_tpu_torch.ops import fused_rnn as FR

torch.set_num_threads(1)
BF = torch.bfloat16
BATCHES = (1, 64, 256)


def _plans(B, H, w_bytes):
    """K1's plan and K10's walk plan (T 40)."""
    return (FR.fused_rnn_plan(B, H, w_bytes),
            FR.fused_rnn_bwd_plan(B, 40, H, w_bytes).walk)


def _check_cover(plan, B, H):
    """Every batch row in one cluster's tile, every column in one block of
    at most 96 columns (H / 8 rounded up to 32), one partial tile at most,
    and the block inside a block's shared memory."""
    cols, bt = plan.cols, plan.batch_tile
    assert cols == FR.block_cols(H) and cols in (32, 64, 96)
    assert plan.cluster * cols >= H and cols - -(-H // 8) < 32
    assert bt * plan.clusters >= B > bt * (plan.clusters - 1)
    assert plan.smem_bytes <= FR.MAX_SMEM and plan.smem_bytes % 16 == 0


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", [20, 24, 42, 128, 384])
def test_f32_walk_plans_every_narrow_and_odd_width(B, H):
    """The f32 walk: the tile of RNN_TILES that holds B in 16 clusters,
    the depth padded to 8 slices of a multiple of 4; H 20 and 24 take one
    block's 32 columns (the other seven idle), H 42 (rows not a multiple of
    16 bytes) two blocks' and H 384 two tiles of 32."""
    for plan in _plans(B, H, 4):
        _check_cover(plan, B, H)
        want = -(-B // FR.RNN_FULL_CLUSTERS)
        assert plan.batch_tile == next(t for t in FR.RNN_TILES if t >= want)
        assert plan.smem_bytes == FR.walk_smem_bytes(H, plan.cols,
                                                     plan.batch_tile)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", [20, 24, 128, 384, 516, 768])
def test_bf16_walk_plans_every_width_up_to_768(B, H):
    """The bf16 walk: depth 512 up to 64 columns a block, 768 at 96 (the
    deep instantiation); its tile the fewest rows that hold B in 15
    clusters, shrunk at H 768 until the row buffers and partial sums fit
    beside W's 147 KB (forward) slice."""
    for back, plan in zip((False, True), _plans(B, H, 2)):
        _check_cover(plan, B, H)
        depth = FR.tc_depth(plan.cols)
        assert depth >= H and depth == (768 if H > 512 else 512)
        assert plan.smem_bytes == FR.tc_smem_bytes(plan.cols,
                                                   plan.batch_tile, back)
        want = FR.tc_batch_tile(B)
        assert plan.batch_tile <= want
        if plan.batch_tile < want:    # the next row would not fit
            assert FR.tc_smem_bytes(plan.cols, plan.batch_tile + 1,
                                    back) > FR.MAX_SMEM
        if H <= 512:
            assert plan.batch_tile == want


def test_bf16_768_shrinks_the_tile_at_b256():
    """bf16 H 768 at B 256: 18 rows a cluster would need 291,840 bytes a
    block (forward), so K1 takes 8 rows (32 clusters, in turns) and K10's
    walk, whose slice is staged (cols, depth + 8), 10."""
    fwd, bwd = _plans(256, 768, 2)
    assert FR.tc_smem_bytes(96, 18, False) == 291840 > FR.MAX_SMEM
    assert (fwd.cols, fwd.batch_tile, fwd.clusters) == (96, 8, 32)
    assert (bwd.cols, bwd.batch_tile, bwd.clusters) == (96, 10, 26)
    assert fwd.smem_bytes == 2 * 768 * 104 + 4 * 8 * 776 + 32 * 8 * 100


def test_f32_516_shrinks_the_tile():
    """f32 H 516: 96 columns a block and a slice of 208,896 bytes leave
    room for 2 rows; B 64 asks for 4 and gets 2 (32 clusters)."""
    plan = FR.fused_rnn_plan(64, 516)
    assert (plan.cols, plan.batch_tile, plan.clusters) == (96, 2, 32)
    assert FR.walk_smem_bytes(516, 96, 4) > FR.MAX_SMEM


@pytest.mark.parametrize("B", BATCHES)
def test_f32_514_unaligned_at_96_columns(B):
    """f32 H 514: 96 columns a block with rows of 2056 bytes (not a
    multiple of 16), the same slice depth (8 x 68) and tile as H 516, and
    K10's dW operands padded to 516."""
    for plan, ref in zip(_plans(B, 514, 4), _plans(B, 516, 4)):
        _check_cover(plan, B, 514)
        assert plan == ref
    assert FR.pad_width(514, 4) == 516
    assert FR.pad_scratch(B, 40, 514, torch.float32) == 2 * B * 40 * 516


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H,w_bytes", [(1024, 4), (768, 4), (1024, 2)])
def test_refusal_states_the_bytes(B, H, w_bytes):
    """Past a block's shared memory both plans refuse, and the message
    gives the bytes one row needs and the bytes a block and a cluster
    hold: f32 H 1024 needs 4 MB of W_hh in a cluster of 1.86 MB."""
    need = (FR.walk_smem_bytes(H, FR.block_cols(H), 1) if w_bytes == 4
            else FR.tc_smem_bytes(FR.block_cols(H), 1, False))
    assert need > FR.MAX_SMEM
    with pytest.raises(ValueError) as e:
        FR.fused_rnn_plan(B, H, w_bytes)
    msg = str(e.value)
    assert f"needs {need} bytes" in msg and f"{FR.MAX_SMEM} a block" in msg
    assert str(8 * FR.MAX_SMEM) in msg
    with pytest.raises(ValueError, match=f"{FR.MAX_SMEM} a block"):
        FR.fused_rnn_bwd_plan(B, 40, H, w_bytes)


@pytest.mark.parametrize("H,dtype", [(20, BF), (24, BF), (42, torch.float32),
                                     (20, torch.float32)])
def test_k10_pads_dw_operands_to_16_byte_rows(H, dtype):
    """Where a row of H is not a multiple of 16 bytes, dW's operands are
    written padded (f32 to a multiple of 4, bf16 of 8) and the bf16 dW is
    planned over the padded width."""
    w_bytes = 2 if dtype == BF else 4
    hp = FR.pad_width(H, w_bytes)
    assert hp % (16 // w_bytes) == 0 and 0 <= hp - H < 16 // w_bytes
    n = FR.pad_scratch(3, 7, H, dtype)
    if hp == H:
        assert n == 0
    elif dtype == BF:
        assert n == 3 * 7 * hp + hp * hp
        plan = FR.fused_rnn_bwd_plan(3, 7, H, 2)
        assert plan == FR.fused_rnn_bwd_plan(3, 7, hp, 2)
    else:
        assert n == 2 * 3 * 7 * hp


def _inputs(B, T, H, seed):
    rng = np.random.default_rng(seed)
    xin = rng.normal(size=(B, T, H)) * 0.7
    w = rng.normal(size=(H, H)) / np.sqrt(H)
    g = rng.normal(size=(B, T, H))
    return xin, w, g


@pytest.mark.parametrize("H", [24, 384])
def test_plain_k1_k10_match_pallas_in_f64(H):
    """fused_rnn_plain and fused_rnn_bwd_plain against tip_tpu's
    fused_rnn and _rnn_bwd (the backward of fused_rnn_train), interpret
    mode, float64: 1e-12."""
    xin, w, g = _inputs(2, 6, H, H)
    hs_j = PK.fused_rnn(jnp.asarray(xin), jnp.asarray(w), interpret=True)
    hs_t = FR.fused_rnn(torch.as_tensor(xin), torch.as_tensor(w))
    np.testing.assert_allclose(hs_t.numpy(), np.asarray(hs_j), atol=1e-12,
                               rtol=0)
    dx_j, dw_j = PK._rnn_bwd(hs_j, jnp.asarray(w), jnp.asarray(g), True)
    dx_t, dw_t = FR.fused_rnn_bwd(hs_t, torch.as_tensor(w),
                                  torch.as_tensor(g))
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(dw_t.numpy(), np.asarray(dw_j), atol=1e-11,
                               rtol=0)


@pytest.mark.parametrize("H", [24, 384])
def test_plain_k1_k10_bf16_equal_pallas(H):
    """In bf16, bit for bit: the forward's three roundings a step, and the
    backward's f32 arithmetic on bf16 operands with da rounded once a
    step."""
    xin, w, g = _inputs(2, 6, H, H + 1)
    xin, g = xin.astype(np.float32), g.astype(np.float32)
    w = (w / 2).astype(np.float32)
    hs_j = PK.fused_rnn(jnp.asarray(xin, jnp.bfloat16),
                        jnp.asarray(w, jnp.bfloat16), interpret=True)
    hs_t = FR.fused_rnn(torch.as_tensor(xin).to(BF),
                        torch.as_tensor(w).to(BF))
    np.testing.assert_array_equal(hs_t.float().numpy(),
                                  np.asarray(hs_j.astype(jnp.float32)))
    dx_j, dw_j = PK._rnn_bwd(hs_j, jnp.asarray(w, jnp.bfloat16),
                             jnp.asarray(g, jnp.bfloat16), True)
    dx_t, dw_t = FR.fused_rnn_bwd(hs_t, torch.as_tensor(w).to(BF),
                                  torch.as_tensor(g).to(BF))
    np.testing.assert_array_equal(dx_t.float().numpy(),
                                  np.asarray(dx_j.astype(jnp.float32)))
    np.testing.assert_array_equal(dw_t.float().numpy(),
                                  np.asarray(dw_j.astype(jnp.float32)))
