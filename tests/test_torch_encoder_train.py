"""One training encoder layer (tip_tpu_torch.ops.encoder_train, the plain
versions of K11 and K12) against tip_tpu's Pallas kernels in interpret
mode, float64: the forward with all four hash-dropout sites, dx and the 12
weight gradients, masks bit for bit (a mask that differs shows as an O(1)
error)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.ops import pallas_encoder as PE
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import encoder_train as ET

torch.set_num_threads(1)

CFG = JM.ModelConfig(tf_in_dim=64, tf_hid_size=128, n_heads=4, tf_layers=2,
                     rnn_hid_size=32, size_s=131)
SEED = -7
# (p, train, bt, B): tip_tpu's own cases, and B = 16 with bt = 8 (two
# tiles: the tile seed offset)
CASES = [(0.1, True, 2, 4), (0.0, False, 2, 4), (0.3, True, 3, 6),
         (0.1, True, 8, 16)]


@pytest.fixture(scope="module")
def weights():
    params = JM.init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float64)
    ws = PE.pack_layer_weights(params["layers"][0], jnp.float64)
    return params, ws, tuple(torch.as_tensor(np.asarray(w)) for w in ws)


@pytest.fixture(scope="module")
def oracle(weights):
    """tip_tpu's forward and gradients of every case (interpret mode)."""
    _, ws, _ = weights
    out = {}
    for p, train, bt, B in CASES:
        rng = np.random.default_rng(B)
        x = rng.normal(size=(B, 10, CFG.tf_in_dim))
        tgt = rng.normal(size=x.shape)

        def loss(x, ws):
            y = PE.encoder_layer_train(x, ws, SEED, CFG.n_heads, p, train,
                                       bt, True)
            return jnp.sum((y - tgt) ** 2)

        y = PE.encoder_layer_train(jnp.asarray(x), ws, SEED, CFG.n_heads, p,
                                   train, bt, True)
        gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), ws)
        out[(p, train, bt, B)] = (x, tgt, np.asarray(y), np.asarray(gx),
                                  [np.asarray(g) for g in gw])
    return out


@pytest.mark.parametrize("case", CASES, ids=str)
def test_forward_matches_pallas_kernel(case, weights, oracle):
    p, train, bt, _ = case
    x, _, y_j, _, _ = oracle[case]
    y_t = ET.encoder_layer_train_plain(torch.as_tensor(x), weights[2], SEED,
                                       CFG.n_heads, p, train, bt)
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-12, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_gradients_match_jax_grad_of_the_pallas_kernel(case, weights,
                                                       oracle):
    """dx and all 12 weight gradients through the autograd Function (the
    plain K12 on the CPU) against jax.grad of tip_tpu's kernel pair."""
    p, train, bt, _ = case
    x, tgt, _, gx_j, gw_j = oracle[case]
    x_t = torch.tensor(x, requires_grad=True)
    ws = [w.clone().requires_grad_(True) for w in weights[2]]
    y = ET.encoder_layer_train(x_t, ws, SEED, CFG.n_heads, p, train, bt)
    torch.sum((y - torch.as_tensor(tgt)) ** 2).backward()
    assert np.abs(x_t.grad.numpy() - gx_j).max() \
        <= 1e-10 * max(1.0, np.abs(gx_j).max())
    for i, (w, g) in enumerate(zip(ws, gw_j)):
        assert np.abs(w.grad.numpy() - g).max() \
            <= 1e-10 * max(1.0, np.abs(g).max()), ET.WEIGHT_NAMES[i]


def test_seed_determinism_and_a_different_seed(weights):
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(4, 10, 64)))
    ws = weights[2]
    a = ET.encoder_layer_train_plain(x, ws, 42, CFG.n_heads, 0.1, True, 2)
    b = ET.encoder_layer_train_plain(x, ws, 42, CFG.n_heads, 0.1, True, 2)
    c = ET.encoder_layer_train_plain(x, ws, 43, CFG.n_heads, 0.1, True, 2)
    d = ET.encoder_layer_train_plain(x, ws, 42, CFG.n_heads, 0.1, False, 2)
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 1e-3
    assert (a - d).abs().max() > 1e-3
    da = ET.encoder_layer_bwd_plain(x, ws, 42, torch.ones_like(x),
                                    CFG.n_heads, 0.1, True, 2)
    db = ET.encoder_layer_bwd_plain(x, ws, 42, torch.ones_like(x),
                                    CFG.n_heads, 0.1, True, 2)
    assert all(torch.equal(u, v) for u, v in zip((da[0],) + da[1],
                                                 (db[0],) + db[1]))


def test_pack_layer_weights_matches_tip_tpu(weights):
    params, ws_j, _ = weights
    sd = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    ws_t = ET.pack_layer_weights(sd, "layers.0.")
    for a, b in zip(ws_t, ws_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_kernel_impl_on_a_cpu_tensor_raises(weights):
    x = torch.zeros(2, 10, 64, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        ET.encoder_layer_fwd(x, weights[2], 0, 4, 0.1, True, 2,
                             impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ET.encoder_layer_bwd(x, weights[2], 0, x, 4, 0.1, True, 2,
                             impl="kernel")
