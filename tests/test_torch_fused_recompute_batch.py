"""K9's plain version (tip_tpu_torch.ops.fused_forward.fused_recompute_batch
on CPU tensors) against tip_tpu's ``fused_recompute_batch`` (two Pallas
kernels, in interpret mode as tip_tpu's own tests run them) and against
the port's single-stream ``fused_forward_last`` stream by stream: mixed
``k_last``, a NaN in a history channel, the root-velocity columns set, both
packing dtypes. Inputs and weights are made from a seed and shared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.ops import fused_forward as JFF
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import fused_forward as TFF

torch.set_num_threads(1)

TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
T = 12
K_LAST = [T - 1, 3, 0, 7, T - 1, 5]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32 packing: the same f32 products summed in another order; bf16 packing:
# a sum on the other side of a rounding boundary moves an activation by one
# bf16 step (2^-8 relative) before it is multiplied on
ATOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _setup(dt, B, seed=0):
    jcfg = JM.ModelConfig(**TINY, forward_impl="fused")
    tcfg = TM.ModelConfig(**TINY, forward_impl="fused")
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TM.TIPModel(tcfg, device="cpu")
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(B, T, jcfg.input_dim)).astype(np.float32)
    x[0, 5, 90 + 7] = np.nan             # a NaN in a history channel
    x[1, 2, 90 + 40] = np.nan
    x[:, :, 90 + 108:90 + 111] = 5.0     # the zeroed root-velocity columns
    jws = tuple(JFF.pack_weights(params, jcfg, dtype=JDT[dt]))
    return jcfg, tcfg, jws, model.packed_weights(TDT[dt]), x


@pytest.mark.parametrize("B", [4, 6])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_recompute_batch_plain_matches_pallas(dt, B):
    jcfg, tcfg, jws, tws, x = _setup(dt, B)
    ks = K_LAST[:B]
    jy = JFF.fused_recompute_batch(jws, jnp.asarray(x),
                                   jnp.asarray(ks, jnp.int32), jcfg, bt=2,
                                   bt_rnn=2, interpret=True)
    K.reset_launch_counts()
    ty = TFF.fused_recompute_batch(tws, torch.as_tensor(x), ks, tcfg)
    assert ty.shape == (B, 131) and ty.dtype == torch.float32
    assert torch.isfinite(ty).all()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL[dt],
                               rtol=0)
    assert sum(K.launch_counts.values()) == 0


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_recompute_batch_equals_fused_forward_last_per_stream(dt):
    """Attention and the RNN never cross streams: row b is the single
    stream's prediction at k_last[b]. k_last as a list, a numpy array and
    an integer tensor."""
    _, tcfg, _, tws, x = _setup(dt, 6, seed=2)
    xt = torch.as_tensor(x)
    ty = TFF.fused_recompute_batch(tws, xt, K_LAST, tcfg)
    for b, k in enumerate(K_LAST):
        one = TFF.fused_forward_last(tws, xt[b], k, tcfg)
        # the same casts on the same values, batched products
        np.testing.assert_allclose(ty[b].numpy(), one.numpy(), rtol=0,
                                   atol=1e-6 if dt == "float32" else ATOL[dt])
    for ks in (np.asarray(K_LAST), torch.tensor(K_LAST, dtype=torch.int32)):
        assert torch.equal(TFF.fused_recompute_batch(tws, xt, ks, tcfg), ty)
    # rows after k_last[b] cannot reach the output
    x2 = xt.clone()
    for b, k in enumerate(K_LAST):
        x2[b, k + 1:] = 7.0
    assert torch.equal(TFF.fused_recompute_batch(tws, x2, K_LAST, tcfg), ty)


@pytest.mark.parametrize("ks", [[0, T, 1, 2], [0, 1, -1, 2], [0, 1, 2]])
def test_k_last_outside_the_window_raises(ks):
    """An index outside the window raises (tip_tpu answers with the bare
    output bias there), and so does a wrong count; the explicit kernel
    request on a CPU tensor raises too."""
    _, tcfg, _, tws, x = _setup("float32", 4)
    xt = torch.as_tensor(x)
    with pytest.raises(IndexError if len(ks) == 4 else ValueError):
        TFF.fused_recompute_batch(tws, xt, ks, tcfg)
    with pytest.raises(IndexError if len(ks) == 4 else ValueError):
        TFF.fused_recompute_batch_plain(tws, xt, ks, tcfg)
    with pytest.raises(ValueError, match="CUDA"):
        TFF.fused_recompute_batch(tws, xt, [0, 1, 2, 3], tcfg, impl="fused")


def test_phase_split_reads_k9s_clock_rows():
    """The per-phase clock's rows (end, first and last arrival, kind; row 0
    the start) become ms by kind: a phase's work runs from the barrier
    before it to the last arrival, its barrier from there to the end; the
    RNN (no arrivals) counts whole; rows after the last end are not
    read."""
    big = 2 ** 62
    rows = [[1_000_000, big, 0, 0],
            [1_300_000, 1_100_000, 1_200_000, 1],     # in_proj
            [1_700_000, 1_500_000, 1_650_000, 2],     # qkv
            [2_700_000, big, 0, 10],                  # the RNN
            [2_900_000, 2_800_000, 2_850_000, 11],    # out_proj
            [0, big, 0, 0], [5, 5, 5, 5]]
    split, n = TFF.phase_split(rows)
    assert n == 4
    assert split["in_proj"] == pytest.approx(0.2)
    assert split["qkv"] == pytest.approx(0.35)
    assert split["rnn"] == pytest.approx(1.0)
    assert split["out_proj"] == pytest.approx(0.15)
    assert split["barrier"] == pytest.approx(0.1 + 0.05 + 0.05)
    assert split["imbalance"] == pytest.approx(0.1 + 0.15 + 0.05)
    assert split["total"] == pytest.approx(1.9)
    assert split["attention"] == 0.0
