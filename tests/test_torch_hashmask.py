"""The port's hash dropout masks (tip_tpu_torch.ops.hashmask) and batch
tiles (ops.tiling) against tip_tpu's: bit for bit, for any rank, seed
(negative included), site and dtype."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.ops import hashmask as JH
from tip_tpu.ops import tiling as JT
from tip_tpu_torch.ops import hashmask as TH
from tip_tpu_torch.ops import tiling as TT

SHAPES = ((7,), (5, 13), (3, 6, 11), (2, 3, 5, 7), (320, 320))
SITES = tuple(range(16)) + (100, 101, 102, 200, 201)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("seed", [0, 42, -7, 2 ** 31 - 1, -2 ** 31])
def test_hash_keep_mask_bit_equal_to_tip_tpu(seed, dtype):
    for shape in SHAPES:
        for site in SITES:
            p_keep = 0.9 if site < 200 else 0.2
            j = np.asarray(JH.hash_keep_mask(jnp.int32(seed), site, shape,
                                             p_keep, getattr(jnp, dtype)))
            t = TH.hash_keep_mask(seed, site, shape, p_keep,
                                  getattr(torch, dtype)).numpy()
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j, err_msg=f"{shape} {site}")


def test_keep_mask_at_takes_per_element_seeds():
    """One call with a seed per row equals a call per row."""
    idx = TH.linear_index((4, 9))
    seeds = torch.tensor([3, -5, 2 ** 31 - 1, 0])[:, None]
    m = TH.keep_mask_at(seeds, 101, idx, 0.9, torch.float32)
    for r in range(4):
        row = TH.hash_keep_mask(int(seeds[r]), 101, (4, 9), 0.9)[r]
        assert torch.equal(m[r], row)


@pytest.mark.parametrize("n,preferred", [(256, 8), (16, 8), (6, 8), (6, 3),
                                         (7, 8), (1, 8), (12, 5)])
def test_pick_tile_equals_tip_tpu(n, preferred):
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        j = JT.pick_tile(n, preferred, "x")
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        t = TT.pick_tile(n, preferred, "x")
    assert t == j
    assert len(wt) == len(wj)
