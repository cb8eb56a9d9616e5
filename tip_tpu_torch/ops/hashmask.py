"""Counter-based dropout keep-masks (twin of tip_tpu/ops/hashmask.py).

The murmur3 finalizer over an element's linear index: a mask depends only
on (seed, site, linear index), so it regenerates anywhere from the seed
with no random state and nothing saved for the backward. The encoder
kernels K11/K12 (``csrc/hashmask.cuh``) compute the same stream.

The hash is int32 arithmetic with wraparound multiplies and logical right
shifts. torch's ``>>`` on int32 is arithmetic, so here the arithmetic runs
in int64 on values kept below 2**32; each 32-bit product is taken in two
16-bit halves so that no int64 product overflows.
"""

import torch

_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a constant c."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def linear_index(shape, device=None, offsets=None, full_shape=None):
    """Each element's linear index over ``shape`` as tip_tpu computes it:
    the sum of index times stride, every stride and the sum wrapped to 32
    bits (int64 values in [0, 2**32)).

    ``offsets`` and ``full_shape``: the indices of a part of a larger
    tensor (one rank's rows or columns under a mesh), element (i_0, ...) of
    the part being element (offsets[0] + i_0, ...) of a tensor of
    ``full_shape``, whose strides the index takes; None: the whole."""
    offsets = (0,) * len(shape) if offsets is None else tuple(offsets)
    full_shape = tuple(shape) if full_shape is None else tuple(full_shape)
    idx = torch.zeros(shape, dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        view = [1] * len(shape)
        view[d] = shape[d]
        iota = torch.arange(offsets[d], offsets[d] + shape[d],
                            dtype=torch.int64, device=device).reshape(view)
        idx = (idx + _mul32(iota, stride & _M32)) & _M32
        stride *= full_shape[d]
    return idx


def keep_mask_at(seed, site: int, idx, p_keep: float, dtype):
    """Keep-mask in {0, 1/p_keep} of ``dtype`` for the linear indices
    ``idx`` (int64 in [0, 2**32)). ``seed``: a Python int or an int64
    tensor that broadcasts against ``idx`` (int32 values, negatives
    included). The 31-bit hash is converted to ``dtype`` and compared with
    ``p_keep`` in ``dtype``, as tip_tpu does."""
    seed = (seed.to(torch.int64) & _M32 if torch.is_tensor(seed)
            else int(seed) & _M32)
    h = _mul32(idx, 0x9E3779B9)
    h = (h + seed + ((site * 7919) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    # a Python float meets a tensor in the tensor's dtype: the threshold
    # and the kept value are p_keep and 1/p_keep rounded to ``dtype``, and
    # no host value is copied to the device (CUDA-graph safe)
    u = (h & 0x7FFFFFFF).to(dtype) * (2.0 ** -31)
    return (u < p_keep).to(dtype) * (1.0 / p_keep)


def hash_keep_mask(seed, site: int, shape, p_keep: float,
                   dtype=torch.float32, device=None, offsets=None,
                   full_shape=None):
    """Keep-mask in {0, 1/p_keep} of ``dtype`` for any rank, bit for bit
    tip_tpu's ``hash_keep_mask(seed, site, shape, p_keep, dtype)``; with
    ``offsets`` and ``full_shape`` (``linear_index``), the part of
    ``hash_keep_mask(seed, site, full_shape, ...)`` at those offsets.

    Args:
      seed: int32 stream seed (vary per step and per layer call).
      site: dropout-site id (decorrelates masks within a call).
      p_keep: keep probability.
    """
    return keep_mask_at(seed, site, linear_index(tuple(shape), device,
                                                 offsets, full_shape),
                        p_keep, dtype)
