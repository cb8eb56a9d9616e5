"""Batch-tile selection (copy of tip_tpu/ops/tiling.py).

The encoder training kernels index their dropout masks by the tile a
sample falls in (``ops/encoder_train.py``), so the port picks the tile as
tip_tpu does: the largest divisor of the batch that is at most the
preferred tile, with a warning when that degenerates."""

import warnings


def pick_tile(n: int, preferred: int, context: str = "batch tile") -> int:
    """Largest divisor of ``n`` that is <= ``preferred``."""
    preferred = min(preferred, n)
    bt = preferred
    while n % bt:
        bt -= 1
    if bt * 2 <= preferred:
        warnings.warn(
            f"{context}: batch {n} is not divisible by the preferred tile "
            f"{preferred}; falling back to tile {bt} ({n // bt} tiles). Pad "
            f"the batch to a multiple of {preferred} to avoid this.",
            stacklevel=3)
    return bt
