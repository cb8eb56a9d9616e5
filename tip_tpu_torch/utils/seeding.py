"""Deterministic seeding across python, numpy and torch (twin of
tip_tpu/utils/seeding.py; reference learning_utils.set_seed,
learning_utils.py:81-85, called at every entry point). The port's
randomness that matters is drawn from explicit generators
(``generator``), as tip_tpu's from explicit keys; ``set_seed`` pins the
host-side samplers used for window sampling and eval cropping."""

import random

import numpy as np
import torch

from tip_tpu_torch import resolve_device


def set_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def generator(seed: int, device=None) -> torch.Generator:
    """A torch.Generator on ``device`` (``cuda`` unless given) seeded with
    ``seed``: the counterpart of tip_tpu's ``prng_key`` (its draws are
    torch's, not jax.random's)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
