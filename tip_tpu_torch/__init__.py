"""tip_tpu_torch — the PyTorch/CUDA port of tip_tpu for one NVIDIA H100.

Module layout mirrors ``tip_tpu/`` so every module has a named twin. The
package imports torch, numpy and scipy only; it never imports JAX or any
module of ``tip_tpu`` (it keeps its own copies of the numpy tables).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no CUDA card, they raise (``resolve_device``).
"""

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when the caller asks for it. Never falls back silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tip_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def device_const(values: tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """A small constant table (index lists, filter weights) as a tensor on
    ``device``, made once: the per-frame path then copies nothing from the
    host. Callers must not write to the result."""
    return torch.tensor(values, dtype=dtype, device=device)


def __getattr__(name):
    """Lazy re-exports of the entry points (as tip_tpu's), so that
    ``import tip_tpu_torch`` stays cheap and free of import cycles."""
    from importlib import import_module

    table = {
        "ModelConfig": "tip_tpu_torch.models.tip_model",
        "TIPModel": "tip_tpu_torch.models.tip_model",
        "RunnerConfig": "tip_tpu_torch.runtime.runner",
        "runner_init": "tip_tpu_torch.runtime.runner",
        "runner_step": "tip_tpu_torch.runtime.runner",
        "run_offline": "tip_tpu_torch.runtime.runner",
        "FullRunnerConfig": "tip_tpu_torch.runtime.full_runner",
        "full_runner_init": "tip_tpu_torch.runtime.full_runner",
        "full_runner_step": "tip_tpu_torch.runtime.full_runner",
        "run_offline_full": "tip_tpu_torch.runtime.full_runner",
        "TerrainConfig": "tip_tpu_torch.runtime.terrain",
        "StreamPool": "tip_tpu_torch.runtime.serving",
        "amass_skeleton": "tip_tpu_torch.ops.kinematics",
        "Skeleton": "tip_tpu_torch.ops.kinematics",
    }
    if name in table:
        return getattr(import_module(table[name]), name)
    raise AttributeError(f"module 'tip_tpu_torch' has no attribute {name!r}")
