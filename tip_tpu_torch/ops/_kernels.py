"""Builds and loads the port's CUDA kernels, and counts their launches.

Each ``csrc/<name>.cu`` is compiled by plain ``nvcc`` into its own shared
library with a C interface (``build/tip_tpu_torch/<name>-<hash>.so`` at the
repo root, named by a hash of the source and of every ``csrc/*.cuh`` header,
so an edit to either rebuilds) and loaded with ``ctypes``. Nothing is built
when a module is imported: the first call of a kernel wrapper builds, or
``build_all()`` builds every source at once, one ``nvcc`` process per
source, all started together.

Every C entry point takes pointers and the stream as ``c_void_p`` and
returns ``cudaGetLastError()``; ``check`` raises if it is not 0. The
per-frame wrappers (K2, K3, K6) check and pack what does not change from
frame to frame once, with ``launch_args``.
"""

import collections
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import weakref
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

_ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = _ROOT / "build" / "tip_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# launches per kernel wrapper; a wrapper adds one where it launches its
# kernel and nowhere else
launch_counts = collections.Counter()

_libs = {}


def reset_launch_counts():
    launch_counts.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared device code
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def sources():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names=None):
    """Compile every source that has no up-to-date library, all in
    parallel; raise with nvcc's output if one fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def lib(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use, with
    ``argtypes``/``restype`` declared from ``signatures``
    (function name -> list of ctypes argument types)."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        so = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(so, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = so
    return _libs[name]


def check_impl(impl: str, option: str, explicit: str):
    """Raise unless ``impl`` is "auto", ``explicit`` (the option's name for
    the kernel: "kernel" or "fused") or "plain"."""
    if impl not in ("auto", explicit, "plain"):
        raise ValueError(f"{option} must be auto|{explicit}|plain, got "
                         f"{impl!r}")


def use_kernel(impl: str, t, option: str, explicit: str) -> bool:
    """Whether a wrapper launches its kernel on ``t`` under
    ``option=impl``: "plain" never; "auto" for a CUDA tensor; ``explicit``
    for a CUDA tensor, and it raises for a CPU one. A CUDA tensor thus
    reaches the kernel unless the caller asked for "plain"."""
    check_impl(impl, option, explicit)
    if impl == "plain":
        return False
    if t.is_cuda:
        return True
    if impl == explicit:
        raise ValueError(f"{option}={explicit!r} needs a CUDA tensor; the "
                         f"CPU runs the plain version ({option}='auto' or "
                         f"'plain')")
    return False


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_input(t, name: str, shape, dtype, device):
    """Raise unless ``t`` is a contiguous tensor of this shape and dtype on
    ``device`` that needs no gradient: a kernel reads raw memory and autograd
    does not see it. The training kernels' ``torch.autograd.Function``s
    hand them detached tensors."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.requires_grad:
        raise ValueError(
            f"{name}: requires grad; a kernel's wrapper takes detached "
            f"tensors (train through fused_rnn_train / encoder_layer_train)")


def stream_of(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA ``device``: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without making
    a Stream object (the per-frame wrappers ask at every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def clock_ptr(clock, rows: int, device) -> int:
    """0 (a kernel's per-phase clock off) or the data pointer of ``clock``,
    a (rows,) int64 tensor on ``device``."""
    if clock is None:
        return 0
    check_input(clock, "clock", (rows,), torch.int64, device)
    return clock.data_ptr()


class LaunchArgs(NamedTuple):
    """What a per-frame wrapper checks and computes once (``launch_args``):
    the per-frame inputs' shapes, the constant table it passes, and its
    outputs' views of one allocation."""
    shapes: Tuple[Tuple[int, ...], ...]   # per-frame inputs, in order
    table: torch.Tensor                   # the FK plan (K3, K6), coeff (K2)
    B: int
    n_out: int                            # floats of the one allocation
    views: Tuple[tuple, ...]              # (size, stride, offset) each
    deep: bool = False                    # K3, K6: a chain deeper than a
    #                                       pass of the FK walk


def out_views(lead, shapes) -> Tuple[int, Tuple[tuple, ...]]:
    """Outputs of these per-stream shapes laid one after another in one
    allocation, each with the leading shape ``lead``: (floats, views)."""
    B = lead[0] if lead else 1
    views, off = [], 0
    for shape in shapes:
        size = tuple(lead) + tuple(shape)
        stride, acc = [], 1
        for d in reversed(size):
            stride.append(acc)
            acc *= d
        views.append((size, tuple(reversed(stride)), off))
        off += B * math.prod(shape)
    return off, tuple(views)


# id(owner) -> {key: LaunchArgs}; an owner's entry goes when it is freed
_launch_args = {}


def launch_args(owner, key, make) -> LaunchArgs:
    """``make()`` at the first call for this ``owner`` (a skeleton, K2's
    filter weights) and ``key``, then the same object while ``owner``
    lives. The key holds whatever ``make`` read that may change: device,
    leading shape, the version of a tensor it copied."""
    mine = _launch_args.get(id(owner))
    if mine is None:
        mine = _launch_args[id(owner)] = {}
        weakref.finalize(owner, _launch_args.pop, id(owner), None)
    args = mine.get(key)
    if args is None:
        if len(mine) >= 16:
            mine.clear()
        args = mine[key] = make()
    return args
