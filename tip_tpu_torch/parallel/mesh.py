"""The (data, model) device mesh over torch.distributed (twin of
tip_tpu/parallel/mesh.py).

One process per device, every rank running the same host code: torchrun's
model, the twin of JAX's SPMD program. Each rank holds its part of every
sharded tensor as a plain local tensor, and every collective is explicit:

  * the batch shards over ``data``: a rank draws what one device would draw
    over the global batch and takes its own rows (``rows``); the step's loss
    sums and gradients are all-reduced over the data group;
  * parameters optionally shard over ``model`` (Megatron-style tensor
    parallelism, ``param_shardings``): q/k/v and FF1 split their output
    columns, the out-projection and FF2 their input rows, with a sum over
    the model group after those two products (``tensor_parallel``);
    everything else is replicated.

Collectives go through ``all_reduce`` and ``broadcast`` only: the two that
gloo takes for CUDA tensors, and ranks that share one card run on gloo
(NCCL refuses two ranks on one device). A gather is an all-reduce of a
zero-filled buffer into which each rank writes its part, summed as bytes
(``merge``), so it is exact. Placements are described with
``torch.distributed.tensor``'s ``Shard(d)`` and ``Replicate()``, one per
mesh axis, the twins of the ``PartitionSpec``s; DTensor itself is not used
(its dispatch does not reach the port's ctypes kernels), and its module
is imported where a placement is made or read, not with this one (it
takes a second to import).
"""

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda") -> bool:
    """Join the process group of a multi-process run; call once per process
    before any mesh. ``world_size`` and ``rank`` default to torchrun's
    ``WORLD_SIZE`` and ``RANK``, ``init_method`` to its ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``env://``), ``backend`` to nccl for a CUDA ``device``
    and gloo for the CPU. A no-op for one process (returns False), unless
    the caller names the world size: a group of one then forms, for a
    one-rank mesh. A group already up is kept (returns True)."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        if world_size <= 1:
            return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def local_rank() -> int:
    """This process's device index on its host: torchrun's ``LOCAL_RANK``,
    0 without it."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over every rank of the process group
    (``init_distributed``); ``n_data`` defaults to world / n_model. Each
    rank is one device of the mesh, so the mesh must take every rank."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group: call "
                           "init_distributed first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not take the "
                         f"{world} ranks of the process group")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """Leading-axis (batch) sharding over the data axis."""
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())


def _is_shard(placement) -> bool:
    from torch.distributed.tensor import Shard
    return isinstance(placement, Shard)


def is_sharded(placements) -> bool:
    """Whether a tensor so placed is split over some axis."""
    return any(_is_shard(p) for p in placements)


def _placements(name: str) -> tuple:
    """tip_tpu's rules by parameter name (state-dict names follow its
    param paths, ``layers.0.w_q``)."""
    from torch.distributed.tensor import Replicate, Shard
    if "layers" not in name.split("."):
        return (Replicate(), Replicate())
    if name.endswith(("w_q", "w_k", "w_v", "ff1.w")):
        return (Replicate(), Shard(1))
    if name.endswith(("b_q", "b_k", "b_v", "ff1.b")):
        return (Replicate(), Shard(0))
    if name.endswith(("out_proj.w", "ff2.w")):
        return (Replicate(), Shard(0))
    return (Replicate(), Replicate())


def param_shardings(mesh: DeviceMesh, params) -> Dict[str, tuple]:
    """Tensor-parallel placements of the TIP model's parameters, by
    state-dict name (tip_tpu's ``param_shardings``).

    Megatron-style and per-head clean: q/k/v are stored apart and shard
    their output dim, a contiguous column split, so with n_model dividing
    n_heads every shard owns whole heads (the head interleave permutes the
    projections' input features, which stay whole); FF1 likewise shards
    its output dim; the out-projection and FF2 shard their input dim
    (row-parallel: a sum over the model group follows). Everything else is
    replicated, the RNN head included: its recurrence reads the whole
    hidden state every step, and at 512x512 its weights are 1 MB. With
    n_model == 1 every parameter is whole on every rank."""
    return {name: _placements(name) for name in params}


class Coords(NamedTuple):
    """Where this rank sits on a mesh."""
    data: int
    n_data: int
    model: int
    n_model: int


def coords(mesh: DeviceMesh) -> Coords:
    return Coords(mesh.get_local_rank(DATA_AXIS), mesh.size(0),
                  mesh.get_local_rank(MODEL_AXIS), mesh.size(1))


def rows(mesh: DeviceMesh, n: int) -> slice:
    """This rank's rows of ``n`` rows sharded over the data axis."""
    c = coords(mesh)
    if n % c.n_data:
        raise ValueError(f"{n} rows do not split over the {c.n_data} ranks "
                         f"of the data axis")
    k = n // c.n_data
    return slice(c.data * k, (c.data + 1) * k)


def part(shape: Sequence[int], placements, mesh: DeviceMesh
         ) -> Tuple[slice, ...]:
    """The index of this rank's part of a tensor of global ``shape``."""
    c = coords(mesh)
    where = [(c.data, c.n_data), (c.model, c.n_model)]
    index = [slice(None)] * len(shape)
    for (i, n), pl in zip(where, placements):
        if _is_shard(pl):
            d = pl.dim
            if shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"over {n} ranks")
            k = shape[d] // n
            index[d] = slice(i * k, (i + 1) * k)
    return tuple(index)


def shard(full: torch.Tensor, placements, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's part of ``full`` as a tensor of its own."""
    return full[part(full.shape, placements, mesh)].clone()


def _group(placements, mesh: DeviceMesh):
    """The group over which the parts of a tensor so placed are spread:
    None when it is whole on every rank (no placement shards both axes)."""
    sharded = [_is_shard(p) for p in placements]
    if sharded[0]:
        return mesh.get_group(DATA_AXIS)
    if sharded[1]:
        return mesh.get_group(MODEL_AXIS)
    return None


def merge(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The sum of ``tensors`` over ``group``, exact where each byte is
    written by one rank and zero on the others (a gather): the tensors go
    as bytes into one buffer, one all-reduce. Returns new tensors."""
    if not tensors:
        return []
    flat = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        # each part starts 8-byte aligned, so that its bytes view as its
        # dtype again
        flat += [b, b.new_zeros(-b.numel() % 8)]
    buf = torch.cat(flat)
    dist.all_reduce(buf, group=group)
    out, o = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append(buf[o:o + n].view(t.dtype).reshape(t.shape))
        o += n + (-n % 8)
    return out


def gather(parts: List[torch.Tensor], placements: List[tuple],
           mesh: DeviceMesh) -> List[torch.Tensor]:
    """The whole tensors of which this rank holds ``parts`` (placed as
    ``placements``), on every rank: one exact ``merge`` per group."""
    sizes = [mesh.size(0), mesh.size(1)]
    full = list(parts)
    by_group = {}
    for i, (t, pl) in enumerate(zip(parts, placements)):
        g = _group(pl, mesh)
        if g is None:
            continue
        shape = list(t.shape)
        for axis, p in enumerate(pl):
            if _is_shard(p):
                shape[p.dim] *= sizes[axis]
        buf = t.new_zeros(shape)
        buf[part(shape, pl, mesh)] = t
        by_group.setdefault(g, []).append((i, buf))
    for g, items in by_group.items():
        for (i, _), t in zip(items, merge([b for _, b in items], g)):
            full[i] = t
    return full


def all_sum_(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, one all-reduce for all of
    them (one dtype)."""
    if not tensors:
        return
    buf = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(buf, group=group)
    o = 0
    for t in tensors:
        t.copy_(buf[o:o + t.numel()].view(t.shape))
        o += t.numel()


class _SumForward(torch.autograd.Function):
    """All-reduce sum in the forward, identity in the backward."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Identity in the forward, all-reduce sum in the backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def data_sum(mesh: Optional[DeviceMesh]):
    """The sum over the data axis of a value that each rank computes from
    its rows (the loss's sums and counts), differentiable: each rank's
    backward then gives its own rows' part of the gradient, which
    ``all_sum_`` over the data group completes. None where the data axis
    has one rank (or there is no mesh): one device's arithmetic."""
    if mesh is None or mesh.size(0) == 1:
        return None
    group = mesh.get_group(DATA_AXIS)
    return lambda t: _SumForward.apply(t, group)


class TensorParallel(NamedTuple):
    """The two collectives of a tensor-parallel layer."""
    enter: object      # before a column-parallel product: identity, and
                       # a sum over the model group in the backward
    reduce: object     # after a row-parallel product: a sum over the model
                       # group, identity in the backward


def tensor_parallel(mesh: Optional[DeviceMesh]) -> Optional[TensorParallel]:
    """The model axis's collectives; None where it has one rank."""
    if mesh is None or mesh.size(1) == 1:
        return None
    group = mesh.get_group(MODEL_AXIS)
    return TensorParallel(lambda t: _SumBackward.apply(t, group),
                          lambda t: _SumForward.apply(t, group))


def global_norm(grads: List[torch.Tensor], names: List[str],
                mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """The norm over all gradients of the global model (``grads`` of the
    parameters ``names``), each parameter counted once: under a model axis
    the squares of sharded parameters' parts are summed over the model
    group and the replicated ones taken as they are."""
    norms = torch.stack(torch._foreach_norm(grads))
    if mesh is None or mesh.size(1) == 1:
        return torch.linalg.vector_norm(norms)
    mask = torch.tensor([_is_shard(_placements(k)[1]) for k in names],
                        device=norms.device)
    sq = norms * norms
    sharded = torch.where(mask, sq, torch.zeros_like(sq)).sum()
    dist.all_reduce(sharded, group=mesh.get_group(MODEL_AXIS))
    return torch.sqrt(sharded + torch.where(mask, torch.zeros_like(sq),
                                            sq).sum())
