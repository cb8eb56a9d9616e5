"""One rank of a multi-process run of the port over a mesh, for
tests/test_torch_mesh.py. It imports torch and tip_tpu_torch only (the
test, which imports JAX too, starts it with ``subprocess``):

    python tests/torch_mesh_worker.py <case> <rank> <world> <dir>

joins a gloo group through the file rendezvous ``<dir>/rendezvous`` (the
``placements`` case: the fake backend, one process standing for a world of
8), reads ``<dir>/inputs.pt``, which the test wrote, runs the case and
writes what it returns to ``<dir>/out_<rank>.pt``.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tip_tpu_torch.models import tip_model as TM  # noqa: E402
from tip_tpu_torch.ops import kinematics as tkin  # noqa: E402
from tip_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from tip_tpu_torch.runtime import runner as TR  # noqa: E402
from tip_tpu_torch.runtime.serving import StreamPool  # noqa: E402
from tip_tpu_torch.train import data as TD  # noqa: E402
from tip_tpu_torch.train import train as TT  # noqa: E402

torch.set_num_threads(1)
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _error(fn):
    """The message of what ``fn()`` raises, None if it returns."""
    try:
        fn()
    except Exception as e:         # the case reports it to the test
        return f"{type(e).__name__}: {e}"
    return None


def _state(cfg, params0):
    state = TT.init_state(cfg, "cpu", torch.float64)
    state.model.load_state_dict({k: torch.as_tensor(v)
                                 for k, v in params0.items()})
    return state


def _f64_blobs(d):
    """The blobs of a dataset's arrays on the CPU, float64 as they come."""
    return TD.DeviceDataset(imu=torch.as_tensor(d["imu"]),
                            acc_sum=torch.as_tensor(d["acc_sum"]),
                            s=torch.as_tensor(d["s"]))


def _whole(state, mesh):
    """The gathered parameters and moments, as numpy."""
    return tuple({k: v.numpy().copy() for k, v in d.items()}
                 for d in TT.gather_state(state, mesh))


@case
def placements(inp, rank, world):
    """The port's placement of every parameter on a (4, 2) mesh."""
    mesh = mesh_lib.make_mesh(4, 2, "cpu")
    model = TM.TIPModel(inp["model"], device="cpu")
    out = {k: tuple(repr(p) for p in pl) for k, pl in
           mesh_lib.param_shardings(mesh, model.state_dict()).items()}
    out["(batch)"] = tuple(repr(p) for p in mesh_lib.batch_sharding(mesh))
    out["(replicated)"] = tuple(repr(p) for p in mesh_lib.replicated(mesh))
    return out


@case
def steps_2x2(inp, rank, world):
    """Three steps on a 2x2 mesh with tip_tpu's noise and seeds; a
    checkpoint written under the mesh and one restored into it; the
    refusals of a model axis that does not divide the heads or FF1."""
    mesh = mesh_lib.make_mesh(2, 2, "cpu")
    cfg = inp["cfg"]
    state = TT.shard_state(_state(cfg, inp["params0"]), mesh)
    out = {"aux": [], "encoder_impl": state.model.cfg.encoder_impl,
           "local_w_q": tuple(state.model.layers[0].w_q.shape)}
    for batch, (noise, seeds) in zip(inp["batches"], inp["draws"]):
        r = mesh_lib.rows(mesh, batch[0].shape[0])
        out["aux"].append(TT.train_step(
            state, tuple(torch.as_tensor(a[r]) for a in batch), cfg,
            noise=torch.as_tensor(noise[r]), seeds=seeds, mesh=mesh))
    out["params"], out["mu"], out["nu"] = _whole(state, mesh)
    out["step"] = int(state.step)
    TT.save_checkpoint(inp["mesh_ckpt"], state, 3, mesh=mesh)
    back = TT.restore_checkpoint(inp["single_ckpt"], cfg, device="cpu",
                                 mesh=mesh)
    out["restored"] = _whole(back, mesh)
    out["restored_local_w_q"] = tuple(back.model.layers[0].w_q.shape)
    out["refusals"] = [_error(lambda m=m: TT.shard_state(
        TT.init_state(TT.TrainConfig(model=m), "cpu"), mesh))
        for m in inp["bad_models"]]
    return out


@case
def epoch_4x1(inp, rank, world):
    """An epoch with the sampler under each dropout (hash masks at the
    rank's rows, rng masks drawn whole); a step and an epoch with a
    non-finite loss on one rank's rows; a pool whose capacity does not
    split."""
    mesh = mesh_lib.make_mesh(4, 1, "cpu")
    dds = _f64_blobs(inp["dataset"])
    out = {"epochs": {}}
    for name, cfg in inp["cfgs"].items():
        sampler = TD.make_window_sampler(inp["dataset"]["info"],
                                         cfg.seq_len, "cpu")
        state = TT.shard_state(_state(cfg, inp["params0"]), mesh)
        epoch = TT.make_epoch_fn(cfg, dds, sampler, inp["n_batches"],
                                 mesh=mesh)
        state, aux = epoch(state)
        out["epochs"][name] = {
            "aux": {k: v.numpy() for k, v in aux.items()},
            "params": _whole(state, mesh)[0], "step": int(state.step)}

    cfg = inp["cfgs"]["hash"]
    state = TT.shard_state(_state(cfg, inp["params0"]), mesh)
    before = _whole(state, mesh)[0]
    batch = [torch.as_tensor(a) for a in inp["poisoned_batch"]]
    r = mesh_lib.rows(mesh, batch[0].shape[0])
    out["poisoned_step"] = TT.train_step(
        state, tuple(a[r] for a in batch), cfg, mesh=mesh)
    after = _whole(state, mesh)[0]
    out["unchanged"] = all(np.array_equal(before[k], after[k])
                           for k in before)
    poisoned = _f64_blobs(inp["poisoned_dataset"])
    state, aux = TT.make_epoch_fn(cfg, poisoned, mesh=mesh)(
        state, torch.as_tensor(inp["poisoned_ends"]))
    out["poisoned_epoch_skipped"] = aux["skipped"].numpy()
    out["poisoned_epoch_params"] = _whole(state, mesh)[0]

    model = TM.TIPModel(TM.ModelConfig(**inp["pool_widths"]), device="cpu")
    out["capacity_refusal"] = _error(lambda: StreamPool(
        model, TR.RunnerConfig(model=model.cfg), capacity=6, device="cpu",
        mesh=mesh))
    return out


@case
def pool_2x1(inp, rank, world):
    """The pool over the data axis of 2 ranks: streams join at their
    ticks, one leaves and its slot is taken again; then a tick that raises
    on rank 1 only, and the ticks after it. ``imu``: every tick's batch
    by slot."""
    mesh = mesh_lib.make_mesh(2, 1, "cpu")
    cfg = inp["cfg"]
    model = TM.TIPModel(cfg.model, device="cpu", dtype=torch.float64)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in inp["state_dict"].items()})
    pool = StreamPool(model, cfg, tkin.amass_skeleton(dtype=torch.float64),
                      capacity=inp["capacity"], dtype=torch.float64,
                      device="cpu", mesh=mesh)
    qdq, slots = [], {}
    for t in range(inp["ticks"]):
        for i, (join, leave) in enumerate(inp["schedule"]):
            if join == t:
                slots[i] = pool.add_stream(inp["s_init"][i])
            if leave == t:
                pool.remove_stream(slots.pop(i))
        out = pool.step(inp["imu"][t])
        qdq.append(out["qdq"].numpy().copy())
    fail_at = inp["ticks"]
    real = pool._step

    def failing(carries, imu, tick):
        if rank == 1 and tick == fail_at:
            raise RuntimeError("injected tick failure")
        return real(carries, imu, tick)

    pool._step = failing
    error = _error(lambda: pool.step(inp["imu"][fail_at]))
    pool._step = real
    after = [pool.step(inp["imu"][t])["qdq"].numpy().copy()
             for t in range(fail_at + 1, len(inp["imu"]))]
    return {"qdq": np.stack(qdq), "error": error, "after": np.stack(after),
            "active": pool.active.copy(), "local": pool._carries.n_streams}


def main():
    name, rank, world, d = sys.argv[1:]
    rank, world = int(rank), int(world)
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    if name == "placements":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
    else:
        mesh_lib.init_distributed(
            "file://" + os.path.join(d, "rendezvous"), world_size=world,
            rank=rank, backend="gloo")
    try:
        out = CASES[name](inp, rank, world)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))


if __name__ == "__main__":
    main()
