"""The port's (data, model) mesh (tip_tpu_torch/parallel/mesh.py and the
callers that take one) against tip_tpu's meshes, on the CPU.

Each group of cases runs tests/torch_mesh_worker.py (torch and
tip_tpu_torch only) in gloo processes started with ``subprocess``: a file
rendezvous under the test's temporary directory, one thread each, and a
timeout, so that a collective that hangs fails its test. tip_tpu runs here
on the virtual CPU devices that conftest.py makes. Float64 throughout:
the 2x2 steps and the meshed pool equal tip_tpu's meshes to 1e-9, the 4x1
epoch the port's one-process epoch to 1e-12.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.parallel import mesh as JMESH
from tip_tpu.runtime import runner as JR
from tip_tpu.runtime import serving as JS
from tip_tpu.train import train as JT
from tip_tpu_torch.cli import combine_data as TCC
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.runtime import runner as TR
from tip_tpu_torch.train import data as TD
from tip_tpu_torch.train import train as TT

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mesh_worker.py"
CORPUS = ROOT / "artifacts" / "corpus_run_v3" / "corpus_extra"
# a hung collective fails its test after this many seconds
TIMEOUT = 120
TINY = dict(tf_in_dim=64, tf_hid_size=128, n_heads=4, tf_layers=2,
            rnn_hid_size=32)
POOL_WIDTHS = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
                   rnn_hid_size=24)
B, T = 16, 10
TOL_JAX = 1e-9
TOL_EPOCH = 1e-12


def _spawn(cmds, d, env=None):
    """Run the commands (one a rank) together from the repo root; fail
    with every rank's output if one fails or they outlast TIMEOUT."""
    base = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT),
                **(env or {}))
    logs = [open(d / f"log_{r}.txt", "w+") for r in range(len(cmds))]
    procs = [subprocess.Popen(c, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                              env=dict(base, RANK=str(r),
                                       LOCAL_RANK=str(r),
                                       WORLD_SIZE=str(len(cmds))))
             for r, (c, f) in enumerate(zip(cmds, logs))]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for f in logs:
        f.seek(0)
        out.append(f.read())
        f.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        pytest.fail(f"ranks exited {rcs}:\n" + "\n".join(
            f"--- rank {r}\n{o[-3000:]}" for r, o in enumerate(out)))
    return out


def _run(case, world, d, inputs):
    """The worker's ``case`` on ``world`` ranks; each rank's result."""
    d.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, d / "inputs.pt")
    _spawn([[sys.executable, str(WORKER), case, str(r), str(world), str(d)]
            for r in range(world)], d)
    return [torch.load(d / f"out_{r}.pt", weights_only=False)
            for r in range(world)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params_np(tree):
    return {k: v.numpy() for k, v in TM.params_from_jax(_np(tree)).items()}


def _max_rel(got, want):
    return max(float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1.0)) for k in want)


# ---------------------------------------------------------------------------
# (1) placements on a (4, 2) mesh
# ---------------------------------------------------------------------------

def _jax_placements(spec, ndim):
    """A PartitionSpec as the port's placements, one per mesh axis."""
    dims = list(spec) + [None] * (ndim - len(spec))
    return tuple(f"Shard(dim={dims.index(axis)})" if axis in dims
                 else "Replicate()"
                 for axis in (JMESH.DATA_AXIS, JMESH.MODEL_AXIS))


def test_placements_equal_tip_tpus_param_shardings(tmp_path):
    """The port's placement of every parameter, of the batch and of a
    replicated value on a (4, 2) mesh are tip_tpu's PartitionSpecs."""
    cfg = JM.ModelConfig(**TINY)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    mesh = JMESH.make_mesh(n_data=4, n_model=2)
    shardings = JMESH.param_shardings(mesh, params)
    want = {}
    for name, leaf in TM.params_from_jax(_np(params)).items():
        node = shardings
        for key in name.split("."):
            node = node[int(key)] if isinstance(node, list) else node[key]
        want[name] = _jax_placements(node.spec, leaf.dim())
    assert set(want.values()) == {
        ("Replicate()", "Replicate()"), ("Replicate()", "Shard(dim=0)"),
        ("Replicate()", "Shard(dim=1)")}
    want["(batch)"] = _jax_placements(JMESH.batch_sharding(mesh).spec, 1)
    want["(replicated)"] = _jax_placements(JMESH.replicated(mesh).spec, 1)
    got, = _run("placements", 1, tmp_path, {"model": TM.ModelConfig(**TINY)})
    assert got == want


# ---------------------------------------------------------------------------
# (2) three steps on 2x2 against tip_tpu's mesh; (5) checkpoints; (8)
# ---------------------------------------------------------------------------

def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x_imu = rng.normal(size=(B, T, 90))
        x_s = rng.normal(size=(B, T, 131)) * 0.3
        y = rng.normal(size=(B, T, 131)) * 0.3
        x_s[0, 2, 110] = np.nan            # a NaN history entry
        y[1, 3, 109] = np.nan              # DIP-like root velocity rows,
        y[2, 4, 120] = np.nan              # an SBP label row: all on the
        y[5, 1, 122] = np.nan              # first data shard's rows
        out.append((x_imu, x_s, y))
    return out


def _jax_draws(rng_key, shape, n_layers):
    """tip_tpu's step's noise and dropout seeds from its state's rng."""
    _, sub = jax.random.split(rng_key)
    k_noise, k_model = jax.random.split(sub)
    noise = (jax.random.uniform(k_noise, shape, jnp.float64) - 0.5) * 0.3
    seed0 = int(jax.random.bits(k_model, dtype=jnp.uint32).astype(jnp.int32))
    keys = jax.random.split(k_model, 2 + 4 * n_layers)
    layer = [int(jax.random.bits(keys[2 + 4 * li], dtype=jnp.uint32)
                 .astype(jnp.int32)) for li in range(n_layers)]
    return np.array(noise), (seed0, layer)


def _tcfg(**model_kw):
    return TT.TrainConfig(model=TM.ModelConfig(**TINY, **model_kw),
                          batch_size=B, seq_len=T, lr=1e-3, epochs=20,
                          seed=3)


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    """tip_tpu's three f64 steps in its kernel configuration on
    make_mesh(n_data=2, n_model=2) (its _mesh_safe: the scan and the xla
    loop), and the port's on a 2x2 mesh of four gloo ranks from the same
    parameters with the same noise and seeds."""
    jcfg = JT.TrainConfig(model=JM.ModelConfig(
        **TINY, encoder_impl="pallas", rnn_impl="pallas",
        dropout_impl="hash"), batch_size=B, seq_len=T, lr=1e-3, epochs=20,
        seed=3)
    params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float64),
        JM.init_params(jax.random.PRNGKey(0), jcfg.model))
    opt = JT.make_optimizer(jcfg)
    mesh = JMESH.make_mesh(n_data=2, n_model=2)
    state = JT.shard_state(JT.TrainState(
        params=params, opt_state=opt.init(params),
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(7)), mesh)
    step = JT.make_train_step(jcfg, mesh)
    batches, draws, auxes = _batches(3), [], []
    for x_imu, x_s, y in batches:
        draws.append(_jax_draws(state.rng, x_s.shape, TINY["tf_layers"]))
        state, aux = step(state, jnp.asarray(x_imu), jnp.asarray(x_s),
                          jnp.asarray(y))
        auxes.append({k: float(v) for k, v in aux.items()})
    d = tmp_path_factory.mktemp("mesh_2x2")
    # a checkpoint of one process, to restore into the mesh
    tcfg = _tcfg()
    single = TT.init_state(tcfg, "cpu", torch.float64)
    TT.train_step(single, tuple(torch.as_tensor(a) for a in batches[0]),
                  tcfg)
    TT.save_checkpoint(str(d / "single_ckpt"), single, 1)
    ranks = _run("steps_2x2", 4, d / "run", {
        "cfg": tcfg, "params0": _params_np(params), "batches": batches,
        "draws": draws, "mesh_ckpt": str(d / "mesh_ckpt"),
        "single_ckpt": str(d / "single_ckpt"),
        "bad_models": [TM.ModelConfig(tf_in_dim=24, tf_hid_size=64,
                                      n_heads=3, tf_layers=1,
                                      rnn_hid_size=8),
                       TM.ModelConfig(tf_in_dim=32, tf_hid_size=33,
                                      n_heads=4, tf_layers=1,
                                      rnn_hid_size=8)]})
    return dict(jax_aux=auxes, jax_params=_params_np(state.params),
                ranks=ranks, d=d, tcfg=tcfg, single=single)


def test_2x2_steps_match_tip_tpus_mesh(mesh_2x2):
    """Loss, grad_norm and the parameters after each of three f64 steps
    with hash dropout (layer_dropout 0.1 in the xla loop: sites 210-213 at
    the ranks' rows, heads and FF1 columns) equal tip_tpu's 2x2 mesh step
    to 1e-9; the clip acts; every rank reports the same aux and holds half
    the q columns; the mesh trains the xla loop."""
    r0 = mesh_2x2["ranks"][0]
    for r in mesh_2x2["ranks"]:
        assert r["aux"] == r0["aux"]
        assert r["encoder_impl"] == "xla"
        assert r["local_w_q"] == (TINY["tf_in_dim"], TINY["tf_in_dim"] // 2)
    for got, want in zip(r0["aux"], mesh_2x2["jax_aux"]):
        assert not got["skipped"]
        for k in ("loss", "loss_q", "loss_c", "loss_jerk", "grad_norm"):
            assert abs(got[k] - want[k]) <= TOL_JAX * abs(want[k]), k
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-12)
    assert any(a["grad_norm"] > TT.TrainConfig().clip
               for a in mesh_2x2["jax_aux"])
    assert r0["step"] == 3
    assert _max_rel(r0["params"], mesh_2x2["jax_params"]) <= TOL_JAX


def test_checkpoints_cross_between_a_mesh_and_one_process(mesh_2x2):
    """The 2x2 run's checkpoint (rank 0 wrote ckpt_3.pt) restores in one
    process bit-equal to the gathered parameters and moments; a
    one-process checkpoint restored into the 2x2 mesh gathers back to that
    process's state bit for bit."""
    r0 = mesh_2x2["ranks"][0]
    d, tcfg = mesh_2x2["d"], mesh_2x2["tcfg"]
    assert sorted(os.listdir(d / "mesh_ckpt")) == ["ckpt_3.pt"]
    back = TT.restore_checkpoint(str(d / "mesh_ckpt"), tcfg, device="cpu")
    assert int(back.step) == 3
    for k, p in back.model.state_dict().items():
        assert np.array_equal(p.numpy(), r0["params"][k]), k
        assert np.array_equal(back.mu[k].numpy(), r0["mu"][k]), k
        assert np.array_equal(back.nu[k].numpy(), r0["nu"][k]), k
    single = mesh_2x2["single"]
    for r in mesh_2x2["ranks"]:
        params, mu, nu = r["restored"]
        assert r["restored_local_w_q"] == r["local_w_q"]
        for k, p in single.model.state_dict().items():
            assert np.array_equal(params[k], p.detach().numpy()), k
            assert np.array_equal(mu[k], single.mu[k].numpy()), k
            assert np.array_equal(nu[k], single.nu[k].numpy()), k


# ---------------------------------------------------------------------------
# (3) a 4x1 epoch with the sampler; (7) a non-finite loss on one rank
# ---------------------------------------------------------------------------

def _info(n_seg=6, seg=60):
    return np.array([[i * seg, (i + 1) * seg, 1 + i % 3]
                     for i in range(n_seg)], np.int64)


def _dataset(poison=()):
    rng = np.random.default_rng(0)
    info = _info()
    n = int(info[-1, 1])
    imu = rng.normal(size=(n, 72))
    imu[list(poison)] = np.inf
    return dict(imu=imu, acc_sum=rng.normal(size=(n, 18)),
                s=rng.normal(size=(n, 131)) * 0.3, info=info)


EPOCH_B = 8


def _epoch_cfg(dropout_impl="hash"):
    return TT.TrainConfig(model=TM.ModelConfig(
        **POOL_WIDTHS, encoder_impl="xla", dropout_impl=dropout_impl),
        batch_size=EPOCH_B, seq_len=T, lr=1e-3, optimizer="AdamW",
        epochs=20, seed=5)


def _poisoned_ends():
    """Two batches of ends and a frame that only column 5 of the first
    reads (rank 2 of 4 holds columns 4 and 5)."""
    idx = TD.sample_epoch_indices(_info(), T, np.random.default_rng(9))
    ends = idx[:2 * EPOCH_B].reshape(2, EPOCH_B)
    frame = int(ends[0, 5]) - 1
    reads = (ends > frame) & (ends - T <= frame)
    assert reads.sum() == 1 and reads[0, 5]
    return ends, frame


@pytest.fixture(scope="module")
def mesh_4x1(tmp_path_factory):
    cfgs = {d: _epoch_cfg(d) for d in ("hash", "rng")}
    params0 = {k: v.detach().numpy().copy() for k, v in TT.init_state(
        cfgs["hash"], "cpu", torch.float64).model.state_dict().items()}
    ds = TD.PackedDataset(**_dataset())
    batch = [a.astype(np.float64) for a in TD.gather_batch(
        ds, np.arange(20, 20 + EPOCH_B), T)]
    batch[0][5, 3, 7] = np.inf             # rank 2's second row
    ends, frame = _poisoned_ends()
    ranks = _run("epoch_4x1", 4, tmp_path_factory.mktemp("mesh_4x1"), {
        "cfgs": cfgs, "params0": params0, "dataset": _dataset(),
        "n_batches": 3, "poisoned_batch": batch,
        "poisoned_dataset": _dataset([frame]), "poisoned_ends": ends,
        "pool_widths": POOL_WIDTHS})
    # the port's one-process epochs from the same state
    dds = TD.DeviceDataset(imu=torch.as_tensor(ds.imu),
                           acc_sum=torch.as_tensor(ds.acc_sum),
                           s=torch.as_tensor(ds.s))
    single = {}
    for name, c in cfgs.items():
        state = TT.init_state(c, "cpu", torch.float64)
        sampler = TD.make_window_sampler(ds.info, c.seq_len, "cpu")
        state, aux = TT.make_epoch_fn(c, dds, sampler, 3)(state)
        single[name] = (state, {k: v.numpy() for k, v in aux.items()})
    return dict(ranks=ranks, single=single)


@pytest.mark.parametrize("dropout_impl", ["hash", "rng"])
def test_4x1_epoch_equals_the_one_process_epoch(mesh_4x1, dropout_impl):
    """A 4x1 epoch with the on-device sampler (each rank draws the whole
    epoch's ends and takes its columns; hash masks at its rows, or rng
    masks drawn whole from the replicated generator) equals the port's
    one-process epoch in f64 to 1e-12: the aux of every batch and the
    parameters."""
    state, aux = mesh_4x1["single"][dropout_impl]
    want = {k: v.detach().numpy()
            for k, v in state.model.state_dict().items()}
    for r in mesh_4x1["ranks"]:
        got = r["epochs"][dropout_impl]
        assert got["step"] == 3
        for k, v in aux.items():
            np.testing.assert_allclose(got["aux"][k], v, rtol=TOL_EPOCH,
                                       atol=0, err_msg=k)
        assert _max_rel(got["params"], want) <= TOL_EPOCH


def test_non_finite_loss_on_one_rank_skips_the_step_on_every_rank(mesh_4x1):
    """An inf in rank 2's rows makes the global loss non-finite: the step
    is skipped on every rank and changes no parameter; in an epoch the
    guard drops that batch on every rank and keeps the next."""
    for r in mesh_4x1["ranks"]:
        assert r["poisoned_step"]["skipped"]
        assert not np.isfinite(r["poisoned_step"]["loss"])
        assert r["unchanged"]
        assert r["poisoned_epoch_skipped"].tolist() == [1.0, 0.0]
    p0 = mesh_4x1["ranks"][0]["poisoned_epoch_params"]
    for r in mesh_4x1["ranks"][1:]:
        assert all(np.array_equal(r["poisoned_epoch_params"][k], p0[k])
                   for k in p0)


def test_refusals(mesh_2x2, mesh_4x1):
    """A model axis that does not divide the heads or the FF width, and a
    pool whose capacity does not split over the data axis, raise on every
    rank with the numbers, before any collective."""
    for r in mesh_2x2["ranks"]:
        heads, ff = r["refusals"]
        assert heads.startswith("ValueError") and "n_heads=3" in heads
        assert ff.startswith("ValueError") and "tf_hid_size=33" in ff
    for r in mesh_4x1["ranks"]:
        assert r["capacity_refusal"].startswith("ValueError")
        assert "capacity=6" in r["capacity_refusal"]
        assert "4 ranks" in r["capacity_refusal"]


def test_init_distributed_is_a_no_op_for_one_process(monkeypatch):
    """Without torchrun's WORLD_SIZE, or with a world of one, and no world
    size named, init_distributed joins no group: one process trains
    without a mesh."""
    import torch.distributed as dist
    from tip_tpu_torch.parallel import mesh as TMESH
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert TMESH.init_distributed(device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert TMESH.init_distributed(device="cpu") is False
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (4) the pool on 2 ranks against tip_tpu's meshed pool
# ---------------------------------------------------------------------------

CAPACITY = 8
POOL_TICKS = 14
# (join tick, leave tick) of each stream: stream 8 takes the slot that
# stream 2 leaves
SCHEDULE = [(0, None)] * 2 + [(0, 7)] + [(0, None)] * 3 + [(3, None),
                                                          (5, None), (9, None)]


def _pool_inputs():
    imus, s_inits = [], []
    for i in range(len(SCHEDULE)):
        with open(CORPUS / f"freeform2_{i % 4:04d}.pkl", "rb") as f:
            d = pickle.load(f)     # in-tree motions written by data gen
        imus.append(np.asarray(d["imu"][7 * i:7 * i + 40], np.float64))
        s_inits.append(np.asarray(d["nimble_qdq"][0], np.float64))
    return imus, s_inits


def _drive(pool, imus, s_inits, n_ticks, fail_at=None, fail=None):
    """The schedule through a pool (either package's): each tick's IMU
    batch by slot and the outputs; ``fail``, called at tick ``fail_at``,
    makes that tick raise."""
    slots, joined, batches, qdq = {}, {}, [], []
    for t in range(n_ticks):
        for i, (join, leave) in enumerate(SCHEDULE):
            if join == t:
                slots[i] = pool.add_stream(s_inits[i])
                joined[i] = t
            if leave == t:
                pool.remove_stream(slots.pop(i))
        batch = np.zeros((CAPACITY, 72))
        for i, slot in slots.items():
            batch[slot] = imus[i][t - joined[i]]
        batches.append(batch)
        if t == fail_at:
            with pytest.raises(RuntimeError, match="injected"):
                fail(batch)
            qdq.append(None)
            continue
        qdq.append(np.asarray(pool.step(batch)["qdq"]))
    return batches, qdq


@pytest.fixture(scope="module")
def pool_2x1(tmp_path_factory):
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**POOL_WIDTHS))
    tcfg = TR.RunnerConfig(model=TM.ModelConfig(**POOL_WIDTHS))
    params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float64),
        JM.init_params(jax.random.PRNGKey(0), jcfg.model))
    jpool = JS.StreamPool(params, jcfg, jkin.amass_skeleton(
        dtype=jnp.float64), capacity=CAPACITY, dtype=jnp.float64,
        mesh=JMESH.make_mesh(n_data=2, n_model=1))
    imus, s_inits = _pool_inputs()
    real = jpool._step

    def fail(batch):
        jpool._step = _raise
        try:
            jpool.step(batch)
        finally:
            jpool._step = real
    n = POOL_TICKS + 6
    batches, jqdq = _drive(jpool, imus, s_inits, n, POOL_TICKS, fail)
    ranks = _run("pool_2x1", 2, tmp_path_factory.mktemp("pool_2x1"), {
        "cfg": tcfg, "state_dict": _params_np(params),
        "capacity": CAPACITY, "ticks": POOL_TICKS, "schedule": SCHEDULE,
        "s_init": s_inits, "imu": np.stack(batches)})
    return dict(ranks=ranks, jqdq=jqdq)


def _raise(*args):
    raise RuntimeError("injected tick failure")


def test_meshed_pool_matches_tip_tpus_meshed_pool(pool_2x1):
    """StreamPool(mesh=) on 2 ranks (4 slots each), streams joining at
    ticks 0, 3, 5 and 9 into a recycled slot, equals tip_tpu's pool on a
    2-device mesh in f64 to 1e-9, on every rank; a tick that raises on
    rank 1 only raises on both (rank 0 names rank 1), both restart their
    streams, and the ticks after equal tip_tpu's pool after the same
    failure."""
    jqdq = pool_2x1["jqdq"]
    for rank, r in enumerate(pool_2x1["ranks"]):
        assert r["local"] == CAPACITY // 2
        assert r["active"].all()
        for t in range(POOL_TICKS):
            np.testing.assert_allclose(r["qdq"][t], jqdq[t], rtol=0,
                                       atol=TOL_JAX, err_msg=f"tick {t}")
        want = "injected" if rank == 1 else "rank(s) [1]"
        assert r["error"].startswith("RuntimeError") and want in r["error"]
        for i, t in enumerate(range(POOL_TICKS + 1, len(jqdq))):
            np.testing.assert_allclose(r["after"][i], jqdq[t], rtol=0,
                                       atol=TOL_JAX, err_msg=f"tick {t}")
    a, b = pool_2x1["ranks"]
    assert np.array_equal(a["qdq"], b["qdq"])
    assert np.array_equal(a["after"], b["after"])


# ---------------------------------------------------------------------------
# (6) cli/train in two processes
# ---------------------------------------------------------------------------

CLI_WIDTHS = ["--tf_in_dim", "32", "--tf_nhid", "64", "--n_heads", "4",
              "--tf_layers", "2", "--rnn_nhid", "24"]


def test_cli_train_in_two_processes_writes_a_checkpoint_one_resumes(
        tmp_path):
    """``cli/train --n_model_shards 2`` in two CPU processes trains 2
    epochs over a 1x2 mesh (tensor parallel), rank 0 alone logging and
    writing ckpt_1.pt and ckpt_2.pt; one process resumes from the
    checkpoint and steps on."""
    TCC.main(["--data_root", str(CORPUS.parent), "--datasets",
              "corpus_extra", "--rates", "60", "--name_contains",
              "freeform2_000[01]", "--out_prefix", str(tmp_path / "d")])
    run = tmp_path / "run"
    cmd = [sys.executable, "-m", "tip_tpu_torch.cli.train", "--data_prefix",
           str(tmp_path / "d"), "--save_path", str(run), "--batch_size",
           "8", "--seq_len", "10", "--epochs", "2", "--with_acc_sum",
           *CLI_WIDTHS, "--device", "cpu", "--n_model_shards", "2",
           "--init_method", "file://" + str(tmp_path / "rendezvous")]
    logs = _spawn([cmd, cmd], tmp_path)
    assert "mesh: {'data': 1, 'model': 2}" in logs[0]
    assert "mesh:" not in logs[1]
    assert sorted(os.listdir(run)) == ["ckpt_1.pt", "ckpt_2.pt",
                                       "metrics.jsonl"]
    lines = [json.loads(l) for l in open(run / "metrics.jsonl")]
    means = [r["mean_loss"] for r in lines if "mean_loss" in r]
    assert len(means) == 2 and all(np.isfinite(means))
    cfg = TT.TrainConfig(model=TM.ModelConfig(
        tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
        rnn_hid_size=24), batch_size=8, seq_len=10, epochs=2)
    state = TT.restore_checkpoint(str(run), cfg, device="cpu")
    steps = int(state.step)
    assert steps > 0 and state.model.layers[0].w_q.shape == (32, 32)
    ds = TD.PackedDataset.from_prefix(str(tmp_path / "d"))
    batch = TD.gather_batch(ds, np.arange(20, 28), 10)
    aux = TT.train_step(state, tuple(torch.as_tensor(a) for a in batch), cfg)
    assert not aux["skipped"] and np.isfinite(aux["loss"])
    assert int(state.step) == steps + 1
