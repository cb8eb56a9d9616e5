"""The port's training slice (tip_tpu_torch.train, models.losses,
data_gen.combine, cli.train) against tip_tpu's, on the CPU.

tip_tpu runs its kernel configuration (encoder_impl="pallas",
rnn_impl="pallas", dropout_impl="hash") with its Pallas kernels in
interpret mode, in float64; its noise and dropout seeds are computed from
its rng and handed to the port's step. Three steps agree to 1e-9.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.data_gen import combine as JC
from tip_tpu.models import losses as JL
from tip_tpu.models import tip_model as JM
from tip_tpu.train import data as JD
from tip_tpu.train import train as JT
from tip_tpu_torch.cli import combine_data as TCC
from tip_tpu_torch.cli import train as TCT
from tip_tpu_torch.data_gen import combine as TC
from tip_tpu_torch.models import losses as TL
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.train import data as TD
from tip_tpu_torch.train import train as TT

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "artifacts", "corpus_run_v3", "corpus_extra")
TINY = dict(tf_in_dim=64, tf_hid_size=128, n_heads=4, tf_layers=2,
            rnn_hid_size=32)
B, T = 16, 10


def _cfgs(optimizer):
    j = JT.TrainConfig(model=JM.ModelConfig(
        **TINY, encoder_impl="pallas", rnn_impl="pallas",
        dropout_impl="hash"), batch_size=B, seq_len=T, lr=1e-3,
        optimizer=optimizer, epochs=20, seed=3)
    t = TT.TrainConfig(model=TM.ModelConfig(**TINY), batch_size=B,
                       seq_len=T, lr=1e-3, optimizer=optimizer, epochs=20,
                       seed=3)
    return j, t


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


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x_imu = rng.normal(size=(B, T, 90))
        x_s = rng.normal(size=(B, T, 131)) * 0.3
        y = rng.normal(size=(B, T, 131)) * 0.3
        x_s[0, 2, 110] = np.nan            # a NaN history entry
        y[1, 3, 109] = np.nan              # a DIP-like root velocity row
        y[2, 4, 120] = np.nan              # an SBP label row
        out.append((x_imu, x_s, y))
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs():
    """Per optimizer: tip_tpu's state after each of three f64 steps, its
    aux, and the noise and seeds of each step."""
    runs = {}
    for optimizer in ("Adam", "AdamW"):
        jcfg, _ = _cfgs(optimizer)
        params = jax.tree_util.tree_map(
            lambda p: p.astype(jnp.float64),
            JM.init_params(jax.random.PRNGKey(0), jcfg.model))
        opt = JT.make_optimizer(jcfg)
        state = JT.TrainState(params=params, opt_state=opt.init(params),
                              step=jnp.zeros((), jnp.int32),
                              rng=jax.random.PRNGKey(7))
        step = JT.make_train_step(jcfg)
        rec = {"params0": _np(params), "steps": []}
        for x_imu, x_s, y in _batches(3):
            draws = _jax_draws(state.rng, x_s.shape, 2)
            state, aux = step(state, jnp.asarray(x_imu), jnp.asarray(x_s),
                              jnp.asarray(y))
            adam = state.opt_state[1][0]
            rec["steps"].append(dict(
                draws=draws, params=_np(state.params),
                aux={k: float(v) for k, v in aux.items()},
                count=int(adam.count), mu=_np(adam.mu), nu=_np(adam.nu)))
        runs[optimizer] = rec
    return runs


def _assert_params(model, params, tol):
    want = TM.params_from_jax(params)
    got = model.state_dict()
    for k, v in want.items():
        err = (got[k] - v).abs().max().item()
        assert err <= tol, (k, err)


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
def test_three_train_steps_match_tip_tpu(optimizer, jax_runs):
    """Params, loss and grad_norm after each of three f64 steps equal
    tip_tpu's make_train_step to 1e-9 (the clip is active: grad_norm ~500
    against 5)."""
    run = jax_runs[optimizer]
    _, tcfg = _cfgs(optimizer)
    state = TT.init_state(tcfg, "cpu", torch.float64)
    state.model.load_state_dict(TM.params_from_jax(run["params0"]))
    for batch, rec in zip(_batches(3), run["steps"]):
        noise, seeds = rec["draws"]
        aux = TT.train_step(state, tuple(torch.as_tensor(a) for a in batch),
                            tcfg, noise=torch.as_tensor(noise), seeds=seeds)
        assert not aux["skipped"]
        for k in ("loss", "loss_q", "loss_c", "loss_jerk", "grad_norm"):
            assert abs(aux[k] - rec["aux"][k]) <= 1e-9 * abs(rec["aux"][k]), k
        assert aux["lr"] == pytest.approx(rec["aux"]["lr"], rel=1e-12)
        assert rec["aux"]["grad_norm"] > tcfg.clip
        _assert_params(state.model, rec["params"], 1e-9)
    assert state.step == 3


def test_train_state_from_jax_continues_a_jax_run(jax_runs):
    """tip_tpu's state after two steps (params, count, mu, nu) -> a port
    state whose next step equals tip_tpu's third."""
    run = jax_runs["AdamW"]
    _, tcfg = _cfgs("AdamW")
    two = run["steps"][1]
    state = TT.train_state_from_jax(two["params"], two["count"], two["mu"],
                                    two["nu"], tcfg, device="cpu")
    assert state.step == 2
    third = run["steps"][2]
    noise, seeds = third["draws"]
    aux = TT.train_step(state, tuple(torch.as_tensor(a)
                                     for a in _batches(3)[2]), tcfg,
                        noise=torch.as_tensor(noise), seeds=seeds)
    assert aux["loss"] == pytest.approx(third["aux"]["loss"], rel=1e-9)
    _assert_params(state.model, third["params"], 1e-9)
    for k, v in TM.params_from_jax(third["mu"]).items():
        assert (state.mu[k] - v).abs().max().item() <= 1e-9


@pytest.mark.parametrize("with_seeds", [True, False])
def test_train_forward_matches_tip_tpu(with_seeds, jax_runs):
    """The model's training forward against tip_tpu's forward(train=True)
    in the kernel configuration, with its rng (dropout on) and without
    (dropout off)."""
    jcfg, tcfg = _cfgs("Adam")
    params = jax_runs["Adam"]["params0"]
    x_imu, x_s, _ = _batches(1, seed=4)[0]
    key = jax.random.PRNGKey(11)
    j = JM.forward(jax.tree_util.tree_map(jnp.asarray, params),
                   jnp.asarray(x_imu), jnp.asarray(x_s), jcfg.model,
                   train=True, rng=key if with_seeds else None)
    seeds = None
    if with_seeds:
        keys = jax.random.split(key, 2 + 4 * 2)
        seeds = (int(jax.random.bits(key, dtype=jnp.uint32)
                     .astype(jnp.int32)),
                 [int(jax.random.bits(keys[2 + 4 * li], dtype=jnp.uint32)
                      .astype(jnp.int32)) for li in range(2)])
    model = TM.TIPModel(tcfg.model, device="cpu", dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(params))
    with torch.no_grad():
        t = model(torch.as_tensor(x_imu), torch.as_tensor(x_s), train=True,
                  seeds=seeds)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-11, rtol=0)


def test_losses_match_tip_tpu_with_nan_rows():
    rng = np.random.default_rng(1)
    ra = rng.normal(size=(50, 131))
    rb = rng.normal(size=(50, 131))
    ra[3, 109] = np.nan
    ra[[5, 6], 110] = np.nan
    ra[7, 115] = np.nan
    ra[8, 130] = np.nan
    nc = 20
    pairs = [
        (JL.loss_q_only_2axis(jnp.asarray(ra[:, :-nc]),
                              jnp.asarray(rb[:, :-nc])),
         TL.loss_q_only_2axis(torch.as_tensor(ra[:, :-nc]),
                              torch.as_tensor(rb[:, :-nc]))),
        (JL.loss_constr_multi(jnp.asarray(ra[:, -nc:]),
                              jnp.asarray(rb[:, -nc:]), 5),
         TL.loss_constr_multi(torch.as_tensor(ra[:, -nc:]),
                              torch.as_tensor(rb[:, -nc:]), 5)),
        (JL.loss_jerk(jnp.asarray(rb[:, :108].reshape(5, 10, 108))),
         TL.loss_jerk(torch.as_tensor(rb[:, :108].reshape(5, 10, 108)))),
    ]
    for j, t in pairs:
        assert np.isfinite(float(t))
        assert float(t) == pytest.approx(float(j), rel=1e-13)


def test_lr_schedule_matches_tip_tpu():
    jcfg, tcfg = _cfgs("Adam")
    js, ts = JT.lr_schedule(jcfg), TT.lr_schedule(tcfg)
    for step in (0, 1, 7, 100, 869, 870, 2000):
        assert ts(step) == pytest.approx(float(js(jnp.int32(step))),
                                         rel=1e-13)
    flat = TT.lr_schedule(TT.TrainConfig(cosine_lr=False, lr=3e-4))
    assert flat(123) == 3e-4


def _tiny_dataset(n_seg=6, seg=60, seed=0):
    rng = np.random.default_rng(seed)
    n = n_seg * seg
    info = np.array([[i * seg, (i + 1) * seg, 1 + i % 3]
                     for i in range(n_seg)], np.int64)
    return (rng.normal(size=(n, 72)).astype(np.float32),
            rng.normal(size=(n, 18)).astype(np.float32),
            (rng.normal(size=(n, 131)) * 0.3).astype(np.float32), info)


def test_epoch_windows_match_tip_tpu():
    imu, acc, s, info = _tiny_dataset()
    jds = JD.PackedDataset(imu=imu, acc_sum=acc, s=s, info=info)
    tds = TD.PackedDataset(imu=imu, acc_sum=acc, s=s, info=info)
    np.testing.assert_array_equal(
        TD.sample_epoch_indices(info, T, np.random.default_rng(9)),
        JD.sample_epoch_indices(info, T, np.random.default_rng(9)))
    jb = list(JD.epoch_batches(jds, T, 8, np.random.default_rng(4)))
    tb = list(TD.epoch_batches(tds, T, 8, np.random.default_rng(4)))
    assert len(tb) == len(jb) > 2
    for a, b in zip(tb, jb):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    # the device gather equals the host gather
    ends = TD.sample_epoch_indices(info, T, np.random.default_rng(2))[:8]
    dev = TD.device_gather(TD.to_device(tds, "cpu"),
                           torch.as_tensor(ends), T)
    for u, v in zip(dev, TD.gather_batch(tds, ends, T)):
        np.testing.assert_array_equal(u.numpy(), v)


@pytest.mark.parametrize("is_dip", [False, True])
def test_process_motion_matches_tip_tpu(is_dip):
    with open(os.path.join(CORPUS, "freeform2_0000.pkl"), "rb") as f:
        payload = pickle.load(f)
    j = JC.process_motion(payload, is_dip, np.random.default_rng(3))
    t = TC.process_motion(payload, is_dip, np.random.default_rng(3))
    for a, b in zip(t, j):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, atol=1e-6 * np.nanmax(np.abs(b)),
                                   rtol=0, equal_nan=True)


def test_combine_cli_matches_tip_tpu(tmp_path):
    """Two in-tree motions packed by the port's CLI and by tip_tpu's
    combine give the same blobs to float32 rounding."""
    info = TCC.main(["--data_root", os.path.dirname(CORPUS), "--datasets",
                     "corpus_extra", "--rates", "4", "--name_contains",
                     "freeform2_000[01]", "--out_prefix",
                     str(tmp_path / "t")])
    JC.combine([CORPUS], [4], str(tmp_path / "j"),
               name_contains=["freeform2_000[01]"], seed=42)
    np.testing.assert_array_equal(info, np.load(tmp_path / "j_info.npy"))
    for blob in ("imu", "sum_imu", "s"):
        a = np.load(tmp_path / f"t_{blob}.npy")
        b = np.load(tmp_path / f"j_{blob}.npy")
        np.testing.assert_allclose(a, b, atol=1e-6 * np.abs(b).max(), rtol=0)


def _tiny_cfg(**kw):
    return TT.TrainConfig(model=TM.ModelConfig(
        tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
        rnn_hid_size=24), batch_size=8, seq_len=T, lr=3e-3, epochs=3,
        seed=0, log_interval=2, **kw)


def _ds():
    imu, acc, s, info = _tiny_dataset()
    return TD.PackedDataset(imu=imu, acc_sum=acc, s=s, info=info)


def test_train_loop_writes_metrics_and_checkpoints_then_resumes(tmp_path):
    cfg = _tiny_cfg(optimizer="AdamW")
    records = []
    state = TT.train_loop(cfg, _ds(), ckpt_dir=str(tmp_path / "ck"),
                          log_fn=records.append, device="cpu",
                          metrics_path=str(tmp_path / "m.jsonl"))
    lines = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert [r["epoch"] for r in lines if "mean_loss" in r] == [1, 2, 3]
    assert any("grad_norm" in r for r in lines)
    assert all(np.isfinite(r["mean_loss"]) for r in lines
               if "mean_loss" in r)
    # checkpoints after epoch 1 and the last
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_1.pt", "ckpt_3.pt"]
    back = TT.restore_checkpoint(str(tmp_path / "ck"), cfg, device="cpu")
    assert back.step == state.step > 0
    for k, p in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], p)
        assert torch.equal(back.mu[k], state.mu[k])
    # the restored state steps exactly as the live one
    batch = TD.gather_batch(_ds(), np.arange(20, 28), T)
    batch = tuple(torch.as_tensor(a) for a in batch)
    a = TT.train_step(state, batch, cfg)
    b = TT.train_step(back, batch, cfg)
    assert a == b
    for k, p in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], p)
    # resuming from the checkpoint's weights (warm start) runs on
    TT.train_loop(cfg, _ds(), log_fn=records.append, device="cpu",
                  max_epochs=1, warm_start=str(tmp_path / "ck"))
    # only the newest 4 are kept
    for step in range(4, 9):
        TT.save_checkpoint(str(tmp_path / "ck"), state, step)
    assert sorted(os.listdir(tmp_path / "ck")) == [
        f"ckpt_{s}.pt" for s in (5, 6, 7, 8)]
    with pytest.raises(ValueError, match="model config"):
        TT.restore_checkpoint(str(tmp_path / "ck"), TT.TrainConfig(
            model=TM.ModelConfig(tf_in_dim=32, tf_hid_size=64, n_heads=4,
                                 tf_layers=2, rnn_hid_size=16)),
            device="cpu")


def test_non_finite_step_is_skipped_and_changes_nothing():
    cfg = _tiny_cfg()
    state = TT.init_state(cfg, "cpu")
    batch = [torch.as_tensor(a) for a in TD.gather_batch(
        _ds(), np.arange(20, 28), T)]
    TT.train_step(state, tuple(batch), cfg)        # moments become non-zero
    before = ({k: p.clone() for k, p in state.model.state_dict().items()},
              {k: v.clone() for k, v in state.mu.items()},
              {k: v.clone() for k, v in state.nu.items()}, state.step,
              state.gen.get_state(), state.noise_gen.get_state())
    batch[0] = batch[0].clone()
    batch[0][0, 0, 0] = float("inf")
    aux = TT.train_step(state, tuple(batch), cfg)
    assert aux["skipped"] and not np.isfinite(aux["loss"])
    after = (state.model.state_dict(), state.mu, state.nu, state.step,
             state.gen.get_state(), state.noise_gen.get_state())
    for x, y in zip(before[:3], after[:3]):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert before[3] == after[3]
    assert torch.equal(before[4], after[4])
    assert torch.equal(before[5], after[5])
    # train_loop skips such steps and gives up after 20
    bad = _ds()
    bad.imu[:] = np.inf
    logged = []
    with pytest.raises(FloatingPointError, match="diverged"):
        TT.train_loop(_tiny_cfg(), bad, log_fn=logged.append, device="cpu",
                      max_epochs=50)
    assert sum(r.get("event") == "non_finite_loss_skipped"
               for r in logged) == 21


def test_cli_train_on_cpu(tmp_path):
    TCC.main(["--data_root", os.path.dirname(CORPUS), "--datasets",
              "corpus_extra", "--rates", "60", "--name_contains",
              "freeform2_000[01]", "--out_prefix", str(tmp_path / "d")])
    state = TCT.main([
        "--data_prefix", str(tmp_path / "d"), "--save_path",
        str(tmp_path / "run"), "--batch_size", "8", "--seq_len", "10",
        "--epochs", "2", "--with_acc_sum", "--cosine_lr", "--optim", "AdamW",
        "--tf_in_dim", "32", "--tf_nhid", "64", "--n_heads", "4",
        "--tf_layers", "2", "--rnn_nhid", "24", "--device", "cpu"])
    assert state.step > 0
    assert os.path.exists(tmp_path / "run" / "ckpt_2.pt")
    lines = [json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")]
    assert [r["epoch"] for r in lines if "mean_loss" in r] == [1, 2]


@pytest.mark.parametrize("flag", [["--n_model_shards", "2"]])
def test_cli_train_unported_flags_raise(flag, tmp_path):
    """The flag that raised before the mesh was ported now trains: in one
    process there is no mesh and ``--n_model_shards`` is ignored, as
    tip_tpu ignores it on one device, so two epochs on two in-tree motions
    end in the state of the same run without it, bit for bit."""
    TCC.main(["--data_root", os.path.dirname(CORPUS), "--datasets",
              "corpus_extra", "--rates", "60", "--name_contains",
              "freeform2_000[01]", "--out_prefix", str(tmp_path / "d")])
    states = [TCT.main([
        "--data_prefix", str(tmp_path / "d"), "--save_path",
        str(tmp_path / run), "--batch_size", "8", "--seq_len", "10",
        "--epochs", "2", "--with_acc_sum", "--tf_in_dim", "32", "--tf_nhid",
        "64", "--n_heads", "4", "--tf_layers", "2", "--rnn_nhid", "24",
        "--device", "cpu", *extra])
        for run, extra in (("flag", flag), ("plain", []))]
    assert states[0].step == states[1].step > 0
    assert os.path.exists(tmp_path / "flag" / "ckpt_2.pt")
    for k, p in states[1].model.state_dict().items():
        assert torch.equal(states[0].model.state_dict()[k], p), k


@pytest.mark.parametrize("flags", [
    ["--dropout_rng", "rbg"], ["--dropout_impl", "rng"],
    ["--encoder_impl", "xla"],
    ["--dropout_impl", "rng", "--rnn_impl", "scan", "--encoder_impl", "xla"],
], ids=["dropout_rng_rbg", "dropout_impl_rng", "encoder_impl_xla",
        "tip_tpu_defaults"])
def test_cli_train_flags_train_on_cpu(flags, tmp_path):
    """The flags that raised before the rng masks and the xla loop were
    ported now train, and so does tip_tpu's default flag set: two epochs
    on two in-tree motions, a finite loss, the checkpoint, and the model
    configuration the flags name."""
    TCC.main(["--data_root", os.path.dirname(CORPUS), "--datasets",
              "corpus_extra", "--rates", "60", "--name_contains",
              "freeform2_000[01]", "--out_prefix", str(tmp_path / "d")])
    state = TCT.main([
        "--data_prefix", str(tmp_path / "d"), "--save_path",
        str(tmp_path / "run"), "--batch_size", "8", "--seq_len", "10",
        "--epochs", "2", "--with_acc_sum", "--tf_in_dim", "32", "--tf_nhid",
        "64", "--n_heads", "4", "--tf_layers", "2", "--rnn_nhid", "24",
        "--device", "cpu", *flags])
    assert state.step > 0
    assert os.path.exists(tmp_path / "run" / "ckpt_2.pt")
    lines = [json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")]
    means = [r["mean_loss"] for r in lines if "mean_loss" in r]
    assert len(means) == 2 and all(np.isfinite(means))
    cfg = state.model.cfg
    given = dict(zip(flags[::2], flags[1::2]))
    assert cfg.dropout_impl == given.get("--dropout_impl", "hash")
    assert cfg.encoder_impl == ("xla" if given.get("--encoder_impl") == "xla"
                                else "auto")
    assert cfg.rnn_impl == ("plain" if given.get("--rnn_impl") == "scan"
                            else "auto")
