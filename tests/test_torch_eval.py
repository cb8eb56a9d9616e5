"""The port's evaluation surface (tip_tpu_torch/eval_harness.py,
eval_corruption.py, data_gen/dip.py's imputation, cli/evaluate.py and
cli/import_torch_ckpt.py) against tip_tpu's on the same numpy inputs, on
the CPU.

The host-side pieces (the imputation, each rung of the corruption sweep,
the SBP counts and their summary, the file selection) are exact; the
metrics of one trajectory pair agree to 1e-6; ``evaluate`` end to end over
in-tree motions at ``test_len`` 300, with the small model of
tests/test_torch_runner.py in float32 (tip_tpu's harness feeds its runner
float32 states), picks the same files and windows and gives the same SBP
counts, and its 8 metrics agree to TOL_METRIC, in the minimal runner and in
the full runner with its extras.
"""

import os
import pickle
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tip_tpu import eval_corruption as JC
from tip_tpu import eval_harness as JH
from tip_tpu.cli import evaluate as JCLI
from tip_tpu.data_gen import dip as JD
from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import runner as JR
from tip_tpu_torch import eval_corruption as TC
from tip_tpu_torch import eval_harness as TH
from tip_tpu_torch.cli import evaluate as TCLI
from tip_tpu_torch.cli import import_torch_ckpt as TIMP
from tip_tpu_torch.data_gen import dip as TD
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import runner as TR
from tip_tpu_torch.train import train as TT

torch.set_num_threads(1)

CORPUS = (Path(__file__).resolve().parents[1] / "artifacts" / "corpus_run_v3"
          / "corpus_extra")
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
# the metrics of two float32 runs over 300 autoregressive frames (XLA's
# and torch's sums in other orders; 4.5e-6 the largest, root_jerk),
# relative to the metric or absolute near 0; one trajectory pair's: 1e-6
TOL_METRIC = 2e-5
TOL_PAIR = 1e-6


def _close(a, b, tol=TOL_METRIC):
    return abs(a - b) <= tol * max(1.0, abs(b))


def _same(a, b, tol=0.0):
    """Nested dicts, lists and numbers equal (NaN equal to NaN; numbers
    within tol relative)."""
    if isinstance(b, dict):
        return (isinstance(a, dict) and set(a) == set(b)
                and all(_same(a[k], b[k], tol) for k in b))
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y, tol)
                                        for x, y in zip(a, b))
    if isinstance(b, (int, float, np.floating, np.integer)) and not \
            isinstance(b, bool):
        if np.isnan(b):
            return bool(np.isnan(a))
        return abs(a - b) <= tol * max(1.0, abs(b))
    return a == b


def _motion(i=0, n=None):
    with open(CORPUS / f"freeform2_{i:04d}.pkl", "rb") as f:
        d = pickle.load(f)
    return {k: np.asarray(d[k][:n]) for k in ("imu", "nimble_qdq",
                                              "constrs")}


# ---------------------------------------------------------------------------
# host-side pieces, exact
# ---------------------------------------------------------------------------

def _dropped(seed):
    """A (40, 6, 3, 3) / (40, 6, 3) stream with NaN bursts (one in the
    first 10 frames), as corrupt_imu leaves it before the repair."""
    rng = np.random.default_rng(seed)
    ori = rng.normal(size=(40, 6, 3, 3))
    acc = rng.normal(size=(40, 6, 3))
    ori[3:5, 1] = np.nan
    ori[20:27, 4] = np.nan
    acc[12:15, 0] = np.nan
    acc[30:38, 5] = np.nan
    return ori, acc


def test_fill_nan_trailing_mean_equals_tip_tpus():
    ori, acc = _dropped(0)
    jo, ja = JD.fill_nan_trailing_mean(ori.copy(), acc.copy())
    to, ta = TD.fill_nan_trailing_mean(ori.copy(), acc.copy())
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ta, ja)
    assert np.isfinite(to).all() and np.isfinite(ta).all()


def test_fill_nan_trailing_mean_refuses_a_gap_with_no_data():
    ori, acc = _dropped(1)
    ori[:12, 2] = np.nan
    with pytest.raises(ValueError, match="no data"), \
            np.errstate(invalid="ignore"), \
            pytest.warns(RuntimeWarning, match="Mean of empty slice"):
        TD.fill_nan_trailing_mean(ori, acc)


@pytest.mark.parametrize("rung", range(len(JC.SWEEP)),
                         ids=lambda i: JC.SWEEP[i].label())
def test_corrupt_imu_equals_tip_tpus_for_each_rung(rung):
    """The same draws in the same order: one seed corrupts the stream as
    tip_tpu does."""
    imu = _motion(1, 300)["imu"].astype(np.float32)
    jcfg, tcfg = JC.SWEEP[rung], TC.SWEEP[rung]
    assert tcfg.label() == jcfg.label()
    assert TC.CorruptionConfig(**vars(jcfg)) == tcfg
    j = JC.corrupt_imu(imu, jcfg, np.random.default_rng(
        np.random.SeedSequence([42, rung])))
    t = TC.corrupt_imu(imu, tcfg, np.random.default_rng(
        np.random.SeedSequence([42, rung])))
    assert t.dtype == j.dtype == np.float32 and np.isfinite(t).all()
    np.testing.assert_array_equal(t, j)
    o, a = TC.split_features(imu)
    np.testing.assert_array_equal(TC.merge_features(o, a), imu)


def test_sbp_counts_and_summary_equal_tip_tpus():
    rng = np.random.default_rng(3)
    gt = rng.normal(size=(200, 20))
    pred = rng.normal(size=(200, 20))
    gt[:, 0::4] = rng.random((200, 5)) < 0.3
    pred[:, 0::4] = rng.random((200, 5)) < 0.4
    gt[:, 12] = 0.0                   # a channel with no positives: NaNs
    pred[:, 12] = 0.0
    j = JH.sbp_flag_counts(gt, pred)
    t = TH.sbp_flag_counts(gt, pred)
    assert t.dtype == np.int64
    np.testing.assert_array_equal(t, j)
    assert _same(TH.summarize_sbp_counts(t), JH.summarize_sbp_counts(j))
    assert TH.SBP_CHANNEL_NAMES == JH.SBP_CHANNEL_NAMES
    assert TH.METRIC_NAMES == JH.METRIC_NAMES


def test_collect_test_files_equals_tip_tpus(tmp_path):
    for d, names in (("syn_KIT_v0", ("a_walk.pkl", "b_RUN.pkl", "c.txt")),
                     ("syn_SFU_v0", ("walk_1.pkl", "sit_2.pkl"))):
        (tmp_path / d).mkdir()
        for n in names:
            (tmp_path / d / n).write_bytes(b"")
    dirs = ["syn_KIT_v0", "syn_SFU_v0", "syn_missing_v0"]
    for pats in (["walk"], ["run", "sit"], [""], []):
        assert TH.collect_test_files(str(tmp_path), dirs, pats) == \
            JH.collect_test_files(str(tmp_path), dirs, pats)
    assert TCLI.TEST_DIRS_V0 == JCLI.TEST_DIRS_V0


def test_compute_metrics_equals_tip_tpus():
    """Ground truth against a perturbed copy of it (in-tree motion, 300
    frames), float32 skeletons on both sides: 1e-6."""
    m = _motion(2, 300)
    gt = m["nimble_qdq"].astype(np.float64)
    rng = np.random.default_rng(4)
    pred = gt + rng.normal(size=gt.shape) * 0.02
    pred[:, :3] += np.linspace(0, 0.3, len(gt))[:, None]     # drift
    cfg = TH.EvalConfig()
    j = JH.compute_metrics(jkin.amass_skeleton(), gt, pred,
                           JH.EvalConfig())
    t = TH.compute_metrics(tkin.amass_skeleton(), gt, pred, cfg)
    assert set(t) == set(TH.METRIC_NAMES)
    for k in TH.METRIC_NAMES:
        assert _close(t[k], j[k], TOL_PAIR), (k, t[k], j[k])
        assert t[k] > 0.0


# ---------------------------------------------------------------------------
# evaluate end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_models():
    """tip_tpu's harness feeds its runner float32 states (a float64 model
    would not match the scan's carry), so both sides run float32."""
    jcfg = JM.ModelConfig(**TINY)
    params = jax.tree_util.tree_map(
        lambda p: p.astype(np.float32),
        JM.init_params(jax.random.PRNGKey(0), jcfg))
    model = TM.TIPModel(TM.ModelConfig(**TINY), device="cpu",
                        dtype=torch.float32)
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model


# name -> (EvalConfig kwargs, files): the minimal runner picks 2 of 3
# motions (random.sample) and crops each to test_len with
# random.randrange; the full runner with multi_sbp and the extras
CASES = {
    "minimal": (dict(max_motions_per_cat=2), (0, 1, 2)),
    "full": (dict(use_full_runner=True, multi_sbp=True), (3, 4)),
}


@pytest.fixture(scope="module")
def evaluations(tiny_models, tmp_path_factory):
    params, model = tiny_models
    out = {}
    for name, (kw, idx) in CASES.items():
        files = [str(CORPUS / f"freeform2_{i:04d}.pkl") for i in idx]
        res = {}
        for side in ("jax", "torch"):
            path = tmp_path_factory.mktemp(f"{name}_{side}") / "trajs.pkl"
            extras = {}
            if side == "jax":
                cfg = JH.EvalConfig(
                    runner=JR.RunnerConfig(model=JM.ModelConfig(**TINY)),
                    test_len=300, **kw)
                got = JH.evaluate(params, cfg, files,
                                  skel=jkin.amass_skeleton(),
                                  log=lambda *_: None, save_trajs_path=path,
                                  extras_out=extras)
            else:
                cfg = TH.EvalConfig(
                    runner=TR.RunnerConfig(model=TM.ModelConfig(**TINY)),
                    test_len=300, **kw)
                got = TH.evaluate(model, cfg, files,
                                  skel=tkin.amass_skeleton(),
                                  log=lambda *_: None, save_trajs_path=path,
                                  extras_out=extras, device="cpu")
            with open(path, "rb") as f:
                trajs = pickle.load(f)
            res[side] = (got, extras, trajs)
        out[name] = res
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluate_picks_the_same_files_and_windows(evaluations, name):
    j, t = evaluations[name]["jax"][2], evaluations[name]["torch"][2]
    assert t["files"] == j["files"] and len(t["files"]) == 2
    for a, b in zip(t["gt_list"], j["gt_list"]):
        np.testing.assert_array_equal(a, b)
        assert len(a) == 300


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("metric", TH.METRIC_NAMES)
def test_evaluate_metrics_equal_tip_tpus(evaluations, name, metric):
    (jm, jmeans, jmax), _, _ = evaluations[name]["jax"]
    (tm, tmeans, tmax), _, _ = evaluations[name]["torch"]
    assert len(tm) == len(jm) == 2
    for a, b in zip(tm, jm):
        assert _close(a[metric], b[metric]), (a[metric], b[metric])
    assert _close(tmeans[metric], jmeans[metric])
    assert tmax[metric][1] == jmax[metric][1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluate_extras_equal_tip_tpus(evaluations, name):
    """The SBP counts' summary exactly; the full runner's terrain metrics
    and their per-family breakdown to TOL_METRIC."""
    je, te = evaluations[name]["jax"][1], evaluations[name]["torch"][1]
    assert set(te) == set(je)
    assert _same(te["sbp"], je["sbp"])
    if name == "full":
        assert set(te) == {"sbp", "terrain", "terrain_by_family"}
        for key in ("terrain", "terrain_by_family"):
            assert _same(te[key], je[key], TOL_METRIC), key


def test_evaluate_corrupted_streams_as_tip_tpu(tiny_models):
    """A corruption rung goes in after the crop, from (seed, motion
    index): the same metrics."""
    params, model = tiny_models
    files = [str(CORPUS / "freeform2_0005.pkl")]
    rung = JC.SWEEP[-1]
    jcfg = JH.EvalConfig(runner=JR.RunnerConfig(model=JM.ModelConfig(**TINY)),
                         test_len=200, corruption=rung)
    tcfg = TH.EvalConfig(runner=TR.RunnerConfig(model=TM.ModelConfig(**TINY)),
                         test_len=200, corruption=TC.SWEEP[-1])
    (jm,) = JH.evaluate(params, jcfg, files, skel=jkin.amass_skeleton(),
                        log=lambda *_: None)[0]
    (tm,) = TH.evaluate(model, tcfg, files, skel=tkin.amass_skeleton(),
                        log=lambda *_: None, device="cpu")[0]
    for k in TH.METRIC_NAMES:
        assert _close(tm[k], jm[k]), (k, tm[k], jm[k])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

class _Reference(torch.nn.Module):
    """The reference's TF_RNN_Past_State parameter layout, built from
    torch's own layers (in_linear, tf_encode, rnn, linear)."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.tf_in_dim
        self.in_linear = torch.nn.Linear(cfg.input_dim, d)
        self.tf_encode = torch.nn.TransformerEncoder(
            torch.nn.TransformerEncoderLayer(d, cfg.n_heads, cfg.tf_hid_size),
            cfg.tf_layers, enable_nested_tensor=False)
        self.rnn = torch.nn.RNN(d, cfg.rnn_hid_size)
        self.linear = torch.nn.Linear(cfg.rnn_hid_size, cfg.size_s)


@pytest.fixture(scope="module")
def reference_pt(tmp_path_factory):
    torch.manual_seed(7)
    cfg = TM.ModelConfig(with_acc_sum=True)
    sd = _Reference(cfg).state_dict()
    path = tmp_path_factory.mktemp("ref") / "model.pt"
    torch.save(sd, path)
    return path, sd, cfg


def test_import_torch_ckpt_round_trips_a_reference_state_dict(
        reference_pt, tmp_path):
    """The .pt becomes ckpt_0.pt of this package; restored (params only)
    its parameters equal params_from_torch_state_dict's, and tip_tpu's
    own import of the same state dict."""
    path, sd, cfg = reference_pt
    out = tmp_path / "imported"
    TIMP.main(["--pt", str(path), "--out", str(out), "--five_sbp",
               "--with_acc_sum", "--device", "cpu"])
    assert (out / "ckpt_0.pt").exists()
    state = TT.restore_checkpoint(str(out), TT.TrainConfig(model=cfg),
                                  params_only=True, device="cpu")
    want = TM.params_from_torch_state_dict(sd, cfg)
    got = dict(state.model.named_parameters())
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].detach(), v), k
    jparams = JM.params_from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()},
        JM.ModelConfig(with_acc_sum=True))
    jsd = TM.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for k, v in jsd.items():
        np.testing.assert_array_equal(got[k].detach().numpy(),
                                      v.numpy().astype(np.float32), k)


def test_evaluate_cli_over_a_data_root(reference_pt, tmp_path, capsys):
    """cli/evaluate over a data_root laid out as TEST_DIRS_V0: the .pt and
    the imported checkpoint give the same metrics, which equal the
    harness's own run; a directory that names itself an orbax step
    (``_CHECKPOINT_METADATA``) but holds no item raises, naming what is
    missing (tests/test_torch_orbax.py reads real ones)."""
    path, _, _ = reference_pt
    for d, i in (("syn_AMASS_CMU_v0", 6), ("syn_KIT_v0", 7)):
        (tmp_path / d).mkdir()
        shutil.copy(CORPUS / f"freeform2_{i:04d}.pkl", tmp_path / d)
    (tmp_path / "unlisted").mkdir()
    shutil.copy(CORPUS / "freeform2_0008.pkl", tmp_path / "unlisted")
    ck = tmp_path / "ckpt"
    TIMP.main(["--pt", str(path), "--out", str(ck), "--five_sbp",
               "--with_acc_sum", "--device", "cpu"])
    common = ["--data_root", str(tmp_path), "--name_contains", "freeform2",
              "--test_len", "160", "--five_sbp", "--with_acc_sum",
              "--device", "cpu", "--extras"]
    runs = [TCLI.main(["--ckpt", c] + common) for c in (str(path), str(ck))]
    (pm, means, _), (pm2, means2, _) = runs
    assert len(pm) == 2 and means == means2
    printed = capsys.readouterr().out
    assert "2 candidate motions" in printed and '"extras"' in printed
    model = TCLI.load_model(str(path), TM.ModelConfig(with_acc_sum=True), 5,
                            "cpu")
    files = TH.collect_test_files(str(tmp_path),
                                  TCLI.TEST_DIRS_V0, ["freeform2"])
    cfg = TH.EvalConfig(runner=TR.RunnerConfig(
        model=TM.ModelConfig(with_acc_sum=True)), test_len=160)
    _, direct, _ = TH.evaluate(model, cfg, files, log=lambda *_: None,
                               device="cpu")
    assert direct == means
    orbax = tmp_path / "orbax" / "389400"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for c in (orbax, orbax.parent):
        with pytest.raises(FileNotFoundError, match="no _METADATA under "
                           f"{orbax}"):
            TCLI.main(["--ckpt", str(c)] + common)
    assert os.path.isdir(ck)
