"""scripts/torch_e2e_synthetic_demo.py and scripts/torch_eval_corruption.py,
the port's twins of scripts/e2e_synthetic_demo.py and
scripts/eval_corruption.py, on the CPU at a small size.

The demo's ``make_motion`` equals tip_tpu's script's bit for bit from the
same numpy stream; its pipeline at a small width (2 layers, d 32), 2 + 1
motions and 1 epoch runs through synthesis, packing, training and both
evaluations and prints both means (the learning assertion is for the
card's full-size run). Each rung of the sweep twin (``run_rung``), on the
clean rung and the first rung of each kind of corruption, equals tip_tpu's
``eval_harness.evaluate`` under the EvalConfig its script builds for that
rung, on 1 in-tree motion and 120 frames, with the weights of
tests/data/orbax_tiny (5 SBPs, acc-sum, small widths) read by each
package's own restore and cast to float64. tip_tpu's harness feeds its
runner float32 states and computes the metrics from float32 trajectories
(tip_tpu/eval_harness.py:127-136, 152-153), so the two agree to
TOL_METRIC relative (tests/test_torch_eval.py's tolerance for two runs
that round in float32), not to float64 precision.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tip_tpu import constants as jcst
from tip_tpu import eval_corruption as JC
from tip_tpu import eval_harness as JH
from tip_tpu.models import tip_model as JM
from tip_tpu.runtime import runner as JR
from tip_tpu_torch import eval_corruption as TC
from tip_tpu_torch import eval_harness as TH

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "orbax_tiny"
MOTION = str(ROOT / "artifacts" / "corpus_run_v3" / "corpus_extra"
             / "freeform2_0000.pkl")
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
SWEEP_LEN = 120
TOL_METRIC = 2e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DEMO = _load("torch_e2e_synthetic_demo")
JDEMO = _load("e2e_synthetic_demo")
SWEEP = _load("torch_eval_corruption")
JSWEEP_TRAIN = _load("train_convergence")


@pytest.mark.parametrize("seed", [7, 11, 12345])
def test_make_motion_equals_tip_tpus(seed):
    rng_t, rng_j = (np.random.default_rng(seed) for _ in range(2))
    for _ in range(2):               # the stream goes on from motion to motion
        t, j = DEMO.make_motion(rng_t), JDEMO.make_motion(rng_j)
        np.testing.assert_array_equal(t.poses, j.poses)
        np.testing.assert_array_equal(t.trans, j.trans)
        assert t.fps == j.fps


def test_demo_pipeline_runs_at_a_small_width(tmp_path, capsys):
    from tip_tpu_torch.models.tip_model import ModelConfig
    res = DEMO.run(DEMO.parse_args([
        "--epochs", "1", "--n_train", "2", "--n_test", "1",
        "--out", str(tmp_path), "--device", "cpu"]), ModelConfig(**TINY))
    out = capsys.readouterr().out
    assert "synthesized 3 motions" in out and "trained 1 epochs" in out
    assert "untrained:" in out and "trained:  " in out
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(res))
    for name in ("untrained", "trained"):
        assert set(res[name]) == set(TH.METRIC_NAMES)
        assert all(np.isfinite(v) for v in res[name].values())
    # one epoch over 2 motions of 202 frames at 60 Hz (322 windows): one
    # batch of 256
    assert res["steps"] == 1 and res["train_frames"] == 2 * 202
    assert len(list((tmp_path / "syn_DEMO_v1").iterdir())) == 2
    assert (tmp_path / "ckpt").is_dir()


def test_demo_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DEMO.run(DEMO.parse_args(["--out", str(tmp_path)]))
    assert not list(tmp_path.iterdir())


@pytest.fixture(scope="module")
def restored():
    """The fixture's weights by each package's own restore, in float64:
    tip_tpu's under its script's TrainConfig at the small widths, the
    port's under the twin's (make_train_cfg with the widths cut)."""
    from tip_tpu.train import train as JT
    from tip_tpu_torch.train import train as TT
    import torch_train_convergence as TTC
    jcfg = JSWEEP_TRAIN.make_train_cfg(1100)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, **TINY))
    params = JT.restore_checkpoint(str(FIXTURE), jcfg,
                                   params_only=True).params
    params = jax.tree_util.tree_map(lambda p: np.asarray(p, np.float64),
                                    params)
    tstate = TT.restore_checkpoint(str(FIXTURE),
                                   TTC.make_train_cfg(1100, **TINY),
                                   params_only=True, device="cpu")
    weights = {k: v.detach().double()
               for k, v in tstate.model.state_dict().items()}
    return params, weights


RUNGS = [c.label() for c in SWEEP.first_of_each_kind(TC.SWEEP)]


def test_rungs_cover_each_kind():
    assert RUNGS == ["clean", "bias0.1", "calib2deg", "drop0.2Hz"]
    assert [c.label() for c in TC.SWEEP] == [c.label() for c in JC.SWEEP]


@pytest.mark.parametrize("label", RUNGS)
def test_sweep_rung_equals_tip_tpus(restored, label):
    params, weights = restored
    jcor = next(c for c in JC.SWEEP if c.label() == label)
    tcor = next(c for c in TC.SWEEP if c.label() == label)
    # tip_tpu's scripts/eval_corruption.py:79-84 at the small widths
    jmodel = JM.ModelConfig(size_s=jcst.state_dim(5), with_acc_sum=True,
                            **TINY)
    jcfg = JH.EvalConfig(
        runner=JR.RunnerConfig(model=jmodel, n_sbps=5, with_acc_sum=True,
                               serving_mode="recompute"),
        test_len=SWEEP_LEN, max_motions_per_cat=1,
        corruption=None if label == "clean" else jcor)
    (jm,), jmeans, jmax = JH.evaluate(params, jcfg, [MOTION],
                                      log=lambda *a: None)
    tmodel = dataclasses.replace(SWEEP.eval_model_config(), **TINY)
    (tm,), tmeans, tmax, _, launches = SWEEP.run_rung(
        weights, tmodel, tcor, [MOTION], "recompute", SWEEP_LEN, "cpu")
    assert launches == {}               # the plain versions on the CPU
    assert set(tm) == set(jm) == set(TH.METRIC_NAMES)
    for k in TH.METRIC_NAMES:
        assert abs(tm[k] - jm[k]) <= TOL_METRIC * max(1.0, abs(jm[k])), \
            (k, tm[k], jm[k])
        assert tmeans[k] == tm[k] and tmax[k][1] == jmax[k][1] == MOTION


def test_sweep_eval_config_is_tip_tpus():
    """The twin's rung EvalConfig has the fields tip_tpu's script sets."""
    cor = TC.SWEEP[4]
    cfg = SWEEP.rung_eval_config(cor, SWEEP.eval_model_config(), "kv_cache",
                                 690, 20)
    assert (cfg.test_len, cfg.max_motions_per_cat, cfg.corruption) == \
        (690, 20, cor)
    assert (cfg.runner.n_sbps, cfg.runner.with_acc_sum,
            cfg.runner.serving_mode) == (5, True, "kv_cache")
    assert cfg.runner.model.size_s == jcst.state_dim(5)
    assert SWEEP.rung_eval_config(TC.SWEEP[0], cfg.runner.model,
                                  "recompute", 690, 20).corruption is None


def test_sweep_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SWEEP.main(["--out", str(tmp_path)])



def test_sweep_cache_needs_the_same_run(tmp_path):
    """A results file is reused only where step, mode, n_test, test_len
    and device all match; any other file is started afresh."""
    key = {"step": 389400, "mode": "recompute", "n_test": 60,
           "test_len": 690, "device": "cuda"}
    path = tmp_path / "corruption.json"
    assert SWEEP.cached_results(str(path), key) == {**key, "rungs": {}}
    cached = {**key, "card": "x", "rungs": {"clean": {"eval_s": 1.0}}}
    path.write_text(json.dumps(cached))
    assert SWEEP.cached_results(str(path), key) == cached
    for k, v in [("step", 713900), ("mode", "kv_cache"), ("n_test", 20),
                 ("test_len", 300), ("device", "cpu")]:
        other = {**key, k: v}
        assert SWEEP.cached_results(str(path), other) == \
            {**other, "rungs": {}}, k
    # tip_tpu's own layout (no test_len, no device) is never reused
    path.write_text(json.dumps({"step": 389400, "mode": "recompute",
                                "n_test": 60, "rungs": {"clean": {}}}))
    assert SWEEP.cached_results(str(path), key)["rungs"] == {}


def test_sweep_default_out_is_the_ports():
    assert Path(SWEEP.parse_args([]).out) == ROOT / "output"
