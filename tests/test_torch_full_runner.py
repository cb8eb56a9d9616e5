"""The port's full runner (tip_tpu_torch/runtime/full_runner.py) and its
terrain metrics (tip_tpu_torch/eval_terrain.py) against tip_tpu's.

``run_offline_full`` on the CPU (the wrappers run the kernels' plain
versions for CPU tensors: K2's and K3's, so the history takes the fused
tail's encode) and tip_tpu's (its XLA tail) stream the same 300 frames of
the in-tree motion through the same random weights in float64, at the
small size of tests/test_torch_runner.py: trajectories, SBP vectors and
contact locations agree to 1e-8, the terrain-update track and the final
region map exactly, the final heights and confidence to 1e-8. With
``multi_sbp`` on (pelvis terrain and leg IK feedback) and off, in
ground-truth playback (the motion's nimble_qdq and constrs), with the
plain tail (``tail_impl="plain"``, the plain FK) on both sides, and in the
``kv_cache`` serving mode over 80 frames. The terrain metrics of the
playback run equal tip_tpu's to 1e-9.
"""

import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tip_tpu import eval_terrain as JE
from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import full_runner as JF
from tip_tpu.runtime import runner as JR
from tip_tpu_torch import eval_terrain as TE
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import full_runner as TF
from tip_tpu_torch.runtime import runner as TR

torch.set_num_threads(1)

MOTION = (Path(__file__).resolve().parents[1] / "artifacts" / "corpus_run_v3"
          / "corpus_extra" / "freeform2_0000.pkl")
N_FRAMES = 300
CACHED_FRAMES = 80
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
TOL = 1e-8
# name -> (tip_tpu RunnerConfig / FullRunnerConfig kwargs, the port's)
CONFIGS = {
    "multi_sbp": (dict(), dict(), dict(multi_sbp=True)),
    "single_sbp": (dict(), dict(), dict(multi_sbp=False)),
    "playback_gt": (dict(), dict(), dict(multi_sbp=True, playback_gt=True)),
    "plain_tail": (dict(tail_impl="xla", fk_impl="xla"),
                   dict(tail_impl="plain", fk_impl="plain"),
                   dict(multi_sbp=True)),
    "kv_cache": (dict(serving_mode="kv_cache"),
                 dict(serving_mode="kv_cache"), dict(multi_sbp=True)),
}
OUTPUTS = ("s_traj", "c_traj", "viz", "upd")
STATE = ("region_map", "confidence", "region_height", "region_weight",
         "n_regions")


@pytest.fixture(scope="module")
def motion():
    with open(MOTION, "rb") as f:      # in-tree motion written by data gen
        d = pickle.load(f)
    return {k: np.asarray(d[k][:N_FRAMES], np.float64)
            for k in ("imu", "nimble_qdq", "constrs")}


@pytest.fixture(scope="module")
def weights():
    jcfg = JM.ModelConfig(**TINY)
    params = jax.tree_util.tree_map(
        lambda p: p.astype(np.float64),
        JM.init_params(jax.random.PRNGKey(0), jcfg))
    model = TM.TIPModel(TM.ModelConfig(**TINY), device="cpu",
                        dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model


def run_pair(name, motion, weights):
    """Both runners over the motion (CACHED_FRAMES in kv_cache): (tip_tpu's
    outputs, the port's, tip_tpu's final terrain, the port's), outputs as
    numpy in OUTPUTS order."""
    jkw, tkw, fkw = CONFIGS[name]
    params, model = weights
    n = CACHED_FRAMES if name == "kv_cache" else N_FRAMES
    imu = motion["imu"][:n]
    s_init = motion["nimble_qdq"][0]
    gt = {}
    if fkw.get("playback_gt"):
        gt = dict(s_gt=motion["nimble_qdq"][:n], c_gt=motion["constrs"][:n])
    jcfg = JF.FullRunnerConfig(
        base=JR.RunnerConfig(model=JM.ModelConfig(**TINY), **jkw), **fkw)
    *j_out, j_final = JF.run_offline_full(
        params, jcfg, jkin.amass_skeleton(dtype=np.float64), s_init, imu,
        collect_updates=True, **gt)
    tcfg = TF.FullRunnerConfig(
        base=TR.RunnerConfig(model=TM.ModelConfig(**TINY), **tkw), **fkw)
    *t_out, t_final = TF.run_offline_full(
        model, tcfg, tkin.amass_skeleton(dtype=torch.float64), s_init, imu,
        collect_updates=True, device="cpu", **gt)
    return ([np.asarray(a) for a in j_out], [a.numpy() for a in t_out],
            {k: np.asarray(getattr(j_final.terrain, k)) for k in STATE},
            t_final)


@pytest.fixture(scope="module")
def runs(motion, weights):
    return {name: run_pair(name, motion, weights) for name in CONFIGS}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("i,out", list(enumerate(OUTPUTS)))
def test_run_offline_full_matches_tip_tpu(runs, name, i, out):
    j, t = runs[name][0][i], runs[name][1][i]
    assert t.shape == j.shape, out
    if out == "upd":
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL, err_msg=out)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_final_terrain_matches_tip_tpu(runs, name):
    j, t = runs[name][2], runs[name][3].terrain
    np.testing.assert_array_equal(t.region_map.numpy(), j["region_map"])
    assert int(t.n_regions) == int(j["n_regions"])
    for k in ("confidence", "region_height", "region_weight"):
        np.testing.assert_allclose(getattr(t, k).numpy(), j[k], rtol=0,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", ["multi_sbp", "playback_gt"])
def test_terrain_path_is_exercised(runs, name):
    """The stream commits terrain updates: with random weights, multi_sbp
    makes 19 (7 lankle, 9 rankle, 3 pelvis) and 14 regions over the 300
    frames, and its IK feedback and pelvis slot move the trajectory away
    from the single-SBP run's; the playback of the labels (11 lankle
    contact frames there, none of the rankle) commits a few."""
    upd = runs[name][1][3]
    if name == "playback_gt":
        assert upd[:, 0].any()
        return
    np.testing.assert_array_equal(upd.sum(0), [7, 9, 3])
    assert int(runs[name][3].terrain.n_regions) == 14
    assert np.abs(runs["multi_sbp"][1][0]
                  - runs["single_sbp"][1][0]).max() > 1e-3


def test_playback_returns_the_ground_truth(runs, motion):
    s = runs["playback_gt"][1][0]
    np.testing.assert_array_equal(s[1:], motion["nimble_qdq"][:-1])


def test_multi_sbp_needs_five_sbps():
    base = TR.RunnerConfig(model=TM.ModelConfig(**TINY, size_s=119),
                           n_sbps=2, tail_impl="plain")
    with pytest.raises(ValueError, match="5-SBP"):
        TF.FullRunnerConfig(base=base, multi_sbp=True)
    TF.FullRunnerConfig(base=base, multi_sbp=False)


def test_motion_terrain_metrics_match_tip_tpu(runs, motion):
    """On the playback run's final map, updates and track, with the
    multi_sbp run's trajectory as the prediction (the drift-corrected
    metrics); and summarize over both."""
    jcfg, tcfg = JF.FullRunnerConfig().terrain, TF.FullRunnerConfig().terrain
    j_out, t_out, _, t_final = runs["playback_gt"]
    gt_qdq, gt_c = motion["nimble_qdq"], motion["constrs"]
    pred = runs["multi_sbp"][1][0]
    j_final = JF.full_runner_init(
        JF.FullRunnerConfig(), jkin.amass_skeleton(dtype=np.float64),
        gt_qdq[0], dtype=np.float64)
    # tip_tpu's metrics read only the terrain state
    j_state = type(j_final.terrain)(**{k: runs["playback_gt"][2][k]
                                       for k in STATE})
    j = JE.motion_terrain_metrics(jkin.amass_skeleton(dtype=np.float64),
                                  gt_qdq, gt_c, j_state, jcfg, j_out[2],
                                  j_out[3], pred_qdq=pred)
    t = TE.motion_terrain_metrics(tkin.amass_skeleton(dtype=torch.float64),
                                  gt_qdq, gt_c, t_final.terrain, tcfg,
                                  t_out[2], t_out[3], pred_qdq=pred)
    assert j is not None and set(t) == set(j)
    assert t["pct_path_established"] > 0 and np.isfinite(t["height_mae_m"])
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-9, err_msg=k)
    assert TE.summarize([t, None]) == JE.summarize([j, None])
    mask = TE.established_mask_from_updates(t_out[2], t_out[3], tcfg)
    np.testing.assert_array_equal(
        mask, t_final.terrain.confidence.numpy() > -99)
