"""Offline evaluation harness, the system's integration test (twin of
tip_tpu/eval_harness.py).

Equivalent of the reference's offline_testing_simple.py:78-461: stream
recorded IMU pickles through the runner, trim the algorithmic latency, FK
both trajectories and report the 8-metric suite (means and the worst
motion of each metric), with the SBP contact-flag counts and, for the full
runner, the terrain metrics as extras.

Each motion runs through the port's ``run_offline`` (or
``run_offline_full`` with ``collect_updates``) with a ``TIPModel`` on
``cuda`` unless the caller passes ``device="cpu"``; the metrics are the
port's ops/metrics.py over FK of whole trajectories (one batched call a
trajectory). The crops, the seeds (``random.seed``, ``np.random.seed``,
``SeedSequence([seed, motion index])`` for the corruption), the SBP counts
and the terrain extras follow tip_tpu line for line, so the same files
pick the same windows.
"""

import dataclasses
import os
import pickle
import random
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch import resolve_device
from tip_tpu_torch.models import tip_model as M
from tip_tpu_torch.ops import kinematics as kin
from tip_tpu_torch.ops import metrics as metrics_lib
from tip_tpu_torch.runtime import full_runner as full_runner_lib
from tip_tpu_torch.runtime import runner as runner_lib
from tip_tpu_torch.runtime import terrain as terrain_lib

METRIC_NAMES = ("angle_deg", "sip_deg", "j_pos_cm", "root_drift_2s",
                "root_drift_5s", "root_drift_10s", "jerk", "root_jerk")

# SBP channel order = chars.amass.SBP_LINKS
SBP_CHANNEL_NAMES = ("lankle", "rankle", "lwrist", "rwrist", "root")


def sbp_flag_counts(gt_c: np.ndarray, pred_c: np.ndarray) -> np.ndarray:
    """Per-channel confusion counts of the SBP contact flags.

    Both inputs are (T, n_sbps*4) constraint rows [flag, offset xyz]: the
    ground-truth labels from the data pipeline and the runner's predicted
    track, time-aligned (latency-trimmed, cropped). Returns (n_sbps, 4)
    int64 [TP, FP, FN, TN] counts.
    """
    gt = gt_c.reshape(len(gt_c), -1, 4)[:, :, 0] > 0.5
    pr = pred_c.reshape(len(pred_c), -1, 4)[:, :, 0] > 0.5
    tp = (gt & pr).sum(0)
    fp = (~gt & pr).sum(0)
    fn = (gt & ~pr).sum(0)
    tn = (~gt & ~pr).sum(0)
    return np.stack([tp, fp, fn, tn], axis=1).astype(np.int64)


def summarize_sbp_counts(counts: np.ndarray) -> Dict[str, Dict[str, float]]:
    """(n_sbps, 4) [TP,FP,FN,TN] -> per-channel precision/recall/F1 plus the
    ground-truth positive rate (micro-averaged over all eval frames)."""
    out = {}
    for i, name in enumerate(SBP_CHANNEL_NAMES[:len(counts)]):
        tp, fp, fn, tn = (float(v) for v in counts[i])
        n = tp + fp + fn + tn
        prec = tp / (tp + fp) if tp + fp > 0 else float("nan")
        rec = tp / (tp + fn) if tp + fn > 0 else float("nan")
        f1 = (2 * prec * rec / (prec + rec)
              if prec + rec > 0 and np.isfinite(prec + rec) else float("nan"))
        out[name] = {"precision": round(prec, 4), "recall": round(rec, 4),
                     "f1": round(f1, 4),
                     "gt_pos_rate": round((tp + fn) / n, 4) if n else 0.0}
    return out


@dataclasses.dataclass
class EvalConfig:
    runner: runner_lib.RunnerConfig = runner_lib.RunnerConfig()
    use_full_runner: bool = False       # terrain-aware RTRunner equivalent
    # SBP-conditioned IK history feedback + pelvis-terrain updates
    # (reference RTRunner MULTI_SBP_CORRECTION, offline_testing_simple.py:163)
    multi_sbp: bool = False
    test_len: int = 30000
    max_motions_per_cat: int = 50       # reference MAX_TEST_MOTION_PRE_CAT
    seed: int = 42
    crop_head: int = 30                 # first 0.5 s uninteresting (ref :437)
    crop_tail: int = 6
    root_z_lift: float = 0.05           # amass floor calibration (ref :387)
    # Terrain grid half-extent for the full runner, in metres: the
    # reference's +-5 m map by default (constants.MAP_BOUND). Raise it for
    # corpora whose roots wander beyond it (the fixed-capacity grid clamps
    # out-of-bound SBPs to the edge cell).
    terrain_map_bound: float = cst.MAP_BOUND
    # off-distribution sensor corruption (eval_corruption.CorruptionConfig):
    # applied to each motion's IMU stream after cropping, deterministically
    # from (seed, motion index). None = clean streams.
    corruption: Optional[object] = None


def collect_test_files(data_root: str, dirs: Sequence[str],
                       name_contains: Sequence[str]) -> List[str]:
    """Regex-select test pickles (reference :283-300)."""
    out = []
    for d in dirs:
        full = os.path.join(data_root, d)
        if not os.path.isdir(full):
            continue
        for n in sorted(os.listdir(full)):
            if not n.endswith("pkl"):
                continue
            p = os.path.join(full, n)
            if any(re.search(nc, p, re.IGNORECASE) for nc in name_contains):
                out.append(p)
    return out


def _run_dtype(model: M.TIPModel) -> torch.dtype:
    return next(model.parameters()).dtype


def run_motion(model: M.TIPModel, cfg: EvalConfig, skel: kin.Skeleton,
               imu: np.ndarray, s_gt: np.ndarray, device=None):
    """Stream one motion through the model (on ``device``, ``cuda`` unless
    given; the model and skeleton already there); returns (the
    latency-trimmed predicted trajectory (T, 114) as numpy, info dict with
    the SBP marker track and, for the full runner, the final terrain
    state). The stream and the first state enter as float32, as tip_tpu's
    do."""
    device = resolve_device(device)
    dtype = _run_dtype(model)
    s_init = torch.as_tensor(np.asarray(s_gt[0], np.float32)).to(device,
                                                                   dtype)
    imu = torch.as_tensor(np.asarray(imu, np.float32)).to(device, dtype)
    info = {}
    if cfg.use_full_runner:
        fcfg = full_runner_lib.FullRunnerConfig(
            base=cfg.runner, multi_sbp=cfg.multi_sbp,
            terrain=terrain_lib.TerrainConfig(
                map_bound=cfg.terrain_map_bound))
        s_traj, c_traj, viz, upd, final = full_runner_lib.run_offline_full(
            model, fcfg, skel, s_init, imu, collect_updates=True,
            device=device)
        info["terrain"] = final.terrain
        info["terrain_cfg"] = fcfg.terrain
        info["viz_raw"] = viz.cpu().numpy()     # untrimmed (terrain replay)
        info["upd"] = upd.cpu().numpy()
    else:
        s_traj, c_traj, viz = runner_lib.run_offline(
            model, cfg.runner, skel, s_init, imu, device=device)
    trim = cfg.runner.imu_n_smooth + 2
    info["viz_locs"] = runner_lib.trim_latency(viz.cpu().numpy(), trim)
    info["c_traj"] = runner_lib.trim_latency(c_traj.cpu().numpy(), trim)
    return runner_lib.trim_latency(s_traj.cpu().numpy(), trim), info


def compute_metrics(skel: kin.Skeleton, gt_qdq: np.ndarray,
                    pred_qdq: np.ndarray, cfg: EvalConfig) -> Dict[str, float]:
    """FK both trajectories and evaluate the 8 metrics (reference
    :414-445), on the skeleton's device and in its dtype from float32
    states (as tip_tpu computes them): one batched pose conversion and one
    batched FK a trajectory."""
    dev, dtype = skel.joint_offset.device, skel.joint_offset.dtype

    def to_bullet(s):
        s32 = torch.as_tensor(np.asarray(s, np.float32), device=dev)
        return kin.our_pose_to_bullet(s32).to(dtype)

    aa1, aa2 = to_bullet(gt_qdq), to_bullet(pred_qdq)
    lo, hi = cfg.crop_head, len(aa1) - cfg.crop_tail
    aa1, aa2 = aa1[lo:hi], aa2[lo:hi]
    args = (aa1, aa2, kin.fk_bullet_state(skel, aa1),
            kin.fk_bullet_state(skel, aa2))
    out = {
        "angle_deg": metrics_lib.loss_angle(*args),
        "sip_deg": metrics_lib.loss_sip(*args),
        "j_pos_cm": metrics_lib.loss_j_pos(*args),
        "root_drift_2s": metrics_lib.loss_root_dist_pos(*args, t=2.0),
        "root_drift_5s": metrics_lib.loss_root_dist_pos(*args, t=5.0),
        "root_drift_10s": metrics_lib.loss_root_dist_pos(*args, t=10.0),
        "jerk": metrics_lib.loss_max_jerk(*args),
        "root_jerk": metrics_lib.loss_root_jerk(*args),
    }
    vals = torch.stack([out[k] for k in METRIC_NAMES]).cpu().tolist()
    return dict(zip(METRIC_NAMES, (float(v) for v in vals)))


def evaluate(model: M.TIPModel, cfg: EvalConfig, test_files: Sequence[str],
             skel: Optional[kin.Skeleton] = None, log=print,
             save_trajs_path: Optional[str] = None,
             viz_hook=None, metrics_writer=None, extras_out=None,
             device=None):
    """Full harness over a list of per-motion pickles, on ``device``
    (``cuda`` unless given; the model already there). Returns (per_motion
    list of metric dicts, means dict, maxima dict).

    skel: the skeleton in the model's dtype on the device (the AMASS
    humanoid when None).
    save_trajs_path: optional pkl dump of {gt_list, ours_list, files}, the
    reference's raw-trajectory artifact (offline_testing_simple.py:414-420,
    test-output-tmp.pkl).
    viz_hook: optional callable(file, gt_qdq, pred_qdq, info) invoked per
    motion after metrics.
    metrics_writer: optional utils.observability.MetricsWriter; receives one
    per-motion record and a final means/maxima record.
    extras_out: optional dict the harness fills with aggregate capability
    metrics beyond the reference's 8: "sbp" (per-channel contact-flag
    precision/recall against the ground-truth labels) and, for full-runner
    configs, "terrain" and "terrain_by_family" (height-map reconstruction
    quality against the labeled ground truth, eval_terrain.py)."""
    device = resolve_device(device)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    skel = skel or kin.amass_skeleton(dtype=_run_dtype(model),
                                      device=device)

    files = list(test_files)
    if len(files) > cfg.max_motions_per_cat:
        files = random.sample(files, cfg.max_motions_per_cat)

    per_motion, used = [], []
    gt_list, ours_list = [], []
    sbp_counts = None
    terrain_accum = []
    for f in files:
        if not os.path.exists(f):
            log(f"ignored {f}")
            continue
        with open(f, "rb") as fh:
            data = pickle.load(fh)
        X, Y = np.asarray(data["imu"]), np.asarray(data["nimble_qdq"])
        C = (np.asarray(data["constrs"])
             if extras_out is not None and "constrs" in data else None)
        if Y.shape[0] < 2.5 / cst.DT:
            continue
        if Y.shape[0] > cfg.test_len:
            start = random.randrange(0, Y.shape[0] - cfg.test_len)
            X = X[start:start + cfg.test_len]
            Y = Y[start:start + cfg.test_len]
            if C is not None:
                C = C[start:start + cfg.test_len]
        m_len = min(len(X), len(Y))
        X, Y = X[:m_len], Y[:m_len].copy()
        Y[:, 2] += cfg.root_z_lift
        if cfg.corruption is not None:
            from tip_tpu_torch import eval_corruption
            crng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, len(used)]))
            X = eval_corruption.corrupt_imu(X, cfg.corruption, crng)

        pred, info = run_motion(model, cfg, skel, X, Y, device=device)
        per_motion.append(compute_metrics(skel, Y, pred, cfg))
        used.append(f)
        if C is not None and "c_traj" in info:
            lo, hi = cfg.crop_head, m_len - cfg.crop_tail
            counts = sbp_flag_counts(C[:m_len][lo:hi],
                                     np.asarray(info["c_traj"])[lo:hi])
            sbp_counts = counts if sbp_counts is None else sbp_counts + counts
        if extras_out is not None and "terrain" in info:
            from tip_tpu_torch import eval_terrain
            terrain_accum.append(eval_terrain.motion_terrain_metrics(
                skel, Y, C[:m_len] if C is not None else None,
                info["terrain"], info["terrain_cfg"],
                viz=info["viz_raw"], upd=info["upd"], pred_qdq=pred))
        if save_trajs_path:
            gt_list.append(Y)
            ours_list.append(pred)
        if viz_hook is not None:
            viz_hook(f, Y, pred, info)
        if metrics_writer is not None:
            metrics_writer.write(kind="motion", file=f, **per_motion[-1])
        log(f"{f}: {per_motion[-1]}")

    if save_trajs_path:
        with open(save_trajs_path, "wb") as fh:
            pickle.dump({"gt_list": gt_list, "ours_list": ours_list,
                         "files": used}, fh, protocol=pickle.HIGHEST_PROTOCOL)

    means = {k: float(np.mean([m[k] for m in per_motion]))
             for k in METRIC_NAMES} if per_motion else {}
    maxima = {}
    for k in METRIC_NAMES:
        if not per_motion:
            break
        vals = [m[k] for m in per_motion]
        i = int(np.argmax(vals))
        maxima[k] = (float(vals[i]), used[i])
    if metrics_writer is not None:
        metrics_writer.write(kind="summary", n_motions=len(per_motion),
                             means=means,
                             maxima={k: {"value": v, "file": f}
                                     for k, (v, f) in maxima.items()})
    if extras_out is not None:
        if sbp_counts is not None:
            extras_out["sbp"] = summarize_sbp_counts(sbp_counts)
        if terrain_accum:
            from tip_tpu_torch import eval_terrain
            extras_out["terrain"] = eval_terrain.summarize(terrain_accum)
            # per-family breakdown (corpus filename convention
            # <family>_<idx>.pkl): the drift-decoupled map error is only
            # meaningful on contact-rich families, so report it per family
            by_fam = {}
            for f, row in zip(used, terrain_accum):
                fam = os.path.basename(f).rsplit("_", 1)[0]
                by_fam.setdefault(fam, []).append(row)
            extras_out["terrain_by_family"] = {
                fam: eval_terrain.summarize(rows)
                for fam, rows in sorted(by_fam.items())}
    return per_motion, means, maxima
