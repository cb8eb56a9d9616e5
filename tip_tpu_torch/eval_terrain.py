"""Direct terrain-reconstruction quality metrics (twin of
tip_tpu/eval_terrain.py).

The paper's title capability, simultaneous terrain generation, measured
directly: the full runner's final height-region map against the ground
truth the character actually walked, rebuilt from the labeled SBP foot
contacts of the motion (FK of the ground-truth trajectory + the label
offsets, the construction the estimator sees, so systematic sensor-mount
offsets cancel).

Reported per motion (aggregated by ``summarize``):
  * ``height_mae_m``  — mean |estimated − ground-truth| height over
    established path cells;
  * ``height_bias_m`` — signed mean (estimated − ground-truth);
  * ``pct_path_established`` — share of ground-truth contact cells the
    runner established at all;
  * ``latency_s`` — mean delay from a cell's first ground-truth contact to
    its establishment in the map (from the runner's recorded update flags;
    0 for cells established earlier by a patch's spread).

With the predicted trajectory (``pred_qdq``), the drift-corrected variants
``height_mae_dc_m`` / ``height_bias_dc_m`` / ``pct_path_established_dc``
move each ground-truth contact sample by the instantaneous root drift
pred_root(t) − gt_root(t) before querying the map, which isolates the
terrain estimator's own error from the localization error.

Cell establishment times come from the (T, 3) update-flag track of
``runtime.full_runner.run_offline_full(collect_updates=True)``: every
committed update writes its whole (2d, 2d) confidence patch, so a cell is
established at the first update whose clamped patch covers it.

Host numpy throughout, but for the port's plain FK on the skeleton's device.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch.ops import kinematics as kin
from tip_tpu_torch.ops import sbp as sbp_ops
from tip_tpu_torch.runtime import terrain as terrain_lib


def _fk_feet(skel: kin.Skeleton, gt_qdq: np.ndarray) -> np.ndarray:
    """(T, 114) states -> (T, 2, 3) world positions of the two foot SBP
    links (lankle, rankle pq rows), in the skeleton's dtype from float32
    states, as tip_tpu computes them."""
    s = torch.as_tensor(np.asarray(gt_qdq, np.float32)).to(
        skel.joint_offset.dtype)
    pq = kin.fk_our_state(skel, s.to(skel.joint_offset.device))
    rows = list(sbp_ops.SBP_PQ_ROWS[:2])
    return pq[:, rows, :3].cpu().numpy()


def _cells(xy: np.ndarray, cfg: terrain_lib.TerrainConfig) -> np.ndarray:
    """(..., 2) world xy -> (..., 2) int grid indices (as
    terrain.update_height_map rounds them)."""
    G = cfg.grid_num
    return np.clip(np.round(xy / cfg.grid_size).astype(np.int64) + G // 2,
                   0, G - 1)


def gt_contact_samples(skel: kin.Skeleton, gt_qdq: np.ndarray,
                       gt_c: np.ndarray):
    """Ground-truth foot-contact points from labels + FK.

    gt_qdq: (T, 114) ground-truth states as streamed to the runner.
    gt_c: (T, n_sbps*4) label rows [flag, world-frame offset xyz].

    Returns (frames (M,), points (M, 3)): frame index and world contact
    point for every labeled foot-contact frame, both feet in turn.
    """
    T = len(gt_qdq)
    feet_p = _fk_feet(skel, gt_qdq)
    c = np.asarray(gt_c).reshape(T, -1, 4)
    frames, points = [], []
    for ch in (0, 1):
        on = c[:, ch, 0] > 0.5
        frames.append(np.nonzero(on)[0])
        points.append(feet_p[on, ch] + c[on, ch, 1:4])
    return np.concatenate(frames), np.concatenate(points, axis=0)


def establishment_frames(viz: np.ndarray, upd: np.ndarray,
                         cfg: terrain_lib.TerrainConfig,
                         query_cells: np.ndarray) -> np.ndarray:
    """First frame each query cell was covered by a committed update patch.

    viz: (T, n_sbps, 3) runner c_locs track (100s when inactive);
    upd: (T, 3) bool update flags for slots (lankle=sbp0, rankle=sbp1,
    root=sbp4), centered on viz[t-1].
    query_cells: (N, 2) int grid indices.

    Returns (N,) int64 frame indices, -1 where never established.
    """
    G, d = cfg.grid_num, cfg.diffuse_region
    slots_to_sbp = (0, 1, 4)
    out = np.full(len(query_cells), -1, np.int64)
    pending = np.ones(len(query_cells), bool)
    qi, qj = query_cells[:, 0], query_cells[:, 1]
    for t in range(1, len(upd)):
        if not upd[t].any() or not pending.any():
            continue
        for slot in np.nonzero(upd[t])[0]:
            c_loc = viz[t - 1, slots_to_sbp[slot]]
            ij = _cells(c_loc[None, :2], cfg)[0]
            i0 = np.clip(ij[0] - d, 0, G - 2 * d)
            j0 = np.clip(ij[1] - d, 0, G - 2 * d)
            hit = pending & (qi >= i0) & (qi < i0 + 2 * d) \
                & (qj >= j0) & (qj < j0 + 2 * d)
            out[hit] = t
            pending &= ~hit
    return out


def established_mask_from_updates(viz: np.ndarray, upd: np.ndarray,
                                  cfg: terrain_lib.TerrainConfig
                                  ) -> np.ndarray:
    """(G, G) bool — cells covered by any committed update patch; equals
    ``confidence > -99`` of the runner's final terrain state."""
    G = cfg.grid_num
    cells = np.stack(np.meshgrid(np.arange(G), np.arange(G),
                                 indexing="ij"), -1).reshape(-1, 2)
    return (establishment_frames(viz, upd, cfg, cells) >= 0).reshape(G, G)


def _cell_height_table(pts: np.ndarray, cfg: terrain_lib.TerrainConfig):
    """Group contact samples by grid cell: (unique flat cells, inverse
    index, per-cell mean gt height, per-cell sample counts)."""
    cells = _cells(pts[:, :2], cfg)
    flat = cells[:, 0] * cfg.grid_num + cells[:, 1]
    uniq, inv = np.unique(flat, return_inverse=True)
    gt_h = np.zeros(len(uniq))
    counts = np.bincount(inv, minlength=len(uniq))
    np.add.at(gt_h, inv, pts[:, 2])
    gt_h /= np.maximum(counts, 1)
    return uniq, inv, gt_h, counts


def motion_terrain_metrics(skel: kin.Skeleton, gt_qdq: np.ndarray,
                           gt_c: Optional[np.ndarray],
                           terrain_state: terrain_lib.TerrainState,
                           cfg: terrain_lib.TerrainConfig,
                           viz: Optional[np.ndarray] = None,
                           upd: Optional[np.ndarray] = None,
                           pred_qdq: Optional[np.ndarray] = None
                           ) -> Optional[Dict[str, float]]:
    """Terrain quality of one motion's final map against its labeled
    ground truth (module docstring). ``pred_qdq``: the latency-trimmed
    predicted trajectory, frame-aligned with gt_qdq; enables the
    drift-corrected metrics.

    Returns None when the motion has no labeled foot contacts.
    """
    if gt_c is None:
        return None
    frames, pts = gt_contact_samples(skel, gt_qdq, gt_c)
    if len(pts) == 0:
        return None

    # per-cell ground-truth height (mean of contact samples) + first contact
    uniq, inv, gt_h, _counts = _cell_height_table(pts, cfg)
    first_contact = np.full(len(uniq), np.iinfo(np.int64).max)
    np.minimum.at(first_contact, inv, frames)

    conf = terrain_state.confidence.cpu().numpy()
    hfield = terrain_lib.height_field(terrain_state).cpu().numpy()

    def _score(flat_cells, cell_h):
        """(established mask, share established, MAE, bias) of the map
        against the per-cell target heights."""
        ui, uj = flat_cells // cfg.grid_num, flat_cells % cfg.grid_num
        est = conf[ui, uj] > -99.0
        err = hfield[ui, uj][est] - cell_h[est]
        return (est, float(est.mean()),
                float(np.abs(err).mean()) if est.any() else float("nan"),
                float(err.mean()) if est.any() else float("nan"))

    est, pct, mae, bias = _score(uniq, gt_h)
    out = {
        "n_path_cells": float(len(uniq)),
        "pct_path_established": pct,
        "height_mae_m": mae,
        "height_bias_m": bias,
    }

    if pred_qdq is not None:
        # drift-corrected frame: each gt contact sample moved by the
        # instantaneous root drift
        n = min(len(pred_qdq), len(gt_qdq))
        drift = np.asarray(pred_qdq)[:n, 0:3] - np.asarray(gt_qdq)[:n, 0:3]
        keep = frames < n
        pts_dc = pts[keep] + drift[frames[keep]]
        if len(pts_dc):
            uniq_dc, _, gt_h_dc, _ = _cell_height_table(pts_dc, cfg)
            _, pct_dc, mae_dc, bias_dc = _score(uniq_dc, gt_h_dc)
            out.update({"pct_path_established_dc": pct_dc,
                        "height_mae_dc_m": mae_dc,
                        "height_bias_dc_m": bias_dc})
    if viz is not None and upd is not None:
        ui, uj = uniq // cfg.grid_num, uniq % cfg.grid_num
        est_frame = establishment_frames(np.asarray(viz), np.asarray(upd),
                                         cfg, np.stack([ui, uj], axis=1))
        have = est_frame >= 0
        lat = np.maximum(est_frame[have] - first_contact[have], 0) * cst.DT
        out["latency_s"] = float(lat.mean()) if have.any() else float("nan")
    return out


def summarize(per_motion: Sequence[Optional[Dict[str, float]]]
              ) -> Dict[str, float]:
    """Aggregate per-motion terrain metrics (unweighted over motions with
    contacts; the worst MAE beside the mean)."""
    rows: List[Dict[str, float]] = [m for m in per_motion if m is not None]
    if not rows:
        return {"n_motions_with_contacts": 0}
    keys = ("height_mae_m", "height_bias_m", "pct_path_established",
            "height_mae_dc_m", "height_bias_dc_m", "pct_path_established_dc",
            "latency_s", "n_path_cells")
    out: Dict[str, float] = {"n_motions_with_contacts": len(rows)}
    for k in keys:
        vals = np.array([r[k] for r in rows if k in r], dtype=float)
        vals = vals[np.isfinite(vals)]
        if len(vals):
            out[k] = round(float(vals.mean()), 4)
    mae = np.array([r.get("height_mae_m", np.nan) for r in rows], float)
    if np.isfinite(mae).any():
        out["height_mae_m_max"] = round(float(np.nanmax(mae)), 4)
    return out
