"""Stationary-Body-Point (SBP) math (twin of tip_tpu/ops/sbp.py).

Two pieces, both mask-based (no NaN control flow):

1. Label synthesis: per link, grid-search the local point whose world
   velocity (w x Rp + v) is minimal; accept if the combined residue is
   below V_THRES. Reference data_utils.get_rot_center_sample_based
   (data_utils.py:27-100). tip_tpu scans one link over time; here one loop
   over time carries the five links together, each with its own grid
   (padded to the longest, the padding never chosen), argmin and carry.
2. Root-drift correction from the active feet SBPs: inactive SBPs give NaN
   residue rows and 100.0 positions, and never branch.
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch import device_const
from tip_tpu_torch.ops import rotations as rot


def _grid(lp_x, lp_y, lp_z) -> np.ndarray:
    """Candidate local points; meshgrid order matches the reference so the
    argmin tie-break picks the same point (data_utils.py:70-71)."""
    xx, yy, zz = np.meshgrid(lp_x, lp_y, lp_z)
    return np.stack((xx.ravel(), yy.ravel(), zz.ravel()), axis=1)


# candidate grids per link type (data_utils.py:52-68); link indices follow
# chars.amass: wrists 14/18, feet 2/5, pelvis -1
GRID_WRIST = _grid(np.arange(-0.02, 0.03, 0.01),
                   np.arange(-0.02, 0.03, 0.01),
                   np.arange(-0.02, 0.03, 0.01))
GRID_FOOT = _grid(np.arange(-0.04, 0.05, 0.01),
                  np.arange(-0.04, 0.02, 0.01),
                  np.arange(-0.15, 0.18, 0.01))
GRID_PELVIS = _grid(np.arange(-0.15, 0.16, 0.01),
                    np.arange(-0.1, 0.15, 0.01),
                    np.arange(-0.12, -0.04, 0.01))


def grid_for_link(link: int) -> np.ndarray:
    if link in (14, 18):
        return GRID_WRIST
    if link in (2, 5):
        return GRID_FOOT
    if link == -1:
        return GRID_PELVIS
    raise ValueError(f"no SBP grid for link {link}")


class RotCenter(NamedTuple):
    sol: torch.Tensor       # (..., 3) world-frame R·p of the best point (0 if inactive)
    active: torch.Tensor    # (...) bool — residue below threshold
    vel: torch.Tensor       # (..., 3) best point's world velocity (0 if inactive)


def _norm3(v):
    """Euclidean norm over the last axis, as a sum of squares and a sqrt."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def rot_center_sample(x1, q1, x2, q2, dt, sol_prev, prev_active, grid,
                      v_thres: float = cst.V_THRES,
                      valid: Optional[torch.Tensor] = None) -> RotCenter:
    """One grid search step (reference data_utils.py:27-100), for one link
    or with leading link axes on every argument (``grid`` (..., N, 3)).

    Residue per candidate p: |w x (R2 p) + v| + 0.2 |temporal| + 0.02 |R2 p|,
    where the temporal term compares against the advected previous solution
    (sol_prev - v dt) and is zero when there was no previous solution.
    ``valid`` (..., N): the candidates that exist (a padded grid's padding
    is never chosen). The first of equal minima wins, as jnp.argmin's.
    """
    v = (x2 - x1) / dt
    w = rot.angular_velocity_from_quats(q1, q2, dt)

    lps_r = rot.q_rotate(q2[..., None, :], grid)          # (..., N, 3) R2·p
    lps_v = rot.cross(w[..., None, :], lps_r) + v[..., None, :]

    dist = lps_r - (sol_prev - v * dt)[..., None, :]
    dist_n = torch.where(prev_active[..., None], _norm3(dist),
                         torch.zeros_like(dist[..., 0]))

    residues = _norm3(lps_v) + 0.2 * dist_n + 0.02 * _norm3(lps_r)
    if valid is not None:
        residues = torch.where(valid, residues,
                               torch.full_like(residues, float("inf")))
    idx = torch.argmin(residues, dim=-1, keepdim=True)
    active = torch.gather(residues, -1, idx)[..., 0] < v_thres
    pick = idx[..., None].expand(idx.shape + (3,))
    zero = torch.zeros_like(v)
    sol = torch.where(active[..., None],
                      torch.gather(lps_r, -2, pick)[..., 0, :], zero)
    vel = torch.where(active[..., None],
                      torch.gather(lps_v, -2, pick)[..., 0, :], zero)
    return RotCenter(sol=sol, active=active, vel=vel)


def _padded_grids(grids: Sequence, dtype=torch.float64, device="cpu"):
    """The grids of several links as one (L, N, 3) tensor, each padded to
    the longest with copies of its last point, and the (L, N) mask of the
    real candidates."""
    n = max(len(g) for g in grids)
    out = np.stack([np.concatenate([g, np.repeat(g[-1:], n - len(g), 0)])
                    for g in grids])
    valid = np.stack([np.arange(n) < len(g) for g in grids])
    return (torch.as_tensor(out, dtype=dtype, device=device),
            torch.as_tensor(valid, device=device))


def link_contact_sequences(pq_links, dt: float, grids: Sequence):
    """SBP labels over a motion for L links at once: (T, L, 4) rows [flag,
    R·p or 0], link l searched over ``grids[l]``.

    One loop over time (the temporal-consistency term couples frames)
    carrying each link's (sol_prev, prev_active); the links and the grid
    are vectorised. Mirrors
    data-gen-and-viz-bullet-new.get_link_contr_seq_from_raw_motion_info
    (:104-144): frame t uses (t-1, t+1) states with dt' = 2 dt; frames
    [0,1] and [T-2,T-1] stay zero.

    pq_links: (T, L, 7) world (p, q) of the links over time.
    """
    T, L = pq_links.shape[:2]
    grid, valid = _padded_grids(grids, pq_links.dtype, pq_links.device)
    x = pq_links[..., :3]
    q = pq_links[..., 3:]
    out = torch.zeros((T, L, 4), dtype=pq_links.dtype,
                      device=pq_links.device)
    sol = torch.zeros((L, 3), dtype=x.dtype, device=x.device)
    active = torch.zeros(L, dtype=torch.bool, device=x.device)
    # frames t = 2 .. T-3 use (t-1) and (t+1)
    for t in range(2, T - 2):
        rc = rot_center_sample(x[t - 1], q[t - 1], x[t + 1], q[t + 1],
                               2.0 * dt, sol, active, grid, valid=valid)
        sol, active = rc.sol, rc.active
        out[t, :, 0] = active.to(x.dtype)
        out[t, :, 1:] = sol
    return out


def link_contact_sequence(pq_link, dt: float, grid):
    """SBP labels over a motion for one link: (T, 4) rows [flag, R·p or
    0]; ``link_contact_sequences`` for one link. pq_link: (T, 7) world
    (p, q) of the link over time."""
    return link_contact_sequences(pq_link[:, None], dt,
                                  [np.asarray(grid)])[:, 0]


def residue_from_contr(x1, q1, x2, q2, dt, sol):
    """World-velocity residue of a constrained point; sol is the
    world-frame offset (R·p) from the link CoM."""
    v = (x2 - x1) / dt
    w = rot.angular_velocity_from_quats(q1, q2, dt)
    return rot.cross(w, sol) + v


# pq row per SBP body: [lankle, rankle, lwrist, rwrist, root]; row = link + 1
SBP_PQ_ROWS = (3, 6, 15, 19, 0)


class RootCorrection(NamedTuple):
    vel_res: torch.Tensor       # (3,) clipped mean feet residue
    c_locs: torch.Tensor        # (5, 3) world SBP positions (100s if inactive)
    raw_residues: torch.Tensor  # (5, 3) per-SBP residue (NaN rows if inactive)
    active: torch.Tensor        # (5,) bool


def root_correction_from_constrs(pq_prev, pq_cur, constrs, n_sbps: int = 5,
                                 use_n_sbps: int = 5,
                                 dt: float = cst.DT) -> RootCorrection:
    """Root-velocity correction from active SBPs.

    constrs: (n_sbps*4,) [flag, offset(3)] per SBP, offsets world-frame
    relative to the link position. Only the first two (feet) contribute to
    vel_res: their mean over active feet (divided by max(n, 1)), clipped to
    ±0.5; all SBPs are evaluated for viz/IK. Leading batch dimensions on
    ``pq_prev``, ``pq_cur`` and ``constrs`` carry over to every output.
    """
    rows = device_const(SBP_PQ_ROWS[:n_sbps], torch.long, pq_cur.device)
    x1 = pq_prev[..., rows, :3]
    q1 = pq_prev[..., rows, 3:]
    x2 = pq_cur[..., rows, :3]
    q2 = pq_cur[..., rows, 3:]

    c = constrs.reshape(constrs.shape[:-1] + (n_sbps, 4))
    flags = c[..., 0] > 0.0
    use_mask = torch.arange(n_sbps, device=c.device) < use_n_sbps
    active = flags & use_mask

    offs = c[..., 1:4]
    res = residue_from_contr(x1, q1, x2, q2, dt, offs)
    raw = torch.where(active[..., None], res,
                      torch.full_like(res, float("nan")))
    c_locs = torch.where(active[..., None], x2 + offs,
                         torch.full_like(x2, 100.0))

    feet_active = active[..., :2]
    n_feet = torch.sum(feet_active, dim=-1, keepdim=True)
    feet_res = torch.where(feet_active[..., None], res[..., :2, :],
                           torch.zeros_like(res[..., :2, :]))
    vel_res = torch.where(n_feet > 0,
                          torch.sum(feet_res, dim=-2)
                          / torch.clamp(n_feet, min=1),
                          torch.zeros_like(feet_res[..., 0, :]))
    vel_res = torch.clamp(vel_res, -0.5, 0.5)
    return RootCorrection(vel_res=vel_res, c_locs=c_locs, raw_residues=raw,
                          active=active)
