"""Stationary-Body-Point (SBP) root correction (twin of the streaming part
of tip_tpu/ops/sbp.py).

Mask-based: inactive SBPs give NaN residue rows and 100.0 positions, and
never branch. The label-generation grid search belongs to the data-gen
slice and is not ported yet.
"""

from typing import NamedTuple

import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch import device_const
from tip_tpu_torch.ops import rotations as rot


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
