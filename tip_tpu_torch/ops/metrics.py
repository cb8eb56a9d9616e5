"""Evaluation metrics — the 7-metric suite of the reference harness (twin
of tip_tpu/ops/metrics.py).

Definitions from reference data_utils.py:314-391. All functions take full
trajectories and reduce to scalars.

  aa_*: (T, 57) bullet-format poses (xyz + root aa + 17 joint aa)
  pq_g_*: (T, 20, 7) global link (p, q) from FK; traj 2 is the prediction.
"""

import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch import device_const
from tip_tpu_torch.ops import rotations as rot

_RAD2DEG = 180.0 / 3.1416          # the reference's constant (data_utils.py:327)


def _mean_angle_deg(q1, q2):
    """Mean rotation angle of q1 ∘ q2⁻¹ over rows, in the reference's
    degrees."""
    dq = rot.q_diff(q1, q2)
    dq = dq * rot._w_sign(dq[:, 3:4])
    ang = torch.linalg.vector_norm(rot.q_to_aa(dq), dim=1)
    return torch.mean(ang) * _RAD2DEG


def loss_angle(aa_1, aa_2, pq_g_1=None, pq_g_2=None):
    """Mean local joint angle error in degrees (data_utils.py:314-327)."""
    a1 = aa_1[:, 3:].reshape(-1, 3)
    a2 = aa_2[:, 3:].reshape(-1, 3)
    return _mean_angle_deg(rot.aa_to_q(a1), rot.aa_to_q(a2))


def loss_j_pos(aa_1, aa_2, pq_g_1=None, pq_g_2=None):
    """Mean root-relative joint position error in cm (data_utils.py:330-337)."""
    p1 = pq_g_1[:, 1:, :3] - pq_g_1[:, 0:1, :3]
    p2 = pq_g_2[:, 1:, :3] - pq_g_2[:, 0:1, :3]
    d = torch.linalg.vector_norm((p2 - p1).reshape(-1, 3), dim=1)
    return torch.mean(d) * 100.0


def loss_global_angle(aa_1, aa_2, pq_g_1=None, pq_g_2=None):
    """Mean global link angle error in degrees (data_utils.py:340-356)."""
    return _mean_angle_deg(pq_g_1[..., 3:].reshape(-1, 4),
                           pq_g_2[..., 3:].reshape(-1, 4))


def _mean_jerk(p):
    """Mean norm of the 3rd difference along time, x100."""
    jerk = p[3:] - 3 * p[2:-1] + 3 * p[1:-2] - p[:-3]
    return torch.mean(torch.linalg.vector_norm(jerk, dim=-1)) * 100.0


def loss_max_jerk(aa_1, aa_2, pq_g_1=None, pq_g_2=None):
    """Mean 3rd-difference jerk of predicted link positions x100
    (data_utils.py:359-368; despite the name it averages, not maxes)."""
    return _mean_jerk(pq_g_2[..., :3])


def loss_root_jerk(aa_1, aa_2, pq_g_1=None, pq_g_2=None):
    """Root jerk x100 (data_utils.py:371-378)."""
    return _mean_jerk(pq_g_2[:, 0, :3])


def loss_sip(aa_1, aa_2, pq_g_1=None, pq_g_2=None):
    """SIP error: mean global orientation error of hips and shoulders in
    degrees — the standard sparse-IMU benchmark metric (computed like
    loss_global_angle restricted to the lhip/rhip/lshoulder/rshoulder
    links)."""
    rows = device_const((1, 4, 13, 17), torch.long,   # link = joint idx + 1
                        pq_g_1.device)
    return _mean_angle_deg(pq_g_1[:, rows, 3:].reshape(-1, 4),
                           pq_g_2[:, rows, 3:].reshape(-1, 4))


def loss_root_dist_pos(aa_1, aa_2, pq_g_1=None, pq_g_2=None, t: float = 1.0):
    """Root drift after t seconds, meters (data_utils.py:381-391)."""
    ind = int(t / cst.DT) - 1
    ind = min(ind, pq_g_1.shape[0] - 1)
    d1 = pq_g_1[ind, 0, :3] - pq_g_1[0, 0, :3]
    d2 = pq_g_2[ind, 0, :3] - pq_g_2[0, 0, :3]
    return torch.linalg.vector_norm(d1 - d2)
