"""Analytic two-joint (two-bone) IK in quaternion space (twin of
tip_tpu/ops/ik.py).

The "orange-duck" construction of the reference's two_joint_ik /
leg_two_joint_ik_keep_foot_pointing: correct the a-b / b-c interior angles
from the triangle law of cosines, then swing the chain so the end effector
reaches the target; the leg variant also re-aims the ankle so that the
global foot orientation is kept.

All inputs are joint-frame (p, q) 7-vectors, quaternions xyzw, with any
leading batch dimensions (the full runner corrects both legs in one call).
"""

from typing import Tuple

import torch

from tip_tpu_torch import device_const
from tip_tpu_torch.ops import rotations as rot


def _normalize(v):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-4)


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _acos(x):
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def two_joint_ik(pq_jf_pa, pq_jf_a, pq_jf_b, pq_jf_c, c_delta,
                 is_arm: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """New LOCAL quaternions of joints a (hip/shoulder) and b (knee/elbow)
    that move end effector c by the world-space c_delta."""
    a, b, c = pq_jf_a[..., :3], pq_jf_b[..., :3], pq_jf_c[..., :3]
    a_q_g, b_q_g = pq_jf_a[..., 3:], pq_jf_b[..., 3:]
    parent_q_inv = rot.q_conj(pq_jf_pa[..., 3:])

    target = c + c_delta

    eps = 0.01
    lab = torch.linalg.vector_norm(b - a, dim=-1, keepdim=True)
    lcb = torch.linalg.vector_norm(c - b, dim=-1, keepdim=True)
    lat = torch.minimum(torch.clamp(
        torch.linalg.vector_norm(target - a, dim=-1, keepdim=True), min=eps),
        lab + lcb - eps)

    ac_ab_0 = _acos(_dot(_normalize(c - a), _normalize(b - a)))
    ba_bc_0 = _acos(_dot(_normalize(a - b), _normalize(c - b)))
    ac_at_0 = _acos(_dot(_normalize(c - a), _normalize(target - a)))

    ac_ab_1 = _acos((lcb * lcb - lab * lab - lat * lat) / (-2 * lab * lat))
    ba_bc_1 = _acos((lat * lat - lab * lab - lcb * lcb) / (-2 * lab * lcb))

    # bend axis: perpendicular to the chain, oriented by the T-pose
    # elbow/knee pointing direction in the a-joint frame
    v = device_const((0.0, 0.0, -1.0 if is_arm else 1.0), a.dtype, a.device)
    d = rot.q_rotate(a_q_g, v)
    axis0_g = _normalize(rot.cross(c - a, d))
    axis1_g = _normalize(rot.cross(c - a, target - a))

    axis0_l = rot.q_rotate(parent_q_inv, axis0_g)
    axis1_l = rot.q_rotate(rot.q_conj(a_q_g), axis1_g)

    r0 = rot.aa_to_q(axis0_l * (ac_ab_1 - ac_ab_0))
    r1 = rot.aa_to_q(axis0_l * (ba_bc_1 - ba_bc_0))
    r2 = rot.aa_to_q(axis1_l * ac_at_0)

    a_q_l = rot.q_mult(parent_q_inv, a_q_g)
    b_q_l = rot.q_mult(rot.q_conj(a_q_g), b_q_g)
    a_q_l_1 = rot.q_mult(a_q_l, rot.q_mult(r0, r2))
    b_q_l_1 = rot.q_mult(b_q_l, r1)
    return a_q_l_1, b_q_l_1


def leg_two_joint_ik_keep_foot(pq_jf_pa, pq_jf_a, pq_jf_b, pq_jf_c, c_delta):
    """Leg variant: also returns the new LOCAL ankle quaternion that keeps
    the global foot orientation unchanged."""
    c_q_g = pq_jf_c[..., 3:]
    pa_q_g = pq_jf_pa[..., 3:]

    a_q_l_1, b_q_l_1 = two_joint_ik(pq_jf_pa, pq_jf_a, pq_jf_b, pq_jf_c,
                                    c_delta, is_arm=False)
    a_q_g_1 = rot.q_mult(pa_q_g, a_q_l_1)
    b_q_g_1 = rot.q_mult(a_q_g_1, b_q_l_1)
    c_q_l_1 = rot.q_mult(rot.q_conj(b_q_g_1), c_q_g)
    return a_q_l_1, b_q_l_1, c_q_l_1
