"""Batched forward kinematics for fixed-topology skeletons (twin of
tip_tpu/ops/kinematics.py, the plain path).

Two frame conventions are produced, matching PyBullet's link states: the
*joint frame* (URDF link frame) and the *CoM frame* (joint frame shifted by
the inertial origin). Quaternions are xyzw throughout.

``fk`` is the plain level-parallel tree walk. ``fk_bullet_fused`` (kernel
K6, csrc/fused_fk.cu) is the whole pose -> link-frames pipeline of one pose,
or of a pool's B poses, as one launch; the runner's fused tail
(ops/fused_tail.py, kernel K3) holds the same walk plus the SBP and history
chains.
"""

import ctypes
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from tip_tpu_torch import device_const
from tip_tpu_torch.chars import amass as _char
from tip_tpu_torch.chars import amass_skeleton as _amass
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import rotations as rot


@dataclass(frozen=True)
class Skeleton:
    """Flat skeleton tensors.

    ``parent``/``is_fixed`` are host tuples (the tree is static); the same
    tables also ride along as small int32 tensors on the skeleton's device
    for the tail kernel, so a URDF skeleton needs no recompiled kernel.
    """
    parent: Tuple[int, ...]            # (J,) parent joint, -1 = root link
    is_fixed: Tuple[bool, ...]         # (J,)
    joint_offset: torch.Tensor         # (J, 3) scaled
    com_offset: torch.Tensor           # (J+1, 3) scaled
    link_mass: torch.Tensor            # (J+1,)
    parent_i32: torch.Tensor           # (J,) int32 copy of parent
    is_fixed_i32: torch.Tensor         # (J,) int32 copy of is_fixed

    @property
    def n_joints(self) -> int:
        return len(self.parent)


def make_skeleton(parent, is_fixed, joint_offset, com_offset, link_mass,
                  dtype=torch.float32, device="cpu") -> Skeleton:
    parent = tuple(int(p) for p in parent)
    is_fixed = tuple(bool(f) for f in is_fixed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return Skeleton(
        parent=parent, is_fixed=is_fixed,
        joint_offset=t(joint_offset).contiguous(),
        com_offset=t(com_offset).contiguous(),
        link_mass=t(link_mass),
        parent_i32=torch.tensor(parent, dtype=torch.int32, device=device),
        is_fixed_i32=torch.tensor([int(f) for f in is_fixed],
                                  dtype=torch.int32, device=device),
    )


def amass_skeleton(scale: float = 1.0, dtype=torch.float32,
                   device="cpu") -> Skeleton:
    """The AMASS humanoid (19 joints: 17 spherical + 2 fixed wrists)."""
    return make_skeleton(_amass.PARENT, _amass.IS_FIXED,
                         _amass.JOINT_OFFSET * scale,
                         _amass.COM_OFFSET * scale, _amass.LINK_MASS,
                         dtype=dtype, device=device)


def skeleton_from_urdf(urdf, scale: float = 1.0, dtype=torch.float32,
                       device="cpu") -> Skeleton:
    """Build a Skeleton from a parsed URDF
    (tip_tpu_torch.utils.urdf.UrdfSkeleton)."""
    if not np.allclose(urdf.joint_rpy, 0.0):
        raise NotImplementedError("non-zero joint rpy not supported yet")
    return make_skeleton(urdf.parent, urdf.is_fixed,
                         urdf.joint_offset * scale, urdf.com_offset * scale,
                         urdf.link_mass, dtype=dtype, device=device)


def _levels(parent) -> Tuple[Tuple[int, ...], ...]:
    """Group joints by tree depth so each level runs as one batched op.
    Depths are found by fixpoint, so a child may be listed before its
    parent."""
    n = len(parent)
    depth = {j: 0 for j, p in enumerate(parent) if p == -1}
    while len(depth) < n:
        progressed = False
        for j, p in enumerate(parent):
            if j not in depth and p in depth:
                depth[j] = depth[p] + 1
                progressed = True
        if not progressed:
            missing = [j for j in range(n) if j not in depth]
            raise ValueError(
                f"skeleton parent table has a cycle or dangling parents "
                f"for joints {missing} (parent={tuple(parent)})")
    return tuple(tuple(j for j in range(n) if depth[j] == d)
                 for d in range(max(depth.values()) + 1))


def fk(skel: Skeleton, root_p, root_q, joint_q):
    """Forward kinematics, level-parallel.

    Args:
      root_p: (..., 3) root position.
      root_q: (..., 4) root orientation, xyzw.
      joint_q: (..., J, 4) local joint rotations (identity for fixed joints).

    Returns:
      pq_com: (..., J+1, 7) CoM-frame (p, q) per link, root first.
      pq_jf:  (..., J+1, 7) joint-frame (p, q) per link, root first.
    """
    J = skel.n_joints
    lead = root_p.shape[:-1]
    dev = root_p.device
    q_all = root_q.new_zeros(lead + (J + 1, 4))
    p_jf = root_p.new_zeros(lead + (J + 1, 3))
    q_all[..., 0, :] = root_q
    p_jf[..., 0, :] = root_p
    ident = device_const((0.0, 0.0, 0.0, 1.0), joint_q.dtype, dev)

    for joints in _levels(skel.parent):
        jj = device_const(joints, torch.long, dev)
        par_slots = device_const(tuple(skel.parent[j] + 1 for j in joints),
                                 torch.long, dev)
        fixed = device_const(tuple(skel.is_fixed[j] for j in joints),
                             torch.bool, dev)
        q_par = q_all[..., par_slots, :]
        p_par = p_jf[..., par_slots, :]
        p_new = p_par + rot.q_rotate(q_par, skel.joint_offset[jj])
        q_loc = torch.where(fixed[:, None], ident, joint_q[..., jj, :])
        q_all[..., jj + 1, :] = rot.q_mult(q_par, q_loc)
        p_jf[..., jj + 1, :] = p_new

    p_com = p_jf + rot.q_rotate(q_all, skel.com_offset)
    pq_jf = torch.cat([p_jf, q_all], dim=-1)
    pq_com = torch.cat([p_com, q_all], dim=-1)
    return pq_com, pq_jf


# gather: active bullet joint i (0..16 over non-fixed joints) -> nimble aa slot
_B2N = tuple(int(i) for i in _char.BULLET_FROM_NIMBLE_GATHER)   # (17,)
_ACTIVE = tuple(int(i) for i in _char.NON_ROOT_ACTIVE_IDX)      # (17,)


def our_pose_to_bullet(s):
    """Nimble-ordered state (..., 114) -> bullet-ordered pose q (..., 57):
    [root xyz, root aa, 17 x joint aa in bullet joint order]."""
    joints = s[..., 6:6 + 51].reshape(s.shape[:-1] + (17, 3))
    idx = device_const(_B2N, torch.long, s.device)
    reordered = joints[..., idx, :].reshape(s.shape[:-1] + (51,))
    return torch.cat([s[..., :6], reordered], dim=-1)


def bullet_pose_to_joint_quats(state_bullet):
    """Bullet pose q (..., 57) -> (root_p, root_q, joint_q (..., 19, 4)),
    identity local rotations at the fixed wrists."""
    root_p = state_bullet[..., :3]
    root_q = rot.aa_to_q(state_bullet[..., 3:6])
    aa = state_bullet[..., 6:].reshape(state_bullet.shape[:-1] + (17, 3))
    q_active = rot.aa_to_q(aa)
    joint_q = q_active.new_zeros(state_bullet.shape[:-1] + (19, 4))
    joint_q[..., 3] = 1.0
    joint_q[..., device_const(_ACTIVE, torch.long, state_bullet.device),
            :] = q_active
    return root_p, root_q, joint_q


def fk_bullet_state(skel: Skeleton, state_bullet, return_joint_frame=False):
    """FK from a bullet-format pose vector."""
    root_p, root_q, joint_q = bullet_pose_to_joint_quats(state_bullet)
    pq_com, pq_jf = fk(skel, root_p, root_q, joint_q)
    if return_joint_frame:
        return pq_com, pq_jf
    return pq_com


def fk_our_state(skel: Skeleton, s, return_joint_frame=False):
    """FK straight from a nimble-ordered 114-d state."""
    return fk_bullet_state(skel, our_pose_to_bullet(s), return_joint_frame)


# ---------------------------------------------------------------------------
# K6: the whole pose -> link-frames pipeline of one pose as one launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_SIG = {"fk_bullet_fused_launch": [_P, _P, _P, _P, _P, _P, ctypes.c_int,
                                   ctypes.c_int, _P, _P, _P]}

# joint j -> its place among the 17 active joints of a bullet pose (-1: fixed)
_ACTIVE_SLOT = tuple(_ACTIVE.index(j) if j in _ACTIVE else -1
                     for j in range(len(_char.JOINT_NAMES)))


def check_pose_skeleton(skel: Skeleton, what: str):
    """Raise unless ``skel`` fits the kernels' tree walk: the 19-joint pose
    layout (17 spherical joints + 2 fixed), parents before children."""
    if skel.n_joints != len(_ACTIVE_SLOT) or tuple(
            j for j, f in enumerate(skel.is_fixed) if not f) != _ACTIVE:
        raise ValueError(f"{what} takes the 19-joint AMASS pose layout "
                         f"(17 active joints), got {skel.n_joints} joints")
    if any(p >= j for j, p in enumerate(skel.parent)):
        raise ValueError(f"{what} walks joints in order: every parent must "
                         f"come before its children")


def fk_bullet_fused_plain(skel: Skeleton, state_bullet):
    """Plain version of K6: ``fk_bullet_state(..., return_joint_frame=True)``
    (any dtype, any leading batch dimensions)."""
    return fk_bullet_state(skel, state_bullet, return_joint_frame=True)


def fk_bullet_fused(skel: Skeleton, state_bullet, impl: str = "auto"):
    """(pq_com, pq_jf), both (J+1, 7), for a single (57,) bullet pose, or
    both (B, J+1, 7) for B poses (B, 57), as one op and one launch.
    ``impl``: "kernel" launches K6 (a float32 CUDA tensor), "plain" runs
    ``fk_bullet_fused_plain``, "auto" launches for a CUDA tensor and runs
    the plain version for a CPU tensor."""
    if not K.use_kernel(impl, state_bullet, "fk_impl", "kernel"):
        return fk_bullet_fused_plain(skel, state_bullet)
    check_pose_skeleton(skel, "fk_bullet_fused")
    J = skel.n_joints
    dev, f32 = state_bullet.device, torch.float32
    lead = tuple(state_bullet.shape[:-1])
    if len(lead) > 1:
        raise ValueError(f"state_bullet: one pose (57,) or (B, 57), got "
                         f"{tuple(state_bullet.shape)}")
    K.check_input(state_bullet, "state_bullet", lead + (57,), f32, dev)
    K.check_input(skel.joint_offset, "joint_offset", (J, 3), f32, dev)
    K.check_input(skel.com_offset, "com_offset", (J + 1, 3), f32, dev)
    K.check_input(skel.parent_i32, "parent", (J,), torch.int32, dev)
    K.check_input(skel.is_fixed_i32, "is_fixed", (J,), torch.int32, dev)
    slot = device_const(_ACTIVE_SLOT, torch.int32, dev)
    out = torch.empty((2,) + lead + (J + 1, 7), dtype=f32, device=dev)
    so = K.lib("fused_fk", _SIG)
    err = so.fk_bullet_fused_launch(
        state_bullet.data_ptr(), skel.joint_offset.data_ptr(),
        skel.com_offset.data_ptr(), skel.parent_i32.data_ptr(),
        skel.is_fixed_i32.data_ptr(), slot.data_ptr(),
        lead[0] if lead else 1, J, out[0].data_ptr(),
        out[1].data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    K.check(err, "fk_bullet_fused")
    K.launch_counts["fk_bullet_fused"] += 1
    return out[0], out[1]
