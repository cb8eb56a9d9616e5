"""Batched forward kinematics for fixed-topology skeletons (twin of
tip_tpu/ops/kinematics.py, the plain path).

Two frame conventions are produced, matching PyBullet's link states: the
*joint frame* (URDF link frame) and the *CoM frame* (joint frame shifted by
the inertial origin). Quaternions are xyzw throughout.

``fk`` is the plain level-parallel tree walk. ``fk_bullet_fused`` (kernel
K6, csrc/fused_fk.cu) is the whole pose -> link-frames pipeline of one pose,
or of a pool's B poses, as one launch; the runner's fused tail
(ops/fused_tail.py, kernel K3) holds the same walk plus the SBP and history
chains. Both kernels walk the skeleton's FK plan (``fk_plan``,
``fk_plan_table``): each link's chain of joints from the root, built once
on the host for each skeleton and device (``skeleton_args``).
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

    ``parent``/``is_fixed`` are host tuples (the tree is static); the FK
    kernels take the skeleton as a table made from them at their first call
    (``skeleton_args``), so a URDF skeleton needs no recompiled kernel.
    """
    parent: Tuple[int, ...]            # (J,) parent joint, -1 = root link
    is_fixed: Tuple[bool, ...]         # (J,)
    joint_offset: torch.Tensor         # (J, 3) scaled
    com_offset: torch.Tensor           # (J+1, 3) scaled
    link_mass: torch.Tensor            # (J+1,)

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
# The FK plan of kernels K3 and K6
# ---------------------------------------------------------------------------

# csrc/tip_quat.cuh: kMaxLinks (a warp), kMaxDepth (the chain joints a
# pass composes from registers), kPlanRows (the plan's rows: row 0 and a
# chain of up to K_MAX_LINKS - 1 joints)
K_MAX_LINKS = 32
K_MAX_DEPTH = 8
K_PLAN_ROWS = K_MAX_LINKS


def fk_plan(parent) -> Tuple[Tuple[int, ...], ...]:
    """Each link's chain of joints from the root down to it: link 0 (the
    root) has none, link j + 1 ends in joint j. The kernels compose a link's
    frame along its chain, so a parent may be listed after its children,
    and a chain may be as deep as the tree. Raises on a cycle or a dangling
    parent (as ``_levels``) and on more than K_MAX_LINKS links (a warp)."""
    _levels(parent)
    if len(parent) + 1 > K_MAX_LINKS:
        raise ValueError(f"the FK kernels take at most {K_MAX_LINKS} links, "
                         f"got {len(parent) + 1}")
    chains = [()]
    for j in range(len(parent)):
        chain = [j]
        while parent[chain[-1]] != -1:
            chain.append(parent[chain[-1]])
        chains.append(tuple(reversed(chain)))
    return tuple(chains)


def fk_plan_table(skel: Skeleton, slot) -> np.ndarray:
    """The FK plan as the kernels read it (csrc/tip_quat.cuh ``Plan``):
    float32 (K_PLAN_ROWS, K_MAX_LINKS, 4), column l for link l. Row 0: the
    link's CoM offset and, as int32 bits, its chain's length. Row k: the
    k-th joint of the chain, its joint offset and, as int32 bits, the index
    of its rotation among the pose's 18 decoded quats (1 + ``slot[j]``; -1
    for a fixed joint). The rest zero."""
    chains = fk_plan(skel.parent)
    joff = skel.joint_offset.detach().cpu().numpy()
    coff = skel.com_offset.detach().cpu().numpy()
    tab = np.zeros((K_PLAN_ROWS, K_MAX_LINKS, 4), np.float32)
    bits = tab.view(np.int32)
    for link, chain in enumerate(chains):
        tab[0, link, :3] = coff[link]
        bits[0, link, 3] = len(chain)
        for k, j in enumerate(chain, 1):
            tab[k, link, :3] = joff[j]
            bits[k, link, 3] = -1 if skel.is_fixed[j] else 1 + slot[j]
    return tab


# ---------------------------------------------------------------------------
# K6: the whole pose -> link-frames pipeline of one pose as one launch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"fk_bullet_fused_launch": [_P, _P, _I, _I, _I, _P, _P, _P]}
# the phases of K6's per-phase clock (stamp 0 is the start)
K6_PHASES = ("aa_to_q", "walk", "link_frames")

# joint j -> its place among the 17 active joints of a bullet pose (-1: fixed)
_ACTIVE_SLOT = tuple(_ACTIVE.index(j) if j in _ACTIVE else -1
                     for j in range(len(_char.JOINT_NAMES)))


def check_pose_skeleton(skel: Skeleton, what: str):
    """Raise unless ``skel`` fits the kernels' FK: the 19-joint pose layout
    (17 spherical joints + 2 fixed) and a plan (no cycle, no dangling
    parent; any chain depth, any order of parents and children)."""
    if skel.n_joints != len(_ACTIVE_SLOT) or tuple(
            j for j, f in enumerate(skel.is_fixed) if not f) != _ACTIVE:
        raise ValueError(f"{what} takes the 19-joint AMASS pose layout "
                         f"(17 active joints), got {skel.n_joints} joints")
    fk_plan(skel.parent)


def skeleton_args(skel: Skeleton, what: str, slot, device, lead, shapes,
                  out_shapes) -> K.LaunchArgs:
    """A K3/K6 wrapper's checks of the skeleton and its FK plan on
    ``device`` (``fk_plan_table``), made once per (skeleton, device, leading
    shape) and again when an offset tensor is replaced or written (the plan
    copies them)."""
    jo, co = skel.joint_offset, skel.com_offset
    key = (what, device, lead, id(jo), jo._version, id(co), co._version)

    def make():
        if len(lead) > 1:
            raise ValueError(f"{what}: one stream or a pool (B, ...), got "
                             f"the leading shape {lead}")
        check_pose_skeleton(skel, what)
        J, f32 = skel.n_joints, torch.float32
        K.check_input(jo, "joint_offset", (J, 3), f32, device)
        K.check_input(co, "com_offset", (J + 1, 3), f32, device)
        n_out, views = K.out_views(lead, out_shapes)
        return K.LaunchArgs(
            shapes=tuple(lead + s for s in shapes),
            table=torch.from_numpy(fk_plan_table(skel, slot)).to(device),
            B=lead[0] if lead else 1, n_out=n_out, views=views,
            deep=max(map(len, fk_plan(skel.parent))) > K_MAX_DEPTH)
    return K.launch_args(skel, key, make)


def _fk_args(skel: Skeleton, device, lead) -> K.LaunchArgs:
    L = skel.n_joints + 1
    return skeleton_args(skel, "fk_bullet_fused", _ACTIVE_SLOT, device, lead,
                         ((57,),), ((L, 7), (L, 7)))


def fk_bullet_fused_plain(skel: Skeleton, state_bullet):
    """Plain version of K6: ``fk_bullet_state(..., return_joint_frame=True)``
    (any dtype, any leading batch dimensions)."""
    return fk_bullet_state(skel, state_bullet, return_joint_frame=True)


def fk_bullet_fused(skel: Skeleton, state_bullet, impl: str = "auto",
                    clock=None):
    """(pq_com, pq_jf), both (J+1, 7), for a single (57,) bullet pose, or
    both (B, J+1, 7) for B poses (B, 57), as one op and one launch.
    ``impl``: "kernel" launches K6 (a float32 CUDA tensor), "plain" runs
    ``fk_bullet_fused_plain``, "auto" launches for a CUDA tensor and runs
    the plain version for a CPU tensor. ``clock``: None, or a (4,) int64
    tensor for the per-phase clock (``fused_tail.phase_ns``)."""
    if not K.use_kernel(impl, state_bullet, "fk_impl", "kernel"):
        return fk_bullet_fused_plain(skel, state_bullet)
    dev = state_bullet.device
    a = _fk_args(skel, dev, tuple(state_bullet.shape[:-1]))
    K.check_input(state_bullet, "state_bullet", a.shapes[0], torch.float32,
                  dev)
    out = torch.empty(a.n_out, dtype=torch.float32, device=dev)
    err = K.lib("fused_fk", _SIG).fk_bullet_fused_launch(
        state_bullet.data_ptr(), a.table.data_ptr(), a.B,
        skel.n_joints, int(a.deep), out.data_ptr(),
        K.clock_ptr(clock, 1 + len(K6_PHASES), dev), K.stream_of(dev))
    K.check(err, "fk_bullet_fused")
    K.launch_counts["fk_bullet_fused"] += 1
    return tuple(out.as_strided(*v) for v in a.views)
