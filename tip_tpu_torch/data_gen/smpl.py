"""SMPL(-H) motion containers without the fairmotion dependency (copy of
tip_tpu/data_gen/smpl.py).

The reference loads AMASS npz / DIP pkl files through fairmotion (amass.load
and a custom dip_loader) only to get, per frame, the *local* joint rotations
and the global root transform — the skeleton geometry always comes from the
URDF character.  This module extracts exactly that, plus the reference's
time-resampling semantics (pose interpolation at t = 0.0075 + k/60, slerp on
rotations, lerp on translation).

SMPL joint order/naming: constants.SMPL_JOINTS (24 joints); parents
per the canonical SMPL kinematic tree (reference dip_loader.py:13-38).
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy.spatial.transform import Rotation

from tip_tpu_torch import constants as cst

SMPL_PARENTS = np.array([
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
    19, 20, 21], dtype=np.int32)

# our character's joints, by SMPL name, in bullet joint order (chars.amass)
CHAR_JOINT_SMPL_NAMES = [
    "lhip", "lknee", "lankle", "rhip", "rknee", "rankle",
    "lowerback", "upperback", "chest", "lowerneck", "upperneck",
    "lclavicle", "lshoulder", "lelbow", "lwrist",
    "rclavicle", "rshoulder", "relbow", "rwrist",
]
CHAR_TO_SMPL = np.array([cst.SMPL_JOINT_IDX[n] for n in CHAR_JOINT_SMPL_NAMES],
                        dtype=np.int32)


@dataclass
class SmplMotion:
    """Axis-angle pose stream: poses (T, 24, 3) local rotations (root global
    orientation in slot 0), trans (T, 3) or None, fps."""
    poses: np.ndarray
    trans: Optional[np.ndarray]
    fps: float

    @property
    def length_s(self) -> float:
        # fairmotion Motion.length() semantics: the TIME OF THE LAST FRAME,
        # (n-1)/fps, not n/fps — the reference's resample loop runs
        # `while cur_time < m.length()` (data-gen-and-viz-bullet-new.py:47),
        # so n/fps would emit up to one extra (clamped-repeat) frame per
        # motion vs the reference's grid
        return (len(self.poses) - 1) / self.fps


def load_amass_npz(path) -> SmplMotion:
    """AMASS SMPL-H npz: poses (T, 156), trans (T, 3), mocap_framerate."""
    data = np.load(path)
    poses = np.asarray(data["poses"])[:, :24 * 3].reshape(-1, 24, 3)
    trans = np.asarray(data["trans"])
    fps = float(data["mocap_framerate"]) if "mocap_framerate" in data else 60.0
    return SmplMotion(poses=poses, trans=trans, fps=fps)


def load_dip_pkl(path) -> SmplMotion:
    """DIP-IMU pkl: 'gt' (T, 72) SMPL axis angles, no translation, 60 fps;
    also returns nothing about IMUs (read separately)."""
    import pickle
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    poses = np.asarray(data["gt"])[:, :24 * 3].reshape(-1, 24, 3)
    fps = float(data["frame_rate"]) if "frame_rate" in data else 60.0
    return SmplMotion(poses=poses, trans=None, fps=fps)


def resample_times(length_s: float, dt: float = cst.DT) -> np.ndarray:
    """The reference's sampling grid: t = 0.015/2 + k*dt while t < length
    (data-gen-and-viz-bullet-new.py:47-49)."""
    t0 = 0.015 / 2.0
    n = int(np.ceil((length_s - t0) / dt))
    n = max(n, 0)
    ts = t0 + np.arange(n) * dt
    return ts[ts < length_s]


def sample_pose(motion: SmplMotion, t: float):
    """Pose at time t: slerp local rotations, lerp translation; clamps at the
    ends (fairmotion Motion.get_pose_by_time semantics)."""
    f = t * motion.fps
    i0 = int(np.clip(np.floor(f), 0, len(motion.poses) - 1))
    i1 = min(i0 + 1, len(motion.poses) - 1)
    a = float(np.clip(f - i0, 0.0, 1.0))

    r0 = Rotation.from_rotvec(motion.poses[i0])
    r1 = Rotation.from_rotvec(motion.poses[i1])
    if i0 == i1 or a == 0.0:
        rr = r0
    else:
        # per-joint slerp (scipy Slerp wants shared timestamps; do it manually)
        q0, q1 = r0.as_quat(), r1.as_quat()
        dot = np.sum(q0 * q1, axis=1, keepdims=True)
        q1 = np.where(dot < 0, -q1, q1)
        ang = np.arccos(np.clip(np.abs(dot), -1, 1))
        s = np.sin(ang)
        w0 = np.where(s < 1e-8, 1 - a, np.sin((1 - a) * ang) / np.where(s < 1e-8, 1, s))
        w1 = np.where(s < 1e-8, a, np.sin(a * ang) / np.where(s < 1e-8, 1, s))
        q = w0 * q0 + w1 * q1
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        rr = Rotation.from_quat(q)

    aa = rr.as_rotvec()
    if motion.trans is not None:
        p = (1 - a) * motion.trans[i0] + a * motion.trans[i1]
    else:
        p = np.zeros(3)
    return aa, p


def resample_motion(motion: SmplMotion, dt: float = cst.DT):
    """(T60, 24, 3) local axis-angles + (T60, 3) root translations at the
    reference 60 Hz grid."""
    ts = resample_times(motion.length_s, dt)
    aas, ps = [], []
    for t in ts:
        aa, p = sample_pose(motion, t)
        aas.append(aa)
        ps.append(p)
    return np.asarray(aas), np.asarray(ps), ts
