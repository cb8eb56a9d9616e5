"""Live-demo sensor calibration (copy of tip_tpu/runtime/calibration.py).

The reference's two-stage protocol (live_demo_new.py:49-68,150-175,217-248):

  stage 1 (sensors aligned with the room axes, 3 s): the mean orientation of
  each sensor is the global-to-room heading offset R_Gn_Gp; the mean
  acceleration (gravity included) becomes the per-sensor acc offset.

  stage 2 (T-pose, 3 s): with known T-pose bone orientations R_Gp_B0, the
  bone-to-sensor mount transform is R_B0_S0 = R_Gp_B0^T R_Gn_Gp^T R_Gn_S0.

  streaming: R_Gp_Bt = R_Gn_Gp^T R_Gn_St R_B0_S0^T; accelerations are rotated
  into the room frame, offset-subtracted, and clipped to +/-10 m/s^2.

Pure numpy — host-side, not on the hot path.
"""

from dataclasses import dataclass

import numpy as np
from scipy.spatial.transform import Rotation

MAX_ACC = 10.0


def aligned_t_pose_bone_rotations() -> np.ndarray:
    """Known bone orientations in an axis-aligned T pose: front +x, left +y,
    up +z (reference live_demo_new.py:52-62). Returns (6, 3, 3)."""
    base = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])
    bones = np.tile(base, (6, 1, 1))
    head = Rotation.from_rotvec([0, 0, np.pi / 2]).as_matrix()
    return np.einsum("ij,njk->nik", head, bones)


def t_pose_init_state(n_dofs: int = 57) -> np.ndarray:
    """The streaming-start state for a T pose (live_demo_new.py:65-68)."""
    s = np.zeros(n_dofs * 2)
    s[2] = 0.85
    s[3:6] = [1.20919958, 1.20919958, 1.20919958]
    return s


@dataclass
class Calibration:
    r_gn_gp: np.ndarray       # (6, 3, 3) heading offset per sensor
    acc_offset_gp: np.ndarray  # (6, 3)
    r_b0_s0: np.ndarray       # (6, 3, 3) bone-to-sensor mount


def heading_reset(mean_reading: np.ndarray):
    """Stage 1 from a (72,) mean reading. Returns (R_Gn_Gp, acc_offset)."""
    r_gn_gp = mean_reading[:54].reshape(6, 3, 3)
    acc_offset = mean_reading[54:].reshape(6, 3)
    return r_gn_gp, acc_offset


def bone_to_sensor(mean_reading: np.ndarray, r_gn_gp: np.ndarray) -> np.ndarray:
    """Stage 2 from the T-pose mean reading."""
    r_gn_s0 = mean_reading[:54].reshape(6, 3, 3)
    r_gp_b0 = aligned_t_pose_bone_rotations()
    r_gp_s0 = np.einsum("nij,njk->nik", r_gn_gp.transpose(0, 2, 1), r_gn_s0)
    return np.einsum("nij,njk->nik", r_gp_b0.transpose(0, 2, 1), r_gp_s0)


def calibrate(mean_aligned: np.ndarray, mean_t_pose: np.ndarray) -> Calibration:
    r_gn_gp, acc_offset = heading_reset(mean_aligned)
    r_b0_s0 = bone_to_sensor(mean_t_pose, r_gn_gp)
    return Calibration(r_gn_gp=r_gn_gp, acc_offset_gp=acc_offset,
                       r_b0_s0=r_b0_s0)


def transform_reading(cal: Calibration, reading: np.ndarray) -> np.ndarray:
    """Raw sensor frame (72,) -> calibrated bone-frame features
    (live_demo_new.get_transformed_current_reading, :161-175)."""
    r_gn_st = reading[:54].reshape(6, 3, 3)
    acc_st = reading[54:].reshape(6, 3)

    r_gp_st = np.einsum("nij,njk->nik", cal.r_gn_gp.transpose(0, 2, 1), r_gn_st)
    r_gp_bt = np.einsum("nij,njk->nik", r_gp_st, cal.r_b0_s0.transpose(0, 2, 1))

    acc_gp = np.einsum("nij,nj->ni", r_gp_st, acc_st) - cal.acc_offset_gp
    acc_gp = np.clip(acc_gp, -MAX_ACC, MAX_ACC)
    return np.concatenate([r_gp_bt.reshape(-1), acc_gp.reshape(-1)])
