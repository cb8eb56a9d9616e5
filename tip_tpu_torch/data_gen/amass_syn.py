"""Synthetic-IMU training data from AMASS motions (twin of
tip_tpu/data_gen/amass_syn.py).

Replaces the reference's PyBullet-based generation pipeline
(data-gen-and-viz-bullet-new.py:38-312) with FK batched over frames, in
float64 on ``device`` (``cuda`` unless the caller asks for another):

  per motion: resample to 60 Hz -> FK of the URDF character at a random body
  height (0.9-1.1 x 1.7 m) -> virtual IMU orientations from link frames and
  accelerations from a +/-4-frame central second difference of the sensor
  mount points -> SBP labels via the rot-center grid search (the five links
  in one loop over frames, ops/sbp.link_contact_sequences) ->
  nimble-ordered qdq ground truth.

Reference quirks preserved:
  * the root IMU sits at ROOT_COM_OFFSET in the (unscaled) root frame
    (bullet_agent.get_root_local_point_p applies no scale; constants.py:10);
  * the character root translation is scaled by h/1.6 (set_pose,
    bullet_agent.py:381-390) while the qdq labels keep the *unscaled* motion
    translation (get_raw_motion_info_nimble_q_dummy_dq reads the raw motion);
  * knee-IMU sensor set [root, lwrist, rwrist, lknee, rknee, upperneck]
    (data-gen-and-viz-bullet-new.py:157-166).

Host process fan-out over motion files lives in tip_tpu_torch.cli.gen_data.
"""

import pickle
from typing import Dict, Optional

import numpy as np
import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch import resolve_device
from tip_tpu_torch.chars import amass as char
from tip_tpu_torch.data_gen import smpl
from tip_tpu_torch.ops import imu as imu_ops
from tip_tpu_torch.ops import kinematics as kin
from tip_tpu_torch.ops import rotations as rot
from tip_tpu_torch.ops import sbp as sbp_ops

F64 = torch.float64

# nimble-state aa slot per bullet joint (17 active joints)
_N_STATE = np.array([char.NIMBLE_STATE_MAP[int(i)] - 1
                     for i in char.NON_ROOT_ACTIVE_IDX], np.int64)


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=F64, device=device)


def fk_motion(aa60, trans60, height: float, use_knee_imu: bool = True,
              device=None) -> Dict[str, torch.Tensor]:
    """FK the resampled motion, every frame at once. Returns dict with
    per-frame pq_imu (T, 6, 7) for the IMU sensor set and pq_sbp (T, 5, 7)
    for the SBP link set (CoM frames; root entry uses the ROOT_COM_OFFSET
    point), float64 on ``device``.

    use_knee_imu selects the knee sensor set (the reference's
    USE_KNEE_RATHER_ANKLE_IMU=True default) vs the ankle variant
    (data-gen-and-viz-bullet-new.py:32,157-174).
    """
    device = resolve_device(device)
    scale = height / 1.6
    skel = kin.amass_skeleton(scale=scale, dtype=F64, device=device)
    aa = _f64(aa60, device)

    root_q = rot.aa_to_q(aa[:, 0])
    root_p = _f64(trans60, device) * scale         # set_pose scales root p
    joint_q = rot.aa_to_q(aa[:, smpl.CHAR_TO_SMPL])   # (T, 19, 4)

    pq_com, _ = kin.fk(skel, root_p, root_q, joint_q)

    # root "link state" for IMU/SBP uses the ROOT_COM_OFFSET point (unscaled)
    root_imu_p = root_p + rot.q_rotate(
        root_q, _f64(cst.ROOT_COM_OFFSET, device))
    root_pq = torch.cat([root_imu_p, root_q], dim=-1)   # (T, 7)

    def gather(joints):
        return torch.stack([root_pq if j == -1 else pq_com[:, j + 1]
                            for j in joints], dim=1)

    imu_joints = (char.IMU_JOINTS_KNEE if use_knee_imu
                  else char.IMU_JOINTS_ANKLE)
    return {
        "pq_imu": gather(imu_joints),              # (T, 6, 7)
        "pq_sbp": gather(char.SBP_LINKS),          # (T, 5, 7)
    }


def imu_from_fk(pq_imu) -> np.ndarray:
    """(T, 6, 7) sensor frames -> (T, 72) [6x R(9), 6x acc(3)] with central
    second-difference accelerations (reference :147-218)."""
    T = pq_imu.shape[0]
    R = rot.q_to_matrix(pq_imu[..., 3:])           # (T, 6, 3, 3)
    acc = imu_ops.central_diff_acc(pq_imu[..., :3])
    return torch.cat([R.reshape(T, 54), acc.reshape(T, 18)],
                     dim=1).cpu().numpy()


def sbp_labels(pq_sbp, dt: float = cst.DT) -> np.ndarray:
    """(T, 5, 7) -> (T, 20) SBP constraint labels, each link over its own
    grid, the five links in one loop over frames."""
    grids = [sbp_ops.grid_for_link(link) for link in char.SBP_LINKS]
    seq = sbp_ops.link_contact_sequences(pq_sbp, dt, grids)   # (T, 5, 4)
    return seq.reshape(len(seq), 20).cpu().numpy()


def nimble_qdq(aa60, trans60, dt: float = cst.DT,
               device=None) -> np.ndarray:
    """(T, 114) nimble-ordered ground truth (reference
    data_utils.get_raw_motion_info_nimble_q_dummy_dq, data_utils.py:103-161):
    [root xyz, root aa, 17 joint aa (nimble-state order), root v, root w,
    17 zero joint velocities]. Root angular velocity is the *local-frame*
    rotvec difference / dt; joint velocities are zeros by design."""
    device = resolve_device(device)
    aa60 = np.asarray(aa60, np.float64)
    T = len(aa60)
    q = np.zeros((T, 51))
    char_aa = aa60[:, smpl.CHAR_TO_SMPL]           # (T, 19, 3)
    for bullet_j, slot in zip(char.NON_ROOT_ACTIVE_IDX, _N_STATE):
        q[:, slot * 3: slot * 3 + 3] = char_aa[:, bullet_j]

    root_aa = aa60[:, 0]
    p = np.asarray(trans60, np.float64)
    # next-frame root state at t + dt == next sample (the grid step is dt);
    # the final frame clamps (fairmotion get_pose_by_time clamps at the end)
    p_n = np.concatenate([p[1:], p[-1:]], axis=0)
    aa_n = np.concatenate([root_aa[1:], root_aa[-1:]], axis=0)

    v = (p_n - p) / dt
    q_cur = rot.aa_to_q(_f64(root_aa, device))
    q_nxt = rot.aa_to_q(_f64(aa_n, device))
    dq = rot.q_mult(rot.q_conj(q_cur), q_nxt)
    w = rot.q_to_aa(dq).cpu().numpy() / dt

    out = np.concatenate([
        p, root_aa, q, v, w, np.zeros((T, 51))], axis=1)
    if out.shape[1] != 114:
        raise ValueError(f"nimble qdq has {out.shape[1]} columns, not 114")
    return out


def synthesize(motion: smpl.SmplMotion, height: Optional[float] = None,
               rng: Optional[np.random.Generator] = None,
               use_knee_imu: bool = True,
               device=None) -> Dict[str, np.ndarray]:
    """Full per-motion synthesis -> {imu, nimble_qdq, constrs} (the
    per-motion pkl payload, reference :273-278), computed in float64 on
    ``device`` and returned as host arrays."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng()
    if height is None:
        height = cst.NOMINAL_H * rng.uniform(0.9, 1.1)

    aa60, trans60, _ = smpl.resample_motion(motion)
    if len(aa60) < 2 + 2 * cst.ACC_FD_N:
        raise ValueError("motion too short")

    fk = fk_motion(aa60, trans60, height, use_knee_imu=use_knee_imu,
                   device=device)
    return {
        "imu": imu_from_fk(fk["pq_imu"]),
        "nimble_qdq": nimble_qdq(aa60, trans60, device=device),
        "constrs": sbp_labels(fk["pq_sbp"]),
    }


def synthesize_file(npz_path: str, save_path: str,
                    rng: Optional[np.random.Generator] = None,
                    device=None) -> bool:
    try:
        motion = smpl.load_amass_npz(npz_path)
        payload = synthesize(motion, rng=rng, device=device)
    except Exception as e:  # noqa: BLE001 — skip-and-continue, ref :282-284
        print(f"ignored: {npz_path} error: {e}")
        return False
    with open(save_path, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    return True
