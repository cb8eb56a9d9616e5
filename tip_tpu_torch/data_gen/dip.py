"""DIP-IMU / TotalCapture real-sensor preprocessing (twin of
tip_tpu/data_gen/dip.py).

Equivalent of the reference's preprocess_DIP_TC_new.py:38-396 without
fairmotion/PyBullet:

  * select 6 of the 17 DIP sensor slots ([2, 7, 8, 11, 12, 0] ->
    root, lwrist, rwrist, lknee, rknee, head; reference :166-167); the
    TotalCapture release stores only those 6 in the order
    [11, 12, 7, 8, 0, 2] (reference :82-90);
  * impute NaN sensor dropouts from trailing means (reference :112-136);
  * rotate into the z-up frame (rot_up for DIP; x+90deg for TC,
    reference :363-388);
  * build nimble-qdq ground truth from the SMPL 'gt' poses with a synthetic
    upright root for DIP (no translation: root_R = rot_up x belly_R,
    p = (0, 0, 0.95); reference :98-107) or the provided translation for TC;
  * merge the shipped synthetic SBP labels (data/source/preprocessed_DIP_IMU_c)
    into the training pickles (reference :278-314) and split subjects 1-8
    train / 9-10 test (reference :317-338).

The ground truth's root velocity is computed in float64 on ``device``
(``cuda`` unless the caller asks for another; data_gen/amass_syn.py).
"""

import os
import pickle
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from tip_tpu_torch import constants as cst
from tip_tpu_torch.data_gen import smpl
from tip_tpu_torch.data_gen.amass_syn import nimble_qdq

# DIP 17-sensor slots for [root, lwrist, rwrist, lknee, rknee, head]
DIP_SENSORS = (2, 7, 8, 11, 12, 0)
# TotalCapture stores (ll, rl, lw, rw, h, r) -> scatter into DIP slots
TC_SCATTER = (11, 12, 7, 8, 0, 2)

ROT_UP_R = Rotation.from_quat(cst.ROT_UP_Q).as_matrix()
ROT_TC_R = Rotation.from_rotvec([np.pi / 2, 0, 0]).as_matrix()


def load_imu_17(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """DIP pkl ('imu_ori'/'imu_acc', 17 slots) or TC pkl ('ori'/'acc', 6
    sensors scattered into 17 slots)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if "imu_ori" in data:
        return np.array(data["imu_ori"]), np.array(data["imu_acc"])
    ori6 = np.array(data["ori"])
    acc6 = np.array(data["acc"])
    T = len(ori6)
    ori = np.zeros((T, 17, 3, 3))
    acc = np.zeros((T, 17, 3))
    ori[:, TC_SCATTER] = ori6
    acc[:, TC_SCATTER] = acc6
    return ori, acc


def fill_nan_trailing_mean(h_ori: np.ndarray, h_acc: np.ndarray):
    """Sensor-dropout imputation (reference preprocess_DIP_TC_new.py
    :112-136): NaN frames take the nanmean of the previous 5 frames (first
    10 frames: of frames 0..9). h_ori (T, 6, 3, 3) and h_acc (T, 6, 3) are
    filled in place and returned."""
    m_len = len(h_ori)
    mask = np.isnan(h_ori.reshape(m_len, 6, 9).sum(axis=2))
    for t in range(m_len):
        for i in range(6):
            if mask[t, i]:
                src = h_ori[0:10, i] if t <= 10 else h_ori[t - 5:t, i]
                h_ori[t, i] = np.nanmean(src, axis=0)
    mask = np.isnan(h_acc.sum(axis=2))
    for t in range(m_len):
        for i in range(6):
            if mask[t, i]:
                src = h_acc[0:10, i] if t <= 10 else h_acc[t - 5:t, i]
                h_acc[t, i] = np.nanmean(src, axis=0)
    if not (np.isfinite(h_ori).all() and np.isfinite(h_acc).all()):
        raise ValueError("fill_nan_trailing_mean: a dropout has no data in "
                         "the frames it takes its mean of")
    return h_ori, h_acc


def real_imu_to_features(imu_r17: np.ndarray, imu_acc17: np.ndarray,
                         rot_mat: np.ndarray) -> np.ndarray:
    """17-slot sensor stream -> (T, 72) feature rows in our layout
    (reference get_real_imu_readings_ours_format_knee, :160-180)."""
    h_ori = imu_r17[:, DIP_SENSORS].copy()
    h_acc = imu_acc17[:, DIP_SENSORS].copy()
    h_ori, h_acc = fill_nan_trailing_mean(h_ori, h_acc)
    h_acc = np.einsum("jk,abk->abj", rot_mat, h_acc)
    h_ori = np.einsum("jk,abki->abji", rot_mat, h_ori)
    return np.concatenate(
        [h_ori.reshape(-1, 54), h_acc.reshape(-1, 18)], axis=1)


def _qdq_from_gt(motion: smpl.SmplMotion, has_trans: bool,
                 device=None) -> np.ndarray:
    """Resample + nimble-qdq with the reference's root augmentation:
    DIP (no translation): root_R = rot_up . belly_R, p = (0, 0, 0.95)."""
    aa60, trans60, _ = smpl.resample_motion(motion)
    if not has_trans:
        belly = Rotation.from_rotvec(aa60[:, 0]).as_matrix()
        root = np.einsum("jk,tki->tji", ROT_UP_R, belly)
        aa60 = aa60.copy()
        aa60[:, 0] = Rotation.from_matrix(root).as_rotvec()
        trans60 = np.tile([0.0, 0.0, cst.ROOT_Z_OFFSET], (len(aa60), 1))
    return nimble_qdq(aa60, trans60, device=device)


def preprocess_dip_file(gt_path: str, device=None) -> Dict[str, np.ndarray]:
    """One DIP pkl -> {imu (T,72), nimble_qdq (T,114)}."""
    motion = smpl.load_dip_pkl(gt_path)
    ori, acc = load_imu_17(gt_path)
    return {
        "imu": real_imu_to_features(ori, acc, ROT_UP_R),
        "nimble_qdq": _qdq_from_gt(motion, has_trans=False, device=device),
    }


def preprocess_tc_pair(gt_npz: str, imu_pkl: str,
                       device=None) -> Dict[str, np.ndarray]:
    """TotalCapture: AMASS-format gt npz + 60 FPS real-IMU pkl."""
    motion = smpl.load_amass_npz(gt_npz)
    ori, acc = load_imu_17(imu_pkl)
    return {
        "imu": real_imu_to_features(ori, acc, ROT_TC_R),
        "nimble_qdq": nimble_qdq(*smpl.resample_motion(motion)[:2],
                                 device=device),
    }


def augment_with_sbp(motion_dir: str, sbp_dir: str, out_dir: str) -> int:
    """Merge shipped SBP label pickles into preprocessed DIP motions
    (reference :278-314)."""
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(motion_dir)):
        if not name.endswith(".pkl"):
            continue
        sbp_path = os.path.join(sbp_dir, name)
        out_path = os.path.join(out_dir, name)
        if not os.path.exists(sbp_path) or os.path.exists(out_path):
            continue
        with open(os.path.join(motion_dir, name), "rb") as f:
            motion = pickle.load(f)
        with open(sbp_path, "rb") as f:
            sbp = pickle.load(f)
        with open(out_path, "wb") as f:
            pickle.dump({"imu": motion["imu"],
                         "nimble_qdq": motion["nimble_qdq"],
                         "constrs": sbp["constrs"]}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        count += 1
    return count


def copy_train_split(all_dir: str) -> int:
    """Subjects 1-8 train; 9-10 stay as the test split (reference :317-338)."""
    out = all_dir + "_train"
    os.makedirs(out, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(all_dir)):
        if not name.endswith(".pkl"):
            continue
        if name.startswith(("dipimu_s_09", "dipimu_s_10")):
            continue
        shutil.copyfile(os.path.join(all_dir, name), os.path.join(out, name))
        count += 1
    return count
