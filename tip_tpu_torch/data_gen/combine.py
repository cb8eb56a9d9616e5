"""Pack per-motion pickles into flat training blobs (twin of
tip_tpu/data_gen/combine.py, the same blobs):

  <prefix>_imu.npy      (N, 72)   root-local IMU features (acc pre-smoothed
                                  with an 11-frame 'nearest' moving average
                                  + constant per-sequence bias noise)
  <prefix>_sum_imu.npy  (N, 18)   windowed acc-sum / 15
  <prefix>_s.npy        (N, 131)  [108 two-axis pose, 3 root vel, 20 SBP]
  <prefix>_info.npy     (M, 3)    [start, end, downsample] segment table

Per motion: crop 4 frames at each end; DIP sequences get NaN root velocity
(no translation ground truth -> excluded from the loss). The features are
computed in float64 on the CPU with the port's ops and stored float32; the
bias noise is drawn from numpy's ``default_rng`` in tip_tpu's order, so one
seed gives tip_tpu's blobs to float32 rounding.
"""

import os
import pickle
import re
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch.ops import imu as imu_ops
from tip_tpu_torch.ops import rotations as rot


def _features(imu, bias, s_aa):
    """imu (T, 72), bias (18,), s_aa (T, 18, 3), float64 tensors ->
    (root-local IMU (T, 72), acc-sum (T, 18), 6D pose (T, 18, 6))."""
    acc = imu_ops.uniform_filter1d_nearest(
        imu[:, 54:72], cst.ACC_MOVING_AVE_LEN, dim=0) + bias
    imu_local = imu_ops.imu_rotate_to_local(torch.cat([imu[:, :54], acc], 1))
    acc_sum = imu_ops.windowed_acc_sum(imu_local[:, 54:72])
    return imu_local, acc_sum, rot.aa_to_sixd(s_aa)


def process_motion(payload: dict, is_dip: bool, rng: np.random.Generator):
    """One motion pkl -> (imu_local (T,72), acc_sum (T,18), state (T,131))
    float32, or None if too short."""
    imu = np.array(payload["imu"], np.float64)
    s = np.array(payload["nimble_qdq"], np.float64)
    c = np.array(payload["constrs"], np.float64)
    if is_dip:
        s[:, cst.N_DOFS:cst.N_DOFS + 3] = np.nan
    if abs(len(imu) - len(s)) > 1:
        raise ValueError(f"imu ({len(imu)}) and state ({len(s)}) lengths "
                         f"differ by more than one frame")
    m_len = min(len(imu), len(s))
    if m_len <= cst.ACC_SUM_WIN_LEN:
        return None
    imu, s, c = imu[4:m_len - 4], s[4:m_len - 4], c[4:m_len - 4]

    # constant per-sequence accelerometer bias noise
    bias = rng.uniform(-cst.BIAS_NOISE_ACC, cst.BIAS_NOISE_ACC, 18)
    s_q = s[:, 3:cst.N_DOFS + 3]
    imu_local, acc_sum, sixd = _features(
        torch.from_numpy(imu), torch.from_numpy(bias),
        torch.from_numpy(np.ascontiguousarray(s_q[:, :54]).reshape(-1, 18, 3)))
    s_2axis = np.concatenate([sixd.numpy().reshape(len(s_q), 108),
                              s_q[:, 54:57]], axis=1)
    out_s = np.concatenate([s_2axis, c], axis=1)
    return (imu_local.numpy().astype(np.float32),
            acc_sum.numpy().astype(np.float32), out_s.astype(np.float32))


def combine(dataset_dirs: Sequence[str], downsample_rates: Sequence[int],
            out_prefix: str, name_contains: Optional[List[str]] = None,
            seed: int = 42):
    """Walk per-motion pkl dirs and write the four blobs; returns the info
    table. DIP dirs are recognised by 'preprocessed_DIP_IMU' in the path."""
    if len(dataset_dirs) != len(downsample_rates):
        raise ValueError("one downsample rate per dataset directory")
    rng = np.random.default_rng(seed)
    imus, sums, states, info = [], [], [], []
    start_f = end_f = 0
    t0 = time.time()
    for d, rate in zip(dataset_dirs, downsample_rates):
        is_dip = "preprocessed_DIP_IMU" in d
        files = []
        for f in sorted(os.listdir(d)):
            p = os.path.join(d, f)
            if not (p.endswith(".pkl") and os.path.isfile(p)):
                continue
            if name_contains and not any(
                    re.search(nc, p, re.IGNORECASE) for nc in name_contains):
                continue
            files.append(p)
        for p in files:
            with open(p, "rb") as f:
                payload = pickle.load(f)
            res = process_motion(payload, is_dip, rng)
            if res is None:
                print("too short:", p)
                continue
            imu_local, acc_sum, out_s = res
            end_f += len(imu_local)
            imus.append(imu_local)
            sums.append(acc_sum)
            states.append(out_s)
            info.append([start_f, end_f, rate])
            start_f = end_f
    if not imus:
        raise ValueError(
            f"no motions to pack: nothing under {list(dataset_dirs)} "
            f"survived the name_contains filter ({name_contains or 'none'}) "
            f"and the min-length check")
    info = np.array(info, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)
    np.save(f"{out_prefix}_imu.npy", np.concatenate(imus))
    np.save(f"{out_prefix}_sum_imu.npy", np.concatenate(sums))
    np.save(f"{out_prefix}_s.npy", np.concatenate(states))
    np.save(f"{out_prefix}_info.npy", info)
    print(f"packed {len(info)} motions, {end_f} frames in "
          f"{time.time() - t0:.1f}s")
    return info
