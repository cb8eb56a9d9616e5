"""DIP-IMU / TotalCapture real-sensor preprocessing (twin of
tip_tpu/data_gen/dip.py), so far only its dropout imputation,
``fill_nan_trailing_mean``, which the off-distribution evaluation
(eval_corruption.py) repairs its dropout bursts with. The rest of the
module (loading the 17-slot DIP and TotalCapture pickles, the z-up frame,
the SMPL ground truth, the SBP label merge and the subject split) is
ROADMAP A5, data generation.
"""

import numpy as np


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
