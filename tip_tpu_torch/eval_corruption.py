"""Sensor-corruption models for off-distribution evaluation (twin of
tip_tpu/eval_corruption.py: numpy and scipy on the host, the same draws in
the same order, so one seed corrupts a stream as tip_tpu does).

The reference evaluates cross-domain (train on synthetic AMASS + DIP s1-8,
test on real DIP s9/10 / TotalCapture); with the real archives absent the
achievable analog is to corrupt the held-out synthetic streams with the
real-sensor failure modes the reference pipeline handles and measure the
quality degradation:

  * **NaN dropout bursts** — DIP sensors drop out for stretches; the
    reference repairs them with trailing-mean imputation
    (preprocess_DIP_TC_new.py:112-136). Corrupted streams here are repaired
    through our transcription of that exact path
    (data_gen.dip.fill_nan_trailing_mean), so this measures the end-to-end
    dropout tolerance of imputation + model.
  * **Constant per-sensor accelerometer bias** — train-time augmentation
    draws a per-sequence bias in ±0.1 m/s² per axis
    (tip_tpu_torch.constants.BIAS_NOISE_ACC; reference
    preprocess_and_combine_syn_amass.py:86). Evaluating beyond that range
    probes how far the learned bias tolerance extends.
  * **Calibration rotation error** — a fixed small rotation per sensor
    (mount misalignment after the reference's calibration step,
    live_demo_* calibration): both the orientation matrix and the
    acceleration vector are pre-rotated by the same error.

All corruption is applied to the (T, 72) feature stream ([6x9 rot, 6x3 acc],
sensor order root/lwrist/rwrist/lknee/rknee/head — data_gen.dip layout)
deterministically from (seed, motion index), so sweeps are reproducible.
"""

import dataclasses
from typing import Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from tip_tpu_torch.data_gen.dip import fill_nan_trailing_mean

N_SENSORS = 6
FPS = 60.0


@dataclasses.dataclass(frozen=True)
class CorruptionConfig:
    """Zero rates/magnitudes disable the corresponding corruption."""
    # expected dropout bursts per second per sensor; burst length drawn
    # uniformly from dropout_len_s
    dropout_rate_hz: float = 0.0
    dropout_len_s: Tuple[float, float] = (0.05, 0.5)
    # constant per-sensor accelerometer bias magnitude (m/s^2), random
    # direction. Train-time augmentation covers per-axis U(-0.1, 0.1)
    # (constants.BIAS_NOISE_ACC) ~ 0.1 magnitude scale.
    acc_bias: float = 0.0
    # constant per-sensor calibration rotation error, degrees, random axis
    calib_rot_deg: float = 0.0

    def label(self) -> str:
        parts = []
        if self.dropout_rate_hz:
            part = f"drop{self.dropout_rate_hz:g}Hz"
            if self.dropout_len_s != (0.05, 0.5):
                part += (f"x{self.dropout_len_s[0]:g}"
                         f"-{self.dropout_len_s[1]:g}s")
            parts.append(part)
        if self.acc_bias:
            parts.append(f"bias{self.acc_bias:g}")
        if self.calib_rot_deg:
            parts.append(f"calib{self.calib_rot_deg:g}deg")
        return "+".join(parts) or "clean"


def split_features(imu: np.ndarray):
    """(T, 72) -> (ori (T, 6, 3, 3), acc (T, 6, 3)) views (copies)."""
    T = len(imu)
    ori = imu[:, :54].reshape(T, N_SENSORS, 3, 3).copy()
    acc = imu[:, 54:].reshape(T, N_SENSORS, 3).copy()
    return ori, acc


def merge_features(ori: np.ndarray, acc: np.ndarray) -> np.ndarray:
    T = len(ori)
    return np.concatenate([ori.reshape(T, 54), acc.reshape(T, 18)], axis=1)


def corrupt_imu(imu: np.ndarray, cfg: CorruptionConfig,
                rng: np.random.Generator) -> np.ndarray:
    """Apply the configured corruption to one motion's feature stream.

    Dropout bursts are NaN'd then repaired through the reference imputation
    path, so the returned stream is always finite (as a real pipeline's
    output would be)."""
    ori, acc = split_features(np.asarray(imu, np.float64))

    if cfg.calib_rot_deg > 0.0:
        axes = rng.normal(size=(N_SENSORS, 3))
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        R_err = Rotation.from_rotvec(
            axes * np.deg2rad(cfg.calib_rot_deg)).as_matrix()
        ori = np.einsum("sij,tsjk->tsik", R_err, ori)
        acc = np.einsum("sij,tsj->tsi", R_err, acc)

    if cfg.acc_bias > 0.0:
        dirs = rng.normal(size=(N_SENSORS, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        acc = acc + cfg.acc_bias * dirs[None]

    if cfg.dropout_rate_hz > 0.0:
        T = len(ori)
        for s in range(N_SENSORS):
            n_bursts = rng.poisson(cfg.dropout_rate_hz * T / FPS)
            for _ in range(n_bursts):
                length = max(1, int(rng.uniform(*cfg.dropout_len_s) * FPS))
                # keep the first frames clean: the imputation's t<=10 branch
                # nanmeans frames 0..9, which must contain data
                t0 = int(rng.integers(2, max(3, T - length)))
                ori[t0:t0 + length, s] = np.nan
                acc[t0:t0 + length, s] = np.nan
        ori, acc = fill_nan_trailing_mean(ori, acc)

    return merge_features(ori, acc).astype(np.asarray(imu).dtype)


# degradation-sweep ladder (tip_tpu's scripts/eval_corruption.py sweeps
# it); the first rung of each group sits at/below the train-time
# augmentation level
SWEEP = (
    CorruptionConfig(),
    CorruptionConfig(acc_bias=0.1),
    CorruptionConfig(acc_bias=0.5),
    CorruptionConfig(acc_bias=1.0),
    CorruptionConfig(calib_rot_deg=2.0),
    CorruptionConfig(calib_rot_deg=5.0),
    CorruptionConfig(calib_rot_deg=10.0),
    CorruptionConfig(dropout_rate_hz=0.2),
    CorruptionConfig(dropout_rate_hz=1.0),
    CorruptionConfig(dropout_rate_hz=1.0, dropout_len_s=(0.5, 2.0)),
    CorruptionConfig(dropout_rate_hz=0.5, acc_bias=0.5, calib_rot_deg=5.0),
)
