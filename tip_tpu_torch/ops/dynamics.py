"""PD-family control torques for spherical-joint characters (twin of
tip_tpu/ops/dynamics.py).

The reference carries the ScaDiver actuation surface: explicit PD force
computation (bullet_utils.compute_PD_forces, bullet_utils.py:330-364) and
SPD / PD / CPD gain modes that delegate to PyBullet's in-engine controllers
(bullet_agent.actuate, bullet_agent.py:551-676; gains in
amass_char_info.py:225-280, cpd_ratio 0.0002 at :257). None of it is on
TIP's kinematic hot path; it is part of the character-animation surface,
given here as batched torch ops:

  * ``pd_torques``: explicit PD. The quaternion error is the axis-angle of
    (current^-1 o desired), PyBullet's getAxisDifferenceQuaternion;
  * ``spd_torques``: stable PD without a mass matrix (Tan et al.'s SPD):
    the position error is taken at the dt-predicted rotation, the explicit
    kd damping on the current velocity;
  * ``mode_gains``: the reference's per-mode gains (SPD: kp, kd as they
    are; PD: 1.5 kp, 0.01 kd, bullet_agent.py:607-609; CPD/CP/V: scaled by
    cpd_ratio, :610-614).

Bullet's POSITION/VELOCITY constraint controllers (CPD/CP/V) solve the
servo inside its contact solver; with no physics engine those modes are
their gain tables and the explicit torque math only.

``KP``, ``KD`` and ``MAX_FORCE`` are float64 host tables; the torque
functions take their gains on the device and in the dtype of ``q_cur``
unless given others, and ``mode_gains`` makes them on the device it is
given (``cuda`` unless told otherwise).
"""

import torch

from tip_tpu_torch import resolve_device
from tip_tpu_torch.ops import rotations as rot

# per-joint PD gains and force limits in bullet joint order
# (reference amass_char_info.py:225-280; kd = 0.1 kp)
KP = torch.tensor([500., 400, 300, 500, 400, 300, 500, 500, 500, 200, 200,
                   400, 400, 300, 0, 400, 400, 300, 0], dtype=torch.float64)
KD = 0.1 * KP
MAX_FORCE = torch.tensor([300., 200, 100, 300, 200, 100, 300, 300, 300, 100,
                          100, 200, 200, 150, 0, 200, 200, 150, 0],
                         dtype=torch.float64)
CPD_RATIO = 2e-4                 # reference amass_char_info.py:257


def mode_gains(mode: str, device=None, dtype=torch.float32):
    """(kp, kd) per actuation mode (reference bullet_agent.py:602-614), on
    ``device`` (``cuda`` unless given) in ``dtype``."""
    if mode == "SPD":
        kp, kd = KP, KD
    elif mode == "PD":
        kp, kd = 1.5 * KP, 0.01 * KD
    elif mode in ("CPD", "CP", "V"):
        kp, kd = CPD_RATIO * KP, CPD_RATIO * KD
    else:
        raise ValueError(f"unknown actuation mode {mode!r}")
    device = resolve_device(device)
    return kp.to(device, dtype), kd.to(device, dtype)


def _gains(like, kp, kd, max_force):
    def on(t, default):
        t = default if t is None else torch.as_tensor(t)
        return t.to(like.device, like.dtype)

    return on(kp, KP), on(kd, KD), on(max_force, MAX_FORCE)


def _torques(q_err, w_cur, w_des, kp, kd, max_force):
    tau = kp[..., :, None] * q_err + kd[..., :, None] * (w_des - w_cur)
    lim = max_force[..., :, None]
    return torch.clamp(tau, -lim, lim)


def pd_torques(q_cur, q_des, w_cur, w_des, kp=None, kd=None,
               max_force=None):
    """Batched spherical-joint PD torques.

    Args:
      q_cur/q_des: (..., J, 4) current/desired local joint quaternions (xyzw)
      w_cur/w_des: (..., J, 3) current/desired local angular velocities
      kp/kd/max_force: (..., J) gains and limits (default ``KP``, ``KD``,
        ``MAX_FORCE``)
    Returns (..., J, 3) torques, clipped to the per-joint force limits.
    """
    kp, kd, max_force = _gains(q_cur, kp, kd, max_force)
    q_err = rot.q_to_aa(rot.q_mult(rot.q_conj(q_cur), q_des))
    return _torques(q_err, w_cur, w_des, kp, kd, max_force)


def spd_torques(q_cur, q_des, w_cur, w_des, dt: float, kp=None, kd=None,
                max_force=None):
    """Stable-PD torques (mass-matrix-free SPD, Tan, Liu & Turk 2011, the
    algorithm behind PyBullet's STABLE_PD_CONTROL): the proportional error
    at the dt-predicted rotation,

        tau = kp * log((q_cur (+) dt w_cur)^-1 o q_des) + kd (w_des - w_cur)

    (Bullet also solves through the joint-space mass matrix; with no
    dynamics engine the inertia term is the identity.) Arguments as
    ``pd_torques`` plus the control timestep dt.
    """
    kp, kd, max_force = _gains(q_cur, kp, kd, max_force)
    q_pred = rot.q_mult(q_cur, rot.aa_to_q(w_cur * dt))
    q_err = rot.q_to_aa(rot.q_mult(rot.q_conj(q_pred), q_des))
    return _torques(q_err, w_cur, w_des, kp, kd, max_force)
