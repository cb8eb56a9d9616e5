"""Procedural motion corpus: IK-planned human motions for training at scale
(twin of tip_tpu/data_gen/corpus.py).

The reference trains on AMASS mocap synthesized into virtual IMU streams
(data-gen-and-viz-bullet-new.py:38-312).  The AMASS source archives are not
present in this environment, so this module provides the corpus the
convergence recipe trains on: procedurally *planned* motions whose feet are
placed by analytic two-bone leg IK against the character's own bone
geometry.  That construction makes the labels honest where it matters:

  * stance feet are world-stationary by construction, so the SBP rot-center
    grid search (ops/sbp.py, reference data_utils.py:27-100) finds real
    contacts and the root-drift correction path trains on real signal;
  * stairs/ramp ground profiles put those contacts at varying heights, so
    the terrain estimation path (runtime/terrain.py) sees realistic input;
  * walks turn and change speed, so the root-velocity labels are varied.

Motion families: walking (flat / ramp / stairs / bumps ground, turning,
speed changes), idle stands with weight shifts and arm reaches, squats, and
free-form joint-swing fields (non-contact diversity).  All are emitted as
`smpl.SmplMotion` (y-up SMPL axis-angle convention, root slot pre-rotated
into z-up world exactly like an AMASS clip) and synthesized into training
pickles by `data_gen.amass_syn.synthesize` (float64 on the caller's
device). The planners are numpy and scipy on the host, as tip_tpu's are, so
one seed gives tip_tpu's motions bit for bit (tests/test_torch_corpus.py).

Geometry conventions (tip_tpu's tests/test_corpus.py holds the FK proof):
  * character body frame is y-up SMPL: legs along -y, +z forward, +x left;
  * `kin.fk` composes joint rotations in the parent frame with all rest
    frames aligned to the root, so planning in pelvis-local coordinates
    yields local joint rotations directly;
  * bone vectors come from `kin.amass_skeleton()` joint offsets (scale 1;
    `synthesize`'s random body height is a uniform scale on top, which
    preserves stance-foot stationarity).
"""

import os
import pickle
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
from scipy.spatial.transform import Rotation

from tip_tpu_torch import constants as cst
from tip_tpu_torch.data_gen import smpl

# bullet joint indices of the leg chain (chars/amass.py joint order)
_LHIP, _LKNEE, _LANKLE = 0, 1, 2
_RHIP, _RKNEE, _RANKLE = 3, 4, 5

# world up conversion: SMPL y-up body -> z-up world (x->y, y->z, z->x)
_R_ZUP = Rotation.from_rotvec(np.full(3, 1.20919958))

FPS = 120.0                     # authoring rate; resampled to 60 Hz later
ANKLE_REST_H = 0.08             # ankle joint height when the foot is flat


def _norm(v, axis=-1, keepdims=True):
    return np.linalg.norm(v, axis=axis, keepdims=keepdims)


def _unit(v):
    return v / np.maximum(_norm(v), 1e-9)


def _frame(u, n):
    """(..., 3, 3) orthonormal basis with columns [u_hat, n ⊥ u, u x n]."""
    u = _unit(u)
    n = _unit(n - np.sum(n * u, -1, keepdims=True) * u)
    return np.stack([u, n, np.cross(u, n)], axis=-1)


@dataclass
class LegGeometry:
    hip_off: np.ndarray         # (3,) hip joint in root frame
    b1: np.ndarray              # (3,) thigh bone vector (hip frame)
    b2: np.ndarray              # (3,) shank bone vector (knee frame)
    l1: float
    l2: float


def leg_geometry():
    """Leg bone vectors from the character skeleton (scale 1)."""
    from tip_tpu_torch.chars import amass_skeleton as sk
    # the skeleton's offsets rounded to float32 and widened, as tip_tpu's
    # planners read them from its float32 skeleton: every motion depends on
    # these bits
    off = np.asarray(sk.JOINT_OFFSET, np.float32).astype(np.float64)

    def leg(hip, knee, ankle):
        return LegGeometry(hip_off=off[hip], b1=off[knee], b2=off[ankle],
                           l1=float(np.linalg.norm(off[knee])),
                           l2=float(np.linalg.norm(off[ankle])))

    return leg(_LHIP, _LKNEE, _LANKLE), leg(_RHIP, _RKNEE, _RANKLE)


def solve_two_bone(b1, b2, v, pole):
    """Generic analytic two-bone IK core, vectorized over frames.

    Used for both legs (hip-knee-ankle) and arms (shoulder-elbow-wrist);
    the reference drives limbs with numeric two-joint IK at runtime
    (real_time_runner.py:334-382) but has no planner — this is corpus
    authoring machinery, so closed form exactness is the requirement.

    Args:
      b1: (3,) rest first-bone vector in the base frame.
      b2: (3,) rest second-bone vector in the mid-joint frame.
      v:  (T, 3) target end point relative to the chain base joint, in the
          base frame (clamped into the reachable annulus).
      pole: (3,) bend direction in the base frame: the mid joint bulges
          toward the component of ``pole`` orthogonal to the target line.
    Returns (R1, R2, aa1, aa2): local rotation matrices (T, 3, 3) and their
    axis-angles (T, 3) for the base and mid joints.
    """
    l1 = float(np.linalg.norm(b1))
    l2 = float(np.linalg.norm(b2))
    d = np.linalg.norm(v, axis=-1)
    d = np.clip(d, 0.35 * (l1 + l2), 0.999 * (l1 + l2))
    d_hat = _unit(v)

    pole = np.asarray(pole, np.float64)
    p_hat = _unit(pole - np.sum(pole * d_hat, -1, keepdims=True) * d_hat)

    cos_beta = (l1 ** 2 + d ** 2 - l2 ** 2) / (2 * l1 * d)
    beta = np.arccos(np.clip(cos_beta, -1.0, 1.0))[:, None]
    u_hat = np.cos(beta) * d_hat + np.sin(beta) * p_hat    # first-bone dir
    w_hat = _unit(d[:, None] * d_hat - l1 * u_hat)         # second-bone dir

    # base joint: map the rest first-bone frame onto the target frame
    n_t = _unit(np.cross(p_hat, d_hat))                    # bend normal
    b1_hat = b1 / l1
    n_r = _unit(np.cross(np.array([0.0, 0.0, 1.0]), b1_hat))
    A = _frame(np.broadcast_to(b1_hat, u_hat.shape),
               np.broadcast_to(n_r, u_hat.shape))
    B = _frame(u_hat, n_t)
    R1 = B @ np.swapaxes(A, -1, -2)

    # mid joint: minimal rotation (in the first-bone frame) taking the rest
    # second bone onto the IK direction
    w_local = np.einsum("tji,tj->ti", R1, w_hat)
    b2_hat = b2 / l2
    axis = np.cross(np.broadcast_to(b2_hat, w_local.shape), w_local)
    s = np.linalg.norm(axis, axis=-1)
    c = np.clip(np.sum(b2_hat * w_local, -1), -1.0, 1.0)
    ang = np.arctan2(s, c)
    aa2 = np.where(s[:, None] > 1e-9,
                   axis / np.maximum(s[:, None], 1e-9) * ang[:, None],
                   0.0)
    R2 = Rotation.from_rotvec(aa2).as_matrix()
    return R1, R2, Rotation.from_matrix(R1).as_rotvec(), aa2


def solve_leg(geo: LegGeometry, pelvis_p, pelvis_R, ankle_w, foot_R_w):
    """Two-bone analytic leg IK, vectorized over frames.

    Args:
      pelvis_p: (T, 3) root position (world).
      pelvis_R: (T, 3, 3) root orientation (world <- body).
      ankle_w:  (T, 3) target ankle-joint world positions.
      foot_R_w: (T, 3, 3) target world foot orientations.
    Returns (hip_aa, knee_aa, ankle_aa), each (T, 3) local axis-angles.
    """
    # target in pelvis-local (= body) coordinates, relative to the hip
    v = np.einsum("tji,tj->ti", pelvis_R, ankle_w - pelvis_p) - geo.hip_off
    # knee aims forward (+z in body frame) with a touch of outward toe
    fwd = np.array([0.12 * np.sign(geo.hip_off[0]), 0.0, 1.0])
    R_h, R_k, hip_aa, knee_aa = solve_two_bone(geo.b1, geo.b2, v, fwd)

    # ankle: local rotation achieving the requested world foot orientation
    R_shank_w = pelvis_R @ R_h @ R_k
    R_a = np.swapaxes(R_shank_w, -1, -2) @ foot_R_w

    return hip_aa, knee_aa, Rotation.from_matrix(R_a).as_rotvec()


# ---------------------------------------------------------------------------
# arm IK (planted-hand families: floor-sit, crawl, hand-lean)
# ---------------------------------------------------------------------------

# char joint indices of the arm chains (chars/amass_skeleton.py order)
_L_CLAV, _L_SHO, _L_ELB, _L_WRI = 11, 12, 13, 14
_R_CLAV, _R_SHO, _R_ELB, _R_WRI = 15, 16, 17, 18


def np_fk_chain(aa24, pelvis_p, pelvis_R):
    """Host-side FK of the char skeleton over authored SMPL axis-angles.

    Mirrors ops.kinematics.fk joint-frame semantics (rest frames aligned to
    the root, offsets rotated by the parent chain) in plain numpy so motion
    planners can query chain anchors — e.g. the world shoulder position and
    clavicle-frame orientation the arm IK solves against — for arbitrary
    torso poses (tip_tpu's tests/test_corpus.py holds it against kin.fk).

    Args:
      aa24: (T, 24, 3) SMPL-indexed local axis-angles (authoring format).
      pelvis_p / pelvis_R: (T, 3) / (T, 3, 3) world root pose.
    Returns (p_jf (T, 19, 3) world joint positions,
             R_w (T, 19, 3, 3) world link orientations).
    """
    from tip_tpu_torch.chars import amass_skeleton as sk
    from tip_tpu_torch.data_gen.smpl import CHAR_TO_SMPL
    aa19 = np.asarray(aa24)[:, CHAR_TO_SMPL]
    T = len(aa19)
    p = np.zeros((T, 19, 3))
    R = np.zeros((T, 19, 3, 3))
    for j in range(19):
        par = int(sk.PARENT[j])
        Rp = pelvis_R if par == -1 else R[:, par]
        pp = pelvis_p if par == -1 else p[:, par]
        p[:, j] = pp + np.einsum("tij,j->ti", Rp, sk.JOINT_OFFSET[j])
        if sk.IS_FIXED[j]:
            R[:, j] = Rp
        else:
            R[:, j] = Rp @ Rotation.from_rotvec(aa19[:, j]).as_matrix()
    return p, R


@dataclass
class ArmGeometry:
    side: str                   # "l" | "r"
    clav: int                   # char joint indices
    sho: int
    b1: np.ndarray              # (3,) upper-arm bone (shoulder frame)
    b2: np.ndarray              # (3,) elbow -> wrist-link pin point
    l1: float
    l2: float

    @property
    def reach(self) -> float:
        return self.l1 + self.l2


def arm_geometry():
    """Arm bone vectors (scale 1). The chain end is the WRIST LINK pin point
    (wrist joint + wrist inertial origin — the frame SBP labels and the
    wrist IMU live in, amass_skeleton.COM_OFFSET), so pinning the IK target
    pins exactly the point the label grid search watches; the wrist joint is
    fixed (welded), so b2 composes both offsets in the elbow frame."""
    from tip_tpu_torch.chars import amass_skeleton as sk

    def arm(side, clav, sho, elb, wri):
        b1 = sk.JOINT_OFFSET[elb].copy()
        b2 = sk.JOINT_OFFSET[wri] + sk.COM_OFFSET[wri + 1]
        return ArmGeometry(side=side, clav=clav, sho=sho, b1=b1, b2=b2,
                           l1=float(np.linalg.norm(b1)),
                           l2=float(np.linalg.norm(b2)))

    return (arm("l", _L_CLAV, _L_SHO, _L_ELB, _L_WRI),
            arm("r", _R_CLAV, _R_SHO, _R_ELB, _R_WRI))


def solve_arm(geo: ArmGeometry, aa24, pelvis_p, pelvis_R, target_w, pole):
    """Two-bone arm IK against the full torso pose.

    The shoulder anchor (world shoulder-joint position + clavicle-chain
    orientation) comes from np_fk_chain of the authored pose, so torso
    lean/recline/pitch is accounted for exactly. Writes nothing: returns
    (shoulder_aa, elbow_aa), each (T, 3), to be stored at the SMPL
    shoulder/elbow slots.

    pole: (3,) elbow bend direction in the clavicle (≈ body) frame.
    """
    p_jf, R_w = np_fk_chain(aa24, pelvis_p, pelvis_R)
    base_p = p_jf[:, geo.sho]
    base_R = R_w[:, geo.clav]
    v = np.einsum("tji,tj->ti", base_R, target_w - base_p)
    _, _, sho_aa, elb_aa = solve_two_bone(geo.b1, geo.b2, v, pole)
    return sho_aa, elb_aa


def arm_pin_point(aa24, pelvis_p, pelvis_R, side: str):
    """World trajectory of an arm's wrist-link pin point under the authored
    pose — the point solve_arm pins (test/verification helper)."""
    from tip_tpu_torch.chars import amass_skeleton as sk
    geo = arm_geometry()[0 if side == "l" else 1]
    wri = _L_WRI if side == "l" else _R_WRI
    elb = _L_ELB if side == "l" else _R_ELB
    p_jf, R_w = np_fk_chain(aa24, pelvis_p, pelvis_R)
    off = sk.JOINT_OFFSET[wri] + sk.COM_OFFSET[wri + 1]
    return p_jf[:, elb] + np.einsum("tij,j->ti", R_w[:, elb], off)


def fit_target_to_reach(anchor_traj, target, reach, frac: float = 0.96):
    """Shrink a FIXED world target toward the anchor centroid until it stays
    within ``frac * reach`` of the anchor at every frame (bisection; the
    max-distance is monotone in the shrink factor). Keeps planted points
    truly world-stationary — clamping inside the IK would drag them."""
    target = np.asarray(target, np.float64)
    center = anchor_traj.mean(axis=0)

    def ok(s):
        pt = center + (target - center) * s
        return np.linalg.norm(pt - anchor_traj, axis=1).max() <= frac * reach

    if ok(1.0):
        return target
    lo, hi = 0.0, 1.0
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if ok(mid) else (lo, mid)
    return center + (target - center) * lo


# ---------------------------------------------------------------------------
# ground profiles (functions of path arclength)
# ---------------------------------------------------------------------------

def ground_profile(kind: str, rng) -> Callable[[np.ndarray], np.ndarray]:
    if kind == "flat":
        return lambda s: np.zeros_like(s)
    if kind == "ramp":
        slope = rng.uniform(0.06, 0.2) * rng.choice([-1.0, 1.0])
        return lambda s: slope * s
    if kind == "stairs":
        rise = rng.uniform(0.10, 0.17) * rng.choice([-1.0, 1.0])
        run = rng.uniform(0.30, 0.45)
        return lambda s: rise * np.floor(s / run)
    if kind == "bumps":
        n = rng.integers(2, 5)
        c = rng.uniform(0.5, 8.0, n)
        h = rng.uniform(-0.25, 0.25, n)
        w = rng.uniform(0.4, 1.2, n)
        return lambda s: np.sum(
            h * np.exp(-((s[..., None] - c) / w) ** 2), axis=-1)
    raise ValueError(kind)


def _smoothstep(x):
    x = np.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def _hold_envelope(t, t0, t1, ramp):
    """0 -> 1 over [t0, t0+ramp], EXACTLY 1 through [t0+ramp, t1-ramp],
    -> 0 over [t1-ramp, t1]. The exact-1 plateau is what makes planted
    points truly world-stationary during a hold."""
    up = _smoothstep((t - t0) / ramp)
    down = _smoothstep((t1 - t) / ramp)
    return np.minimum(up, down)


def _yaw(psi):
    """(T,) -> (T, 3, 3) world yaw rotations."""
    return Rotation.from_euler("z", np.reshape(psi, (-1, 1))).as_matrix()


# ---------------------------------------------------------------------------
# upper body
# ---------------------------------------------------------------------------

def _upper_body_walk(T, t, fs, rng, arm_amp=None):
    """(T, 24, 3) with arms lowered + counter-swinging, breathing spine."""
    aa = np.zeros((T, 24, 3))
    arm_amp = rng.uniform(0.15, 0.45) if arm_amp is None else arm_amp
    swing = arm_amp * np.sin(2 * np.pi * fs * t)
    drop = rng.uniform(1.1, 1.35)
    elbow = rng.uniform(0.15, 0.5)
    J = cst.SMPL_JOINT_IDX
    # left arm forward when the right leg leads (counter-phase)
    aa[:, J["lshoulder"]] = (
        Rotation.from_euler("xz", np.stack([swing, np.full(T, -drop)], 1))
        .as_rotvec())
    aa[:, J["rshoulder"]] = (
        Rotation.from_euler("xz", np.stack([-swing, np.full(T, drop)], 1))
        .as_rotvec())
    aa[:, J["lelbow"], 1] = -elbow + 0.1 * swing
    aa[:, J["relbow"], 1] = elbow - 0.1 * swing
    # spine counter-yaw + slight forward lean; head steady with micro-motion
    yaw_amp = rng.uniform(0.03, 0.1)
    aa[:, J["lowerback"], 1] = -yaw_amp * np.sin(2 * np.pi * fs * t)
    aa[:, J["lowerback"], 0] = rng.uniform(0.0, 0.1)
    aa[:, J["upperback"], 1] = 0.5 * yaw_amp * np.sin(2 * np.pi * fs * t)
    aa[:, J["upperneck"], 0] = 0.03 * np.sin(2 * np.pi * 0.3 * t)
    return aa


def _reach_envelope(T, t, rng, n_events):
    """Sum of smooth bumps in [0, 1] marking reach/raise events."""
    env = np.zeros(T)
    for _ in range(n_events):
        c = rng.uniform(t[0] + 1.0, t[-1] - 1.0)
        w = rng.uniform(0.6, 1.5)
        env += np.exp(-((t - c) / w) ** 2)
    return np.clip(env, 0.0, 1.0)


# ---------------------------------------------------------------------------
# motion families
# ---------------------------------------------------------------------------

def _assemble(T, pelvis_p, pelvis_R, ankle_l, ankle_r, foot_R_l, foot_R_r,
              upper_aa):
    """Run both-leg IK and pack an SmplMotion."""
    geo_l, geo_r = leg_geometry()
    J = cst.SMPL_JOINT_IDX
    aa = upper_aa.copy()
    for geo, ankle, foot_R, names in (
            (geo_l, ankle_l, foot_R_l, ("lhip", "lknee", "lankle")),
            (geo_r, ankle_r, foot_R_r, ("rhip", "rknee", "rankle"))):
        hip_aa, knee_aa, ankle_aa = solve_leg(geo, pelvis_p, pelvis_R,
                                              ankle, foot_R)
        aa[:, J[names[0]]] = hip_aa
        aa[:, J[names[1]]] = knee_aa
        aa[:, J[names[2]]] = ankle_aa
    aa[:, 0] = Rotation.from_matrix(pelvis_R).as_rotvec()
    return smpl.SmplMotion(poses=aa, trans=pelvis_p.copy(), fps=FPS)


def make_walk(rng, duration_s: float = 12.0, terrain: str = "flat"):
    """Footstep-planned walk with turning, speed changes, and a ground
    profile; stance feet are pinned world-stationary via leg IK."""
    T = int(duration_s * FPS)
    t = np.arange(T) / FPS
    geo_l, _ = leg_geometry()
    leg_drop = -(geo_l.hip_off[1] + geo_l.b1[1] + geo_l.b2[1])  # ~0.87

    # --- path: piecewise-smooth speed and turn rate -----------------------
    n_seg = max(2, int(duration_s / 3.0))
    seg_t = np.linspace(0, duration_s, n_seg + 1)
    seg_speed = rng.uniform(0.35, 1.35, n_seg)
    seg_turn = rng.choice([0.0, 1.0], n_seg, p=[0.45, 0.55]) * \
        rng.uniform(-0.8, 0.8, n_seg)
    idx = np.clip(np.searchsorted(seg_t, t, "right") - 1, 0, n_seg - 1)
    # smooth with a 0.5 s moving average so accelerations stay human
    k = int(0.5 * FPS)
    kern = np.ones(k) / k
    speed = np.convolve(np.pad(seg_speed[idx], (k, k), mode="edge"),
                        kern, "same")[k:-k]
    turn = np.convolve(np.pad(seg_turn[idx], (k, k), mode="edge"),
                       kern, "same")[k:-k]
    psi = np.cumsum(turn) / FPS
    vel = speed[:, None] * np.stack([np.cos(psi), np.sin(psi)], 1)
    path = np.cumsum(vel, axis=0) / FPS                    # (T, 2)
    arclen = np.cumsum(speed) / FPS
    ground = ground_profile(terrain, rng)

    # --- footstep plan ----------------------------------------------------
    fs = rng.uniform(0.8, 1.2)                             # gait cycles/s
    duty = rng.uniform(0.56, 0.62)
    P = 1.0 / fs
    half_w = rng.uniform(0.07, 0.11)

    def interp(arr, tt):
        return np.interp(tt, t, arr)

    def plan_foot(phase, sign):
        """Strike times + placements for one foot; returns per-frame ankle
        targets (T, 3) and per-frame foot yaw (T,)."""
        strikes = np.arange(phase, duration_s + 2 * P, P)
        px = interp(path[:, 0], strikes)
        py = interp(path[:, 1], strikes)
        ps = interp(arclen, strikes)
        ppsi = interp(psi, strikes)
        lat = np.stack([-np.sin(ppsi), np.cos(ppsi)], 1) * sign * half_w
        place = np.stack([px, py], 1) + lat                # (K, 2)
        pz = ground(ps) + ANKLE_REST_H

        ankle = np.zeros((T, 3))
        fyaw = np.zeros(T)
        clearance = rng.uniform(0.04, 0.1)
        for k_ in range(len(strikes) - 1):
            t0, t1 = strikes[k_], strikes[k_ + 1]
            lift = t0 + duty * P
            m_st = (t >= t0 - 1e-9) & (t < lift)
            m_sw = (t >= lift) & (t < t1)
            ankle[m_st, :2] = place[k_]
            ankle[m_st, 2] = pz[k_]
            fyaw[m_st] = ppsi[k_]
            if m_sw.any():
                s = (t[m_sw] - lift) / max(t1 - lift, 1e-6)
                h = _smoothstep(s)[:, None]
                ankle[m_sw, :2] = (1 - h) * place[k_] + h * place[k_ + 1]
                ankle[m_sw, 2] = ((1 - h[:, 0]) * pz[k_] + h[:, 0] * pz[k_ + 1]
                                  + clearance * np.sin(np.pi * s))
                fyaw[m_sw] = (1 - s) * ppsi[k_] + s * ppsi[k_ + 1]
        m_pre = t < strikes[0]
        ankle[m_pre, :2] = place[0]
        ankle[m_pre, 2] = pz[0]
        fyaw[m_pre] = ppsi[0]
        return ankle, fyaw

    ankle_l, yaw_l = plan_foot(0.0, +1.0)
    ankle_r, yaw_r = plan_foot(P / 2.0, -1.0)

    # --- pelvis -----------------------------------------------------------
    crouch = rng.uniform(0.95, 0.985)
    bob = rng.uniform(0.01, 0.03)
    sway = rng.uniform(0.015, 0.035)
    g_smooth = np.convolve(np.pad(0.5 * (ankle_l[:, 2] + ankle_r[:, 2]),
                                  (k, k), mode="edge"), kern, "same")[k:-k]
    left_dir = np.stack([-np.sin(psi), np.cos(psi)], 1)
    pel_xy = (path + sway * np.sin(2 * np.pi * fs * t + np.pi / 2)[:, None]
              * left_dir)
    pel_z = (g_smooth + crouch * leg_drop
             + bob * np.sin(4 * np.pi * fs * t))
    # reachability cap: the pelvis must stay low enough that both stance
    # ankles remain inside leg reach (otherwise the IK clamp drags the
    # planted foot — kinematic foot slide). The natural consequence is the
    # inverted-pendulum dip at long strides.
    reach = 0.99 * (geo_l.l1 + geo_l.l2)
    hip_drop = -geo_l.hip_off[1]                 # hip below root when upright
    for ank in (ankle_l, ankle_r):
        horiz2 = np.sum((pel_xy - ank[:, :2]) ** 2, axis=1)
        cap = ank[:, 2] + hip_drop + np.sqrt(
            np.maximum(reach ** 2 - horiz2, 0.35 ** 2))
        pel_z = np.minimum(pel_z, cap)
    pel_z = np.convolve(np.pad(pel_z, (k, k), mode="edge"),
                        kern, "same")[k:-k] - 0.01
    pelvis_p = np.concatenate([pel_xy, pel_z[:, None]], 1)

    roll = rng.uniform(0.01, 0.04) * np.sin(2 * np.pi * fs * t)
    pitch = rng.uniform(0.0, 0.06)
    pelvis_R = (_yaw(psi)
                @ Rotation.from_euler("xy", np.stack(
                    [roll, np.full(T, pitch)], 1)).as_matrix()
                @ _R_ZUP.as_matrix())

    foot_R_l = _yaw(yaw_l) @ _R_ZUP.as_matrix()
    foot_R_r = _yaw(yaw_r) @ _R_ZUP.as_matrix()

    upper = _upper_body_walk(T, t, fs, rng)
    return _assemble(T, pelvis_p, pelvis_R, ankle_l, ankle_r,
                     foot_R_l, foot_R_r, upper)


def make_idle(rng, duration_s: float = 10.0):
    """Stand with weight shifts, torso/head motion, and arm reaches; feet
    planted (strong SBP signal at zero root velocity)."""
    T = int(duration_s * FPS)
    t = np.arange(T) / FPS
    geo_l, _ = leg_geometry()
    leg_drop = -(geo_l.hip_off[1] + geo_l.b1[1] + geo_l.b2[1])

    stance_w = rng.uniform(0.09, 0.16)
    yaw0 = rng.uniform(-np.pi, np.pi)
    left = np.array([-np.sin(yaw0), np.cos(yaw0)])
    c = rng.uniform(-1.0, 1.0, 2)
    ankle_l = np.tile(np.r_[c + stance_w * left, ANKLE_REST_H], (T, 1))
    ankle_r = np.tile(np.r_[c - stance_w * left, ANKLE_REST_H], (T, 1))

    # slow weight shift + bob; small pelvis yaw wander
    f1, f2 = rng.uniform(0.15, 0.45, 2)
    shift = rng.uniform(0.02, 0.06) * np.sin(2 * np.pi * f1 * t)
    dip = rng.uniform(0.0, 0.08) * (0.5 - 0.5 * np.cos(2 * np.pi * f2 * t))
    pel_xy = c + shift[:, None] * left
    pel_z = rng.uniform(0.94, 0.975) * leg_drop + ANKLE_REST_H - dip
    pelvis_p = np.concatenate([pel_xy, np.broadcast_to(
        pel_z[:, None] if np.ndim(pel_z) else np.full((T, 1), pel_z),
        (T, 1))], 1)
    yaw_osc = rng.uniform(0.0, 0.15) * np.sin(2 * np.pi * 0.2 * t)
    pelvis_R = _yaw(yaw0 + yaw_osc) @ _R_ZUP.as_matrix()
    foot_R = np.tile(_yaw(np.array([yaw0]))[0] @ _R_ZUP.as_matrix(),
                     (T, 1, 1))

    aa = np.zeros((T, 24, 3))
    J = cst.SMPL_JOINT_IDX
    drop = rng.uniform(1.15, 1.35)
    aa[:, J["lshoulder"], 2] = -drop
    aa[:, J["rshoulder"], 2] = drop
    # reaches: raise an arm along a random rotvec during each event
    for side, sgn in (("l", -1.0), ("r", 1.0)):
        env = _reach_envelope(T, t, rng, rng.integers(1, 4))
        ax = _unit(rng.normal(size=3))
        amp = rng.uniform(0.6, 1.4)
        base = aa[:, J[side + "shoulder"]]
        r = (Rotation.from_rotvec(np.outer(env * amp, ax))
             * Rotation.from_rotvec(base))
        aa[:, J[side + "shoulder"]] = r.as_rotvec()
        aa[:, J[side + "elbow"], 1] = sgn * rng.uniform(0.1, 0.6) * env
    aa[:, J["upperneck"]] = np.outer(
        0.15 * np.sin(2 * np.pi * rng.uniform(0.1, 0.3) * t),
        _unit(rng.normal(size=3)))
    aa[:, J["lowerback"], 0] = 0.05 * np.sin(2 * np.pi * f1 * t)

    return _assemble(T, pelvis_p, pelvis_R, ankle_l, ankle_r,
                     foot_R, foot_R, aa)


def make_squat(rng, duration_s: float = 9.0):
    """Repeated squats: feet planted, pelvis dips, arms raise forward."""
    T = int(duration_s * FPS)
    t = np.arange(T) / FPS
    geo_l, _ = leg_geometry()
    leg_drop = -(geo_l.hip_off[1] + geo_l.b1[1] + geo_l.b2[1])

    yaw0 = rng.uniform(-np.pi, np.pi)
    left = np.array([-np.sin(yaw0), np.cos(yaw0)])
    stance_w = rng.uniform(0.12, 0.18)
    ankle_l = np.tile(np.r_[stance_w * left, ANKLE_REST_H], (T, 1))
    ankle_r = np.tile(np.r_[-stance_w * left, ANKLE_REST_H], (T, 1))

    f = rng.uniform(0.2, 0.4)
    depth = rng.uniform(0.22, 0.42)
    dip = depth * 0.5 * (1 - np.cos(2 * np.pi * f * t))
    pel_z = 0.975 * leg_drop + ANKLE_REST_H - dip
    # hips shift slightly back while dipping
    back = np.stack([np.cos(yaw0), np.sin(yaw0)]) * (-0.25)
    pel_xy = np.outer(dip, back)
    pelvis_p = np.concatenate([pel_xy, pel_z[:, None]], 1)
    lean = 0.35 * dip / depth
    pelvis_R = (_yaw(np.full(T, yaw0))
                @ Rotation.from_euler("x", lean[:, None]).as_matrix()
                @ _R_ZUP.as_matrix())
    foot_R = np.tile(_yaw(np.array([yaw0]))[0] @ _R_ZUP.as_matrix(),
                     (T, 1, 1))

    aa = np.zeros((T, 24, 3))
    J = cst.SMPL_JOINT_IDX
    raise_amt = (dip / depth) * rng.uniform(0.8, 1.3)
    aa[:, J["lshoulder"]] = Rotation.from_euler("xz", np.stack(
        [raise_amt, -1.25 + 1.1 * raise_amt], 1)).as_rotvec()
    aa[:, J["rshoulder"]] = Rotation.from_euler("xz", np.stack(
        [raise_amt, 1.25 - 1.1 * raise_amt], 1)).as_rotvec()
    aa[:, J["lowerback"], 0] = -0.5 * lean     # spine counter-lean

    return _assemble(T, pelvis_p, pelvis_R, ankle_l, ankle_r,
                     foot_R, foot_R, aa)


def make_dance(rng, duration_s: float = 9.0):
    """Step-dance: feet do planned step-touch patterns around a spot with
    irregular timing (frequent short contacts at varied heights of the
    bumps profile), pelvis bounces and spins, big arm/torso swing fields.
    Fills the contact-statistics gap between gait (long stances) and
    freeform (no contacts)."""
    T = int(duration_s * FPS)
    t = np.arange(T) / FPS
    geo_l, _ = leg_geometry()
    leg_drop = -(geo_l.hip_off[1] + geo_l.b1[1] + geo_l.b2[1])

    center = rng.uniform(-1.0, 1.0, 2)
    spin = rng.uniform(-0.6, 0.6)
    psi = spin * t + rng.uniform(0.0, 0.25) * np.sin(
        2 * np.pi * rng.uniform(0.3, 0.8) * t)

    def plan_foot(sign, phase0):
        """Irregular step-touch sequence: randomized per-step period/duty,
        placements in an annulus around the center."""
        ankle = np.zeros((T, 3))
        fyaw = np.zeros(T)
        t0 = phase0
        prev = center + np.array([0.0, sign * 0.12])
        prev_z = ANKLE_REST_H
        yaw_prev = float(psi[0])
        ankle[:, :2] = prev
        ankle[:, 2] = prev_z
        fyaw[:] = yaw_prev
        while t0 < duration_s:
            period = rng.uniform(0.5, 1.1)
            duty = rng.uniform(0.45, 0.7)
            ang = rng.uniform(0, 2 * np.pi)
            r = rng.uniform(0.05, 0.3)
            place = center + r * np.array([np.cos(ang), np.sin(ang)]) \
                + np.array([0.0, sign * rng.uniform(0.08, 0.14)])
            pz = ANKLE_REST_H
            lift = t0 + duty * period
            t1 = t0 + period
            # foot yaw follows the body spin but only re-aims DURING swing
            # (held through stance, smoothly interpolated in flight — a
            # step change here becomes a one-frame gyro spike in the
            # synthesized ankle IMUs)
            yaw_new = float(np.interp(min(t1, duration_s - 1e-6), t, psi))
            m_st = (t >= t0) & (t < lift)
            m_sw = (t >= lift) & (t < t1)
            ankle[m_st, :2] = prev
            ankle[m_st, 2] = prev_z
            fyaw[m_st] = yaw_prev
            if m_sw.any():
                s = (t[m_sw] - lift) / max(t1 - lift, 1e-6)
                h = _smoothstep(s)[:, None]
                ankle[m_sw, :2] = (1 - h) * prev + h * place
                ankle[m_sw, 2] = (prev_z + (pz - prev_z) * h[:, 0]
                                  + rng.uniform(0.03, 0.12)
                                  * np.sin(np.pi * s))
                fyaw[m_sw] = yaw_prev + (yaw_new - yaw_prev) * _smoothstep(s)
            m_after = t >= t1
            ankle[m_after, :2] = place
            ankle[m_after, 2] = pz
            fyaw[m_after] = yaw_new
            prev, prev_z, t0, yaw_prev = place, pz, t1, yaw_new
        return ankle, fyaw

    ankle_l, yaw_l = plan_foot(+1.0, 0.0)
    ankle_r, yaw_r = plan_foot(-1.0, rng.uniform(0.2, 0.6))

    tempo = rng.uniform(0.8, 2.0)
    bounce = rng.uniform(0.03, 0.1)
    pel_xy = (0.5 * (ankle_l[:, :2] + ankle_r[:, :2])
              + rng.uniform(0.0, 0.04)
              * np.sin(2 * np.pi * tempo * t)[:, None]
              * np.stack([-np.sin(psi), np.cos(psi)], 1))
    k = int(0.3 * FPS)
    kern = np.ones(k) / k
    pel_xy = np.stack([np.convolve(np.pad(pel_xy[:, i], (k, k), mode="edge"),
                                   kern, "same")[k:-k] for i in range(2)], 1)
    pel_z = (rng.uniform(0.93, 0.97) * leg_drop + ANKLE_REST_H
             - bounce * 0.5 * (1 - np.cos(2 * np.pi * tempo * t)))
    pelvis_p = np.concatenate([pel_xy, pel_z[:, None]], 1)
    roll = rng.uniform(0.0, 0.08) * np.sin(2 * np.pi * tempo * t)
    pelvis_R = (_yaw(psi)
                @ Rotation.from_euler("xy", np.stack(
                    [roll, np.full(T, rng.uniform(0.0, 0.08))], 1)).as_matrix()
                @ _R_ZUP.as_matrix())
    foot_R_l = _yaw(yaw_l) @ _R_ZUP.as_matrix()
    foot_R_r = _yaw(yaw_r) @ _R_ZUP.as_matrix()

    upper = _upper_body_walk(T, t, tempo, rng,
                             arm_amp=rng.uniform(0.4, 0.8))
    J = cst.SMPL_JOINT_IDX
    for j in ("lowerback", "chest", "upperneck"):
        ax = _unit(rng.normal(size=3))
        upper[:, J[j]] += np.outer(
            rng.uniform(0.05, 0.25)
            * np.sin(2 * np.pi * rng.uniform(0.3, 1.0) * t
                     + rng.uniform(0, 2 * np.pi)), ax)
    return _assemble(T, pelvis_p, pelvis_R, ankle_l, ankle_r,
                     foot_R_l, foot_R_r, upper)


def make_freeform(rng, duration_s: float = 8.0):
    """Random multi-joint swing field (the e2e demo family): keeps the
    corpus from collapsing onto gait statistics; mostly airborne feet."""
    T = int(duration_s * FPS)
    t = np.arange(T) / FPS
    poses = np.zeros((T, 24, 3))
    poses[:, 0] = _R_ZUP.as_rotvec()
    for j in (1, 2, 4, 5, 7, 8, 3, 6, 9, 12, 15, 16, 17, 18, 19):
        amp = rng.uniform(0.05, 0.45)
        f = rng.uniform(0.3, 1.2)
        ph = rng.uniform(0, 2 * np.pi)
        ax = _unit(rng.normal(size=3))
        poses[:, j] = np.outer(amp * np.sin(2 * np.pi * f * t + ph), ax)
    trans = np.zeros((T, 3))
    trans[:, 2] = 0.95 + 0.03 * np.sin(2 * np.pi * 0.9 * t)
    trans[:, 0] = rng.uniform(-0.5, 0.5) * t
    trans[:, 1] = rng.uniform(-0.3, 0.3) * t
    return smpl.SmplMotion(poses=poses, trans=trans, fps=FPS)


def make_freeform2(rng, duration_s: float = 10.0):
    """Enriched free-form family (corpus v3 TRAINING supplement; opt-in via
    ``generate_corpus(families=...)`` — never in the default mix, so v2
    corpora keep regenerating bit-identically from seeds).

    Motivation: the flagship's quality tail concentrates on `freeform`
    (RESULTS.md round 4: 7.9 deg family mean vs 2.29 deg overall) and the
    v2 generator gives each joint ONE fixed (amp, freq, axis) sinusoid for
    the whole clip — a thin slice of the contact-free pose space per clip.
    This generator widens training *coverage* of the same regime (the
    TODO.md lever: "wider upper-body fields, faster re-seeding"):

      * the clip is split into 2-4 s segments, each with a fresh random
        field, crossfaded through a smoothstep partition of unity (~0.5 s),
        so one clip visits several field draws;
      * two harmonics per joint and a wider amplitude range;
      * slow root yaw precession + tilt oscillation (v2 freeform roots
        never rotate, so the root-IMU statistics of the family were a
        single point);
      * per-segment constant-velocity translation with turns (v2 draws one
        velocity for the whole clip).

    The v2 held-out freeform clips remain inside this distribution's span
    (one segment, single harmonic, zero yaw rate / tilt), so adding the
    family is coverage of the eval regime, not a distribution swap.
    """
    T = int(duration_s * FPS)
    t = np.arange(T) / FPS
    joints = (1, 2, 4, 5, 7, 8, 3, 6, 9, 12, 15, 16, 17, 18, 19)

    # segment boundaries: 2-4 s each, final segment whatever remains (<=4 s;
    # a sliver-short final segment is harmless — the partition of unity
    # below stays smooth and normalized regardless of segment length)
    bounds = [0.0]
    while duration_s - bounds[-1] > 4.0:
        bounds.append(bounds[-1] + float(rng.uniform(2.0, 4.0)))
    bounds.append(duration_s)
    n_seg = len(bounds) - 1

    def draw_segment():
        field = {}
        for j in joints:
            field[j] = [(float(rng.uniform(0.05, 0.55)),
                         float(rng.uniform(0.2, 1.5)),
                         float(rng.uniform(0, 2 * np.pi)),
                         _unit(rng.normal(size=3))),
                        (float(rng.uniform(0.02, 0.25)),
                         float(rng.uniform(0.2, 1.5)),
                         float(rng.uniform(0, 2 * np.pi)),
                         _unit(rng.normal(size=3)))]
        return dict(
            field=field,
            vel=rng.uniform(-0.6, 0.6, size=2),
            bob=(float(rng.uniform(0.01, 0.05)),
                 float(rng.uniform(0.4, 1.4)),
                 float(rng.uniform(0, 2 * np.pi))),
            yaw_rate=float(rng.uniform(-0.5, 0.5)),
            tilt=(float(rng.uniform(0.0, 0.15)),
                  float(rng.uniform(0.2, 0.8)),
                  float(rng.uniform(0, 2 * np.pi)),
                  _unit(np.r_[rng.normal(size=2), 0.0])))

    segs = [draw_segment() for _ in range(n_seg)]

    # partition of unity over segments: w_k = s_k - s_{k+1} with smoothstep
    # transitions of width `c` centred on each interior boundary
    c = 0.5
    S = [np.ones(T)]
    for b in bounds[1:-1]:
        S.append(_smoothstep((t - (b - c / 2)) / c))
    S.append(np.zeros(T))
    W = [S[k] - S[k + 1] for k in range(n_seg)]

    poses = np.zeros((T, 24, 3))
    for j in joints:
        acc = np.zeros((T, 3))
        for w, seg in zip(W, segs):
            for amp, f, ph, ax in seg["field"][j]:
                acc += np.outer(
                    w * amp * np.sin(2 * np.pi * f * t + ph), ax)
        poses[:, j] = acc

    # root: blended yaw rate integrated to a heading, small tilt about a
    # horizontal axis, composed onto the z-up frame like make_dance's pelvis
    yaw_rate = np.zeros(T)
    tilt_vec = np.zeros((T, 3))
    for w, seg in zip(W, segs):
        yaw_rate += w * seg["yaw_rate"]
        amp, f, ph, ax = seg["tilt"]
        tilt_vec += np.outer(w * amp * np.sin(2 * np.pi * f * t + ph), ax)
    psi = np.cumsum(yaw_rate) / FPS
    r_root = (Rotation.from_euler("z", psi[:, None])
              * Rotation.from_rotvec(tilt_vec) * _R_ZUP)
    poses[:, 0] = r_root.as_rotvec()

    # translation: blended per-segment velocity integrated (turns at the
    # crossfades), z bobbing around the v2 baseline height
    vel = np.zeros((T, 2))
    bob = np.zeros(T)
    for w, seg in zip(W, segs):
        vel += w[:, None] * seg["vel"][None]
        amp, f, ph = seg["bob"]
        bob += w * amp * np.sin(2 * np.pi * f * t + ph)
    trans = np.zeros((T, 3))
    trans[:, :2] = np.cumsum(vel, axis=0) / FPS
    trans[:, 2] = 0.95 + bob
    return smpl.SmplMotion(poses=poses, trans=trans, fps=FPS)


# opt-in families: selectable via generate_corpus(families=...), NEVER part
# of the default mix (adding a row to _FAMILIES would change the
# (seed, i) -> family draw stream and break bit-identical regeneration of
# the v2/LOFO corpora after host moves)
_EXTRA_FAMILIES = (
    ("freeform2", 1.0, lambda rng: dict()),
)


# ---------------------------------------------------------------------------
# contact-rich families (wrist/pelvis SBP positive labels — VERDICT r3 #4:
# the 5-SBP surface trains all five channels only if the corpus contains
# sit/support motions like the reference's AMASS data does; reference grids
# for wrists and pelvis at data_utils.py:60-74)
# ---------------------------------------------------------------------------


def _arm_drop_aa(T, rng):
    """(T, 24, 3) base upper body: arms lowered to the sides."""
    aa = np.zeros((T, 24, 3))
    J = cst.SMPL_JOINT_IDX
    drop = rng.uniform(1.15, 1.35)
    aa[:, J["lshoulder"], 2] = -drop
    aa[:, J["rshoulder"], 2] = drop
    return aa


def make_sit(rng, duration_s: float = 10.0):
    """Sit-down / stand-up on a box: the pelvis descends onto a seat at a
    random height and is world-stationary through the hold — the PELVIS SBP
    channel's positive-label family (grid: data_utils.py:66-68). Feet stay
    planted (foot SBPs active throughout); torso/arms move while seated."""
    T = int(duration_s * FPS)
    t = np.arange(T) / FPS
    geo_l, _ = leg_geometry()
    leg_drop = -(geo_l.hip_off[1] + geo_l.b1[1] + geo_l.b2[1])

    h_seat = rng.uniform(0.25, 0.55)
    yaw0 = rng.uniform(-np.pi, np.pi)
    fwd = np.array([np.cos(yaw0), np.sin(yaw0)])
    left = np.array([-np.sin(yaw0), np.cos(yaw0)])
    seat_xy = rng.uniform(-1.0, 1.0, 2)
    foot_dist = rng.uniform(0.30, 0.42)
    stance_w = rng.uniform(0.10, 0.16)
    feet_center = seat_xy + fwd * foot_dist
    ankle_l = np.tile(np.r_[feet_center + stance_w * left, ANKLE_REST_H],
                      (T, 1))
    ankle_r = np.tile(np.r_[feet_center - stance_w * left, ANKLE_REST_H],
                      (T, 1))

    stand_z = rng.uniform(0.94, 0.97) * leg_drop + ANKLE_REST_H
    seat_z = h_seat + rng.uniform(0.06, 0.10)
    sit_start = rng.uniform(1.0, 1.8)
    rise_end = duration_s - rng.uniform(1.0, 1.8)
    ramp = rng.uniform(0.8, 1.2)
    e = _hold_envelope(t, sit_start, rise_end, ramp)

    # natural weight-shift sway while standing (gated out during the hold so
    # the seated pelvis stays exactly stationary). Depending on the drawn
    # amplitude/frequency the standing pelvis velocity straddles V_THRES, so
    # across the family the pelvis channel sees both quiet-stand positives
    # (reference-faithful: a still pelvis labels, data_utils.py:27-100) and
    # sway-suppressed negatives.
    sway = (rng.uniform(0.015, 0.06)
            * np.sin(2 * np.pi * rng.uniform(0.2, 0.55) * t
                     + rng.uniform(0, 2 * np.pi)))
    pel_xy = (feet_center + (seat_xy - feet_center)[None] * e[:, None]
              + ((1.0 - e) * sway)[:, None] * fwd
              + ((1.0 - e) * 0.4 * np.roll(sway, int(0.3 * FPS)))[:, None]
              * left)
    pel_z = stand_z + (seat_z - stand_z) * e
    # reachability cap (same construction as make_walk): both planted
    # ankles must stay inside leg reach or the IK clamp would drag them
    reach = 0.99 * (geo_l.l1 + geo_l.l2)
    hip_drop = -geo_l.hip_off[1]
    for ank in (ankle_l, ankle_r):
        horiz2 = np.sum((pel_xy - ank[:, :2]) ** 2, axis=1)
        cap = ank[:, 2] + hip_drop + np.sqrt(
            np.maximum(reach ** 2 - horiz2, 0.2 ** 2))
        pel_z = np.minimum(pel_z, cap)
    pelvis_p = np.concatenate([pel_xy, pel_z[:, None]], 1)
    # root orientation constant: while seated the root (and its
    # ROOT_COM_OFFSET point the pelvis SBP watches) is fully stationary;
    # all expressive motion rides on spine/arm joints
    pelvis_R = np.tile(_yaw(np.array([yaw0]))[0] @ _R_ZUP.as_matrix(),
                      (T, 1, 1))
    foot_R = pelvis_R

    aa = _arm_drop_aa(T, rng)
    J = cst.SMPL_JOINT_IDX
    # lean forward through the transitions (sit-to-stand mechanics), slight
    # recline + torso micro-sway while seated
    trans = 4.0 * e * (1.0 - e)
    aa[:, J["lowerback"], 0] = (0.45 * rng.uniform(0.7, 1.3) * trans
                                - 0.08 * e
                                + 0.04 * np.sin(2 * np.pi *
                                                rng.uniform(0.15, 0.35) * t))
    aa[:, J["upperback"], 0] = 0.2 * trans
    aa[:, J["upperneck"]] = np.outer(
        0.12 * np.sin(2 * np.pi * rng.uniform(0.1, 0.3) * t),
        _unit(rng.normal(size=3)))
    # seated arm reaches (gated by e so the hold stays expressive)
    for side, sgn in (("l", -1.0), ("r", 1.0)):
        env = _reach_envelope(T, t, rng, rng.integers(1, 3)) * e
        ax = _unit(rng.normal(size=3))
        base = aa[:, J[side + "shoulder"]]
        r = (Rotation.from_rotvec(np.outer(env * rng.uniform(0.5, 1.2), ax))
             * Rotation.from_rotvec(base))
        aa[:, J[side + "shoulder"]] = r.as_rotvec()
        aa[:, J[side + "elbow"], 1] = sgn * rng.uniform(0.1, 0.5) * env

    return _assemble(T, pelvis_p, pelvis_R, ankle_l, ankle_r,
                     foot_R, foot_R, aa)


def make_floorsit(rng, duration_s: float = 10.0):
    """Floor sit with hand support: reclined pelvis near the ground, legs
    extended, both palms planted on the floor behind the hips — the WRIST
    SBP channels' ground-contact family (grid: data_utils.py:60-62).
    Occasional leg lifts and hand re-plants vary the contact on/off
    statistics; the pelvis is near-stationary (slow recline rocking only)."""
    T = int(duration_s * FPS)
    t = np.arange(T) / FPS
    yaw0 = rng.uniform(-np.pi, np.pi)
    fwd = np.array([np.cos(yaw0), np.sin(yaw0)])
    left = np.array([-np.sin(yaw0), np.cos(yaw0)])
    c = rng.uniform(-1.0, 1.0, 2)

    z_root = rng.uniform(0.10, 0.14)
    pelvis_p = np.tile(np.r_[c, z_root], (T, 1))
    theta0 = rng.uniform(0.32, 0.50)          # recline angle
    th_amp = rng.uniform(0.02, 0.07)
    th_f = rng.uniform(0.10, 0.28)
    theta = theta0 + th_amp * np.sin(2 * np.pi * th_f * t
                                     + rng.uniform(0, 2 * np.pi))
    pelvis_R = (_yaw(np.full(T, yaw0))
                @ Rotation.from_euler("y", -theta[:, None]).as_matrix()
                @ _R_ZUP.as_matrix())

    # legs extended forward on the floor; one leg does 0-2 lift events
    fwd_d = rng.uniform(0.52, 0.66)
    lat = rng.uniform(0.10, 0.17)
    ankle_l = np.tile(np.r_[c + fwd * fwd_d + left * lat, ANKLE_REST_H],
                      (T, 1))
    ankle_r = np.tile(np.r_[c + fwd * fwd_d - left * lat, ANKLE_REST_H],
                      (T, 1))
    lift_leg = rng.choice([None, "l", "r"], p=[0.3, 0.35, 0.35])
    if lift_leg is not None:
        env = _reach_envelope(T, t, rng, rng.integers(1, 3))
        ank = ankle_l if lift_leg == "l" else ankle_r
        ank[:, 2] += 0.14 * env
        ank[:, :2] += np.outer(0.08 * env, fwd)
    foot_R = (_yaw(np.full(T, yaw0))
              @ Rotation.from_euler(
                  "y", -np.full((T, 1), 0.5 * theta0)).as_matrix()
              @ _R_ZUP.as_matrix())

    aa = _arm_drop_aa(T, rng)
    J = cst.SMPL_JOINT_IDX
    aa[:, J["lowerback"], 0] = 0.5 * (theta - theta0) + rng.uniform(0.0, 0.15)
    aa[:, J["upperneck"], 0] = -0.2 + 0.08 * np.sin(
        2 * np.pi * rng.uniform(0.1, 0.3) * t)

    # hands planted behind/outside the hips, pinned via arm IK
    geo_la, geo_ra = arm_geometry()
    p_jf, _ = np_fk_chain(aa, pelvis_p, pelvis_R)
    back_d = rng.uniform(0.12, 0.26)
    hand_lat = rng.uniform(0.28, 0.40)
    hand_z = rng.uniform(0.025, 0.05)
    lift_hand = rng.choice([None, "l", "r"], p=[0.4, 0.3, 0.3])
    for geo, sgn in ((geo_la, 1.0), (geo_ra, -1.0)):
        anchor = p_jf[:, geo.sho]
        target = np.r_[c - fwd * back_d + sgn * left * hand_lat, hand_z]
        target = fit_target_to_reach(anchor, target, geo.reach)
        tgt = np.tile(target, (T, 1))
        if lift_hand == geo.side:
            # one mid-motion lift: the hand leaves the floor, waves, and
            # re-plants at the SAME point (two separate contact episodes)
            ev = _hold_envelope(t, duration_s * 0.35, duration_s * 0.6, 0.5)
            free = anchor + np.r_[fwd * 0.25, -0.25][None, :]
            tgt = tgt + (free - tgt) * ev[:, None]
        pole = np.array([sgn * 1.0, 0.2, -0.4])
        sho_aa, elb_aa = solve_arm(geo, aa, pelvis_p, pelvis_R, tgt, pole)
        aa[:, J[geo.side + "shoulder"]] = sho_aa
        aa[:, J[geo.side + "elbow"]] = elb_aa

    return _assemble(T, pelvis_p, pelvis_R, ankle_l, ankle_r,
                     foot_R, foot_R, aa)


def make_crawl(rng, duration_s: float = 10.0):
    """Hands-and-knees crawl: torso pitched toward the ground, hands planted
    under the shoulders and ankles dragging behind the hips in a diagonal
    gait — alternating WRIST contacts with pelvis translation (the moving
    analog of the floor-sit holds) plus long foot stances."""
    T = int(duration_s * FPS)
    t = np.arange(T) / FPS

    # slow wandering path (same smoothing construction as make_walk)
    n_seg = max(2, int(duration_s / 3.0))
    seg_t = np.linspace(0, duration_s, n_seg + 1)
    seg_speed = rng.uniform(0.08, 0.30, n_seg)
    seg_turn = rng.choice([0.0, 1.0], n_seg, p=[0.5, 0.5]) * \
        rng.uniform(-0.35, 0.35, n_seg)
    idx = np.clip(np.searchsorted(seg_t, t, "right") - 1, 0, n_seg - 1)
    k = int(0.5 * FPS)
    kern = np.ones(k) / k
    speed = np.convolve(np.pad(seg_speed[idx], (k, k), mode="edge"),
                        kern, "same")[k:-k]
    turn = np.convolve(np.pad(seg_turn[idx], (k, k), mode="edge"),
                       kern, "same")[k:-k]
    psi = np.cumsum(turn) / FPS
    vel = speed[:, None] * np.stack([np.cos(psi), np.sin(psi)], 1)
    path = np.cumsum(vel, axis=0) / FPS

    pitch = rng.uniform(1.15, 1.40)
    z_root = rng.uniform(0.30, 0.35)
    P = rng.uniform(0.9, 1.2)
    duty = rng.uniform(0.65, 0.72)
    fs = 1.0 / P
    bob = rng.uniform(0.005, 0.015)
    pel_z = z_root + bob * np.sin(4 * np.pi * fs * t)
    pelvis_p = np.concatenate([path, pel_z[:, None]], 1)
    pitch_t = pitch + 0.03 * np.sin(2 * np.pi * fs * t)
    pelvis_R = (_yaw(psi)
                @ Rotation.from_euler("y", pitch_t[:, None]).as_matrix()
                @ _R_ZUP.as_matrix())

    aa = np.zeros((T, 24, 3))                 # arms come from IK below
    J = cst.SMPL_JOINT_IDX
    aa[:, J["upperneck"], 0] = -0.35 + 0.05 * np.sin(
        2 * np.pi * rng.uniform(0.1, 0.3) * t)
    aa[:, J["lowerneck"], 0] = -0.25

    # anchors (shoulders, hips) from the authored torso pose
    geo_la, geo_ra = arm_geometry()
    p_jf, _ = np_fk_chain(aa, pelvis_p, pelvis_R)

    def stride_plan(anchor_xy, phase, z_pt, clearance, jitter):
        """Contact placements at the anchor's mid-stance ground projection:
        strike k plants at anchor_xy(t_k + duty*P/2), holds until lift,
        swings to the next placement. Returns (T, 3) targets + (T,) yaw."""
        strikes = np.arange(phase, duration_s + 2 * P, P)
        mid = np.clip(strikes + duty * P / 2.0, 0.0, duration_s - 1e-6)
        px = np.interp(mid, t, anchor_xy[:, 0]) + rng.normal(0, jitter,
                                                             len(mid))
        py = np.interp(mid, t, anchor_xy[:, 1]) + rng.normal(0, jitter,
                                                             len(mid))
        ppsi = np.interp(strikes, t, psi)
        place = np.stack([px, py], 1)
        tgt = np.zeros((T, 3))
        fyaw = np.zeros(T)
        for k_ in range(len(strikes) - 1):
            t0, t1 = strikes[k_], strikes[k_ + 1]
            lift = t0 + duty * P
            m_st = (t >= t0 - 1e-9) & (t < lift)
            m_sw = (t >= lift) & (t < t1)
            tgt[m_st, :2] = place[k_]
            tgt[m_st, 2] = z_pt
            fyaw[m_st] = ppsi[k_]
            if m_sw.any():
                s = (t[m_sw] - lift) / max(t1 - lift, 1e-6)
                h = _smoothstep(s)[:, None]
                tgt[m_sw, :2] = (1 - h) * place[k_] + h * place[k_ + 1]
                tgt[m_sw, 2] = z_pt + clearance * np.sin(np.pi * s)
                fyaw[m_sw] = (1 - s) * ppsi[k_] + s * ppsi[k_ + 1]
        m_pre = t < strikes[0]
        tgt[m_pre, :2] = place[0]
        tgt[m_pre, 2] = z_pt
        fyaw[m_pre] = ppsi[0]
        return tgt, fyaw

    hip_l = p_jf[:, _LHIP, :2]
    hip_r = p_jf[:, _RHIP, :2]
    heading = np.stack([np.cos(psi), np.sin(psi)], 1)
    behind = rng.uniform(0.34, 0.44)
    ankle_z = 0.07
    hand_z = rng.uniform(0.035, 0.05)
    clear_f = rng.uniform(0.03, 0.07)
    clear_h = rng.uniform(0.03, 0.08)
    # diagonal pairs: left hand swings with the right ankle
    ankle_l, yaw_l = stride_plan(hip_l - heading * behind, 0.0,
                                 ankle_z, clear_f, 0.01)
    ankle_r, yaw_r = stride_plan(hip_r - heading * behind, P / 2.0,
                                 ankle_z, clear_f, 0.01)
    hand_l, _ = stride_plan(p_jf[:, geo_la.sho, :2], P / 2.0,
                            hand_z, clear_h, 0.015)
    hand_r, _ = stride_plan(p_jf[:, geo_ra.sho, :2], 0.0,
                            hand_z, clear_h, 0.015)

    for geo, tgt in ((geo_la, hand_l), (geo_ra, hand_r)):
        sgn = 1.0 if geo.side == "l" else -1.0
        pole = np.array([sgn * 0.25, -1.0, -0.1])   # elbows toward the hips
        sho_aa, elb_aa = solve_arm(geo, aa, pelvis_p, pelvis_R, tgt, pole)
        aa[:, J[geo.side + "shoulder"]] = sho_aa
        aa[:, J[geo.side + "elbow"]] = elb_aa

    def foot_R_of(fy):
        return (_yaw(fy)
                @ Rotation.from_euler(
                    "y", np.full((T, 1), 0.8 * pitch)).as_matrix()
                @ _R_ZUP.as_matrix())

    return _assemble(T, pelvis_p, pelvis_R, ankle_l, ankle_r,
                     foot_R_of(yaw_l), foot_R_of(yaw_r), aa)


def make_lean(rng, duration_s: float = 9.0):
    """Stand and lean on a wall-height point: one (sometimes both) hand(s)
    pinned at 0.95-1.4 m while the body sways — ELEVATED wrist contacts
    (the reference's support-surface case) with feet planted throughout."""
    T = int(duration_s * FPS)
    t = np.arange(T) / FPS
    geo_l, _ = leg_geometry()
    leg_drop = -(geo_l.hip_off[1] + geo_l.b1[1] + geo_l.b2[1])
    yaw0 = rng.uniform(-np.pi, np.pi)
    fwd = np.array([np.cos(yaw0), np.sin(yaw0)])
    left = np.array([-np.sin(yaw0), np.cos(yaw0)])
    c = rng.uniform(-1.0, 1.0, 2)

    stance_w = rng.uniform(0.10, 0.16)
    ankle_l = np.tile(np.r_[c + stance_w * left, ANKLE_REST_H], (T, 1))
    ankle_r = np.tile(np.r_[c - stance_w * left, ANKLE_REST_H], (T, 1))

    sway_a = rng.uniform(0.03, 0.08)
    sway_f = rng.uniform(0.15, 0.35)
    lat_a = rng.uniform(0.01, 0.04)
    sway = np.sin(2 * np.pi * sway_f * t)
    pel_xy = (c + sway_a * sway[:, None] * fwd
              + lat_a * np.sin(2 * np.pi * rng.uniform(0.1, 0.3) * t
                               + rng.uniform(0, 2 * np.pi))[:, None] * left)
    pel_z = (rng.uniform(0.93, 0.97) * leg_drop + ANKLE_REST_H
             - rng.uniform(0.0, 0.03) * (0.5 + 0.5 * sway))
    pelvis_p = np.concatenate([pel_xy, pel_z[:, None]], 1)
    lean_pitch = (0.04 + 0.05 * rng.uniform()) * (1.0 + sway)
    pelvis_R = (_yaw(np.full(T, yaw0))
                @ Rotation.from_euler("y", lean_pitch[:, None]).as_matrix()
                @ _R_ZUP.as_matrix())
    foot_R = np.tile(_yaw(np.array([yaw0]))[0] @ _R_ZUP.as_matrix(),
                     (T, 1, 1))

    aa = _arm_drop_aa(T, rng)
    J = cst.SMPL_JOINT_IDX
    aa[:, J["lowerback"], 0] = 0.06 * sway
    aa[:, J["upperneck"]] = np.outer(
        0.1 * np.sin(2 * np.pi * rng.uniform(0.1, 0.3) * t),
        _unit(rng.normal(size=3)))

    geo_la, geo_ra = arm_geometry()
    p_jf, _ = np_fk_chain(aa, pelvis_p, pelvis_R)
    both = rng.uniform() < 0.35
    lean_side = rng.choice(["l", "r"])
    t0 = rng.uniform(0.8, 1.5)
    t1 = duration_s - rng.uniform(0.8, 1.5)
    wall_d = rng.uniform(0.38, 0.52)
    wall_z = rng.uniform(0.95, 1.40)
    for geo, sgn in ((geo_la, 1.0), (geo_ra, -1.0)):
        anchor = p_jf[:, geo.sho]
        planted = both or geo.side == lean_side
        if planted:
            wp = np.r_[c + fwd * wall_d
                       + sgn * left * rng.uniform(0.05, 0.2), wall_z]
            wp = fit_target_to_reach(anchor, wp, geo.reach)
            e = _hold_envelope(t, t0 + rng.uniform(0.0, 0.4),
                               t1 - rng.uniform(0.0, 0.4), 0.5)
            hang = anchor + np.array([0.0, 0.0, -0.90 * geo.reach])
            tgt = hang + (wp[None] - hang) * e[:, None]
            pole = np.array([sgn * 0.6, -1.0, 0.1])
            sho_aa, elb_aa = solve_arm(geo, aa, pelvis_p, pelvis_R, tgt,
                                       pole)
            aa[:, J[geo.side + "shoulder"]] = sho_aa
            aa[:, J[geo.side + "elbow"]] = elb_aa
        else:
            env = _reach_envelope(T, t, rng, rng.integers(1, 3))
            ax = _unit(rng.normal(size=3))
            base = aa[:, J[geo.side + "shoulder"]]
            r = (Rotation.from_rotvec(
                np.outer(env * rng.uniform(0.4, 1.0), ax))
                * Rotation.from_rotvec(base))
            aa[:, J[geo.side + "shoulder"]] = r.as_rotvec()
            aa[:, J[geo.side + "elbow"], 1] = -sgn * 0.4 * env

    return _assemble(T, pelvis_p, pelvis_R, ankle_l, ankle_r,
                     foot_R, foot_R, aa)


# corpus mix: (family, weight, kwargs sampler)
_FAMILIES = (
    ("walk_flat", 0.18, lambda rng: dict(terrain="flat")),
    ("walk_ramp", 0.08, lambda rng: dict(terrain="ramp")),
    ("walk_stairs", 0.13, lambda rng: dict(terrain="stairs")),
    ("walk_bumps", 0.06, lambda rng: dict(terrain="bumps")),
    ("idle", 0.08, lambda rng: dict()),
    ("squat", 0.07, lambda rng: dict()),
    ("dance", 0.08, lambda rng: dict()),
    ("freeform", 0.06, lambda rng: dict()),
    # contact-rich families: wrist/pelvis SBP positive labels (VERDICT r3)
    ("sit", 0.09, lambda rng: dict()),
    ("floorsit", 0.07, lambda rng: dict()),
    ("crawl", 0.06, lambda rng: dict()),
    ("lean", 0.04, lambda rng: dict()),
)


def make_motion(rng, family: Optional[str] = None,
                duration_s: Optional[float] = None):
    """One random motion; family sampled from the corpus mix when None.
    duration_s overrides the per-family random duration (fixed-length
    held-out sets compile once per runner shape in the eval harness)."""
    if family is None:
        w = np.array([f[1] for f in _FAMILIES])
        family = _FAMILIES[rng.choice(len(_FAMILIES), p=w / w.sum())][0]
    kw = next(kws for n, _, kws in _FAMILIES + _EXTRA_FAMILIES
              if n == family)(rng)

    def dur(lo, hi):
        if duration_s is not None:
            return duration_s
        # quantize to 2 s steps, as tip_tpu does (there every distinct
        # length is a fresh compile of its synthesis): the draw is part of
        # the (seed, i) stream, so every file depends on it
        return float(rng.integers(int(lo) // 2, int(hi) // 2 + 1) * 2)

    if family.startswith("walk"):
        return family, make_walk(rng, duration_s=dur(8, 16), **kw)
    if family == "idle":
        return family, make_idle(rng, duration_s=dur(6, 12))
    if family == "squat":
        return family, make_squat(rng, duration_s=dur(6, 10))
    if family == "dance":
        return family, make_dance(rng, duration_s=dur(6, 12))
    if family == "sit":
        return family, make_sit(rng, duration_s=dur(8, 12))
    if family == "floorsit":
        return family, make_floorsit(rng, duration_s=dur(8, 12))
    if family == "crawl":
        return family, make_crawl(rng, duration_s=dur(8, 12))
    if family == "lean":
        return family, make_lean(rng, duration_s=dur(8, 10))
    if family == "freeform2":
        return family, make_freeform2(rng, duration_s=dur(8, 12))
    return family, make_freeform(rng, duration_s=dur(5, 10))


def generate_corpus(out_dir: str, n_motions: int, seed: int = 0,
                    start: int = 0, duration_s: Optional[float] = None,
                    log=print, exclude=(), families=None,
                    device=None) -> int:
    """Write `n_motions` synthesized training pickles into out_dir.

    Resumable/idempotent like the reference generator (existing outputs are
    skipped, data-gen-and-viz-bullet-new.py:245-247): motion i derives its
    RNG from (seed, i), so reruns and partial runs produce identical files.
    Returns the number of motions written this call.

    exclude: family names dropped from the mix (weights renormalized) —
    leave-one-family-out generalization studies. NOTE: a non-empty exclude
    changes the (seed, i) -> family stream, so excluded and full corpora are
    different draws, not a filtered subset.

    families: explicit family mix (names from _FAMILIES or the opt-in
    _EXTRA_FAMILIES, equal weights) — single-family supplements like the
    corpus v3 freeform-boost set. Mutually exclusive with exclude. The
    default (None) path is byte-for-byte the historical draw stream.

    device: where ``amass_syn.synthesize`` runs, in float64 (``cuda``
    unless the caller asks for another; with no CUDA it raises).
    """
    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.data_gen import amass_syn
    device = resolve_device(device)
    if families is not None:
        if exclude:
            raise ValueError("families= and exclude= are mutually exclusive")
        known = {f[0] for f in _FAMILIES + _EXTRA_FAMILIES}
        bad = set(families) - known
        if bad:
            raise ValueError(f"unknown corpus families {sorted(bad)}; "
                             f"known: {sorted(known)}")
        fams = [(n, 1.0, k) for n, _, k in _FAMILIES + _EXTRA_FAMILIES
                if n in set(families)]
    else:
        known = {f[0] for f in _FAMILIES}
        bad = set(exclude) - known
        if bad:
            raise ValueError(f"unknown corpus families {sorted(bad)}; "
                             f"known: {sorted(known)}")
        fams = [f for f in _FAMILIES if f[0] not in exclude]
    os.makedirs(out_dir, exist_ok=True)
    wrote = 0
    for i in range(start, start + n_motions):
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        w = np.array([f[1] for f in fams])
        family = fams[int(rng.choice(len(fams), p=w / w.sum()))][0]
        path = os.path.join(out_dir, f"{family}_{i:04d}.pkl")
        if os.path.exists(path):
            continue
        _, motion = make_motion(rng, family, duration_s=duration_s)
        payload = amass_syn.synthesize(motion, rng=rng, device=device)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        wrote += 1
        if wrote % 25 == 0:
            log(f"corpus: {wrote} motions written (at index {i})")
    return wrote
