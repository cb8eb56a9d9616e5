"""Batched rotation codecs in PyTorch (twin of tip_tpu/ops/rotations.py).

Conventions match the reference pipeline (fairmotion / scipy / PyBullet):
  * quaternions are (x, y, z, w),
  * axis-angle is a rotation vector (axis * angle),
  * ``q_mult(a, b)`` satisfies ``to_matrix(q_mult(a,b)) == to_matrix(a) @ to_matrix(b)``.

All functions broadcast over leading batch dimensions and have no
data-dependent branches.

The 6D ("two-axis") codec reproduces the reference's decode rule: both
columns are normalised with a +1e-6 denominator and the third column is
their cross product — the second column is *not* re-orthogonalised.

``cos`` is the plain one here; tip_tpu computes it as ``sin(pi/2 - x)``
to work around an inexact float64 ``cos`` of XLA:CPU, which torch does not
have. The CUDA kernels use plain ``cos`` too.
"""

import torch

_EPS = 1e-12


def cross(a, b):
    """Broadcasting 3-vector cross product over the last axis."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def q_mult(q1, q2):
    """Hamilton product, xyzw. R(q1∘q2) = R(q1) @ R(q2)."""
    v1, w1 = q1[..., :3], q1[..., 3:4]
    v2, w2 = q2[..., :3], q2[..., 3:4]
    w = w1 * w2 - torch.sum(v1 * v2, dim=-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + cross(v1, v2)
    return torch.cat([v, w], dim=-1)


def q_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def q_inv(q):
    """Inverse for unit quaternions (= conjugate)."""
    return q_conj(q)


def q_diff(q1, q2):
    """Relative rotation q1 ∘ q2⁻¹ (the angle metrics consume only its
    magnitude)."""
    return q_mult(q1, q_inv(q2))


def q_rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q."""
    qv, qw = q[..., :3], q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def q_normalize(q):
    return q / torch.clamp(_norm(q), min=_EPS)


def _safe_norm(v):
    """norm(v) with the sum of squares clamped at 1e-24 (identical to the
    plain norm for |v| >= 1e-12)."""
    return torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True),
                                  min=1e-24))


def aa_to_q(aa):
    """Rotation vector -> quaternion (xyzw)."""
    angle = _safe_norm(aa)
    half = 0.5 * angle
    # sin(θ/2)/θ with a 2nd-order Taylor fallback near zero
    small = angle < 1e-6
    k = torch.where(small, 0.5 - angle * angle / 48.0,
                    torch.sin(half) / torch.where(small, torch.ones_like(angle),
                                                  angle))
    return torch.cat([aa * k, torch.cos(half)], dim=-1)


def _w_sign(w):
    """sign(w) with w == 0 mapped to +1 (canonical w >= 0 quaternions)."""
    return torch.sign(torch.where(w == 0.0, torch.ones_like(w), w))


def q_to_aa(q):
    """Quaternion (xyzw) -> rotation vector with angle in [0, π]."""
    q = q * _w_sign(q[..., 3:4])
    v = q[..., :3]
    s = _safe_norm(v)
    w = q[..., 3:4]
    angle = 2.0 * torch.atan2(s, w)
    small = s < 1e-6
    # θ/s = 2·atan2(s,w)/s ≈ 2/w · (1 − s²/(3w²)) for small s (w≈1)
    k = torch.where(small,
                    2.0 / torch.clamp(torch.abs(w), min=1e-6)
                    * (1.0 - s * s / (3.0 * torch.clamp(w * w, min=1e-6))),
                    angle / torch.where(small, torch.ones_like(s), s))
    return v * k


def q_to_matrix(q):
    """Quaternion (xyzw) -> 3x3 rotation matrix."""
    q = q_normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_q(m):
    """3x3 rotation matrix -> quaternion (xyzw), branchless Shepperd method.

    All four candidates are computed; the one built from the largest of
    (tw, tx, ty, tz) is kept, the first of equal maxima winning (argmax's
    tie-break), then normalised and signed to w >= 0 (w == 0 -> +1).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22      # 4w²
    tx = 1.0 + m00 - m11 - m22      # 4x²
    ty = 1.0 - m00 + m11 - m22      # 4y²
    tz = 1.0 - m00 - m11 + m22      # 4z²

    def safe_sqrt(t):
        return torch.sqrt(torch.clamp(t, min=_EPS))

    qw_w = safe_sqrt(tw) / 2.0
    q_w = torch.stack([(m21 - m12) / (4 * qw_w), (m02 - m20) / (4 * qw_w),
                       (m10 - m01) / (4 * qw_w), qw_w], dim=-1)
    qx_x = safe_sqrt(tx) / 2.0
    q_x = torch.stack([qx_x, (m01 + m10) / (4 * qx_x), (m02 + m20) / (4 * qx_x),
                       (m21 - m12) / (4 * qx_x)], dim=-1)
    qy_y = safe_sqrt(ty) / 2.0
    q_y = torch.stack([(m01 + m10) / (4 * qy_y), qy_y, (m12 + m21) / (4 * qy_y),
                       (m02 - m20) / (4 * qy_y)], dim=-1)
    qz_z = safe_sqrt(tz) / 2.0
    q_z = torch.stack([(m02 + m20) / (4 * qz_z), (m12 + m21) / (4 * qz_z),
                       qz_z, (m10 - m01) / (4 * qz_z)], dim=-1)

    is_w = (tw >= tx) & (tw >= ty) & (tw >= tz)
    is_x = (~is_w) & (tx >= ty) & (tx >= tz)
    is_y = (~is_w) & (~is_x) & (ty >= tz)
    q = torch.where(is_w[..., None], q_w,
                    torch.where(is_x[..., None], q_x,
                                torch.where(is_y[..., None], q_y, q_z)))
    q = q_normalize(q)
    return q * _w_sign(q[..., 3:4])


def aa_to_matrix(aa):
    return q_to_matrix(aa_to_q(aa))


def matrix_to_aa(m):
    return q_to_aa(matrix_to_q(m))


def aa_to_sixd(aa):
    """Rotation vector(s) (..., 3) -> first two matrix *columns* (..., 6),
    laid out (r00, r01, r10, r11, r20, r21)."""
    r = aa_to_matrix(aa)
    return r[..., :, :2].reshape(aa.shape[:-1] + (6,))


def sixd_to_matrix(sixd):
    """(..., 6) two-axis encoding -> matrix: both columns normalised with
    +1e-6 in the denominator, third column = cross(col0, col1)."""
    cols = sixd.reshape(sixd.shape[:-1] + (3, 2))
    a1 = cols[..., 0]
    a2 = cols[..., 1]
    a1 = a1 / (_norm(a1) + 1e-6)
    a2 = a2 / (_norm(a2) + 1e-6)
    a3 = cross(a1, a2)
    return torch.stack([a1, a2, a3], dim=-1)


def sixd_to_aa(sixd):
    return matrix_to_aa(sixd_to_matrix(sixd))


def slerp(q0, q1, t):
    """Spherical interpolation between unit quaternions (xyzw)."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0.0, -q1, q1)
    d = torch.abs(d)
    theta = torch.acos(torch.clamp(d, -1.0, 1.0))
    sin_t = torch.sin(theta)
    near = sin_t < 1e-6
    den = torch.where(near, torch.ones_like(sin_t), sin_t)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / den)
    w1 = torch.where(near, t, torch.sin(t * theta) / den)
    return q_normalize(w0 * q0 + w1 * q1)


def angular_velocity_from_quats(q1, q2, dt):
    """Finite-difference world angular velocity between two quats:
    sub = (q2 - q1) or (q2 + q1), whichever is smaller in norm,
    w = (2 * sub ∘ q2⁻¹ / dt)[:3]."""
    d_minus = _norm(q2 - q1)
    d_plus = _norm(q2 + q1)
    sub = torch.where(d_minus < d_plus, q2 - q1, q2 + q1)
    dori = 2.0 * q_mult(sub, q_conj(q2))
    return dori[..., :3] / dt
