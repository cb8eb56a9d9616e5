"""IMU feature transforms (twin of tip_tpu/ops/imu.py).

Feature layout of one frame (72,): [root_R(9), 5 x sensor_R(9)=45,
root_acc(3), 5 x sensor_acc(3)=15].
"""

import torch

from tip_tpu_torch import constants as cst


def imu_rotate_to_local(imu):
    """Rotate the 5 non-root sensors into the root sensor's frame: the root
    rotation and root acceleration stay global; the other five rotation
    matrices and accelerations are premultiplied by root_R^T.

    Args: imu (..., 72). Returns same shape.
    """
    lead = imu.shape[:-1]
    root_r = imu[..., :9].reshape(lead + (3, 3))
    other_r = imu[..., 9:54].reshape(lead + (5, 3, 3))
    root_acc = imu[..., 54:57]
    other_acc = imu[..., 57:72].reshape(lead + (5, 3))

    inv = root_r.transpose(-1, -2)
    other_r_local = torch.einsum("...ij,...njk->...nik", inv, other_r)
    other_acc_local = torch.einsum("...ij,...nj->...ni", inv, other_acc)

    return torch.cat([
        root_r.reshape(lead + (9,)),
        other_r_local.reshape(lead + (45,)),
        root_acc,
        other_acc_local.reshape(lead + (15,)),
    ], dim=-1)


def uniform_filter1d_nearest(x, size: int, dim: int = 0):
    """Centered moving average with 'nearest' edge padding along ``dim``
    (scipy.ndimage.uniform_filter1d(mode='nearest'); for even ``size`` the
    window has one extra sample on the left)."""
    x = torch.movedim(x, dim, 0)
    left = size // 2
    right = size - 1 - left
    xp = torch.cat([x[:1].expand((left,) + x.shape[1:]), x,
                    x[-1:].expand((right,) + x.shape[1:])], dim=0)
    c = torch.cumsum(xp, dim=0)
    c = torch.cat([torch.zeros_like(c[:1]), c], dim=0)
    out = (c[size:] - c[:-size]) / size
    return torch.movedim(out, 0, dim)


def windowed_acc_sum(local_acc, win: int = cst.ACC_SUM_WIN_LEN,
                     scale: float = cst.ACC_SUM_DOWN_SCALE):
    """b[t] = sum(acc[max(0, t-win+1) : t+1]) / scale. local_acc: (T, 18)."""
    b = torch.cumsum(local_acc, dim=0)
    shifted = torch.cat([torch.zeros_like(b[:win]), b[:-win]], dim=0)
    return (b - shifted) / scale


def central_diff_acc(pos, dt_fin: float = cst.DT_FIN_ACC,
                     half_n: int = cst.ACC_FD_N):
    """Virtual accelerometer from positions via a +/-half_n-frame second
    difference, with edge rows clamped. pos: (T, ..., 3)."""
    acc = torch.zeros_like(pos)
    core = (pos[2 * half_n:] + pos[:-2 * half_n] - 2 * pos[half_n:-half_n]) \
        / (dt_fin ** 2)
    acc[half_n:-half_n] = core
    acc[:half_n] = acc[half_n]
    acc[-half_n:] = acc[-half_n - 1]
    return acc
