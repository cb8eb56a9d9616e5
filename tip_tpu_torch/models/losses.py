"""Training losses, NaN-mask aware (twin of tip_tpu/models/losses.py).

DIP rows carry NaN root-velocity / SBP labels that are excluded from the
mean without changing shapes: masked sums over static shapes, the same
arithmetic as tip_tpu's.

Under a mesh each rank holds its rows of the batch, and every mean is the
global batch's: each loss takes ``psum`` (``parallel.mesh.data_sum``), the
differentiable sum over the data axis, and divides the summed sums by the
summed counts (the NaN rows need not fall evenly on the ranks). None: one
device's arithmetic.
"""

import torch


def _mean(x, psum=None):
    """torch.mean(x); with ``psum``, the mean over every rank's x."""
    if psum is None:
        return torch.mean(x)
    n = torch.full((), x.numel(), dtype=torch.int64, device=x.device)
    return psum(torch.sum(x)) / psum(n)


def _masked_mean(err, row_mask, psum=None):
    """Mean of err over rows where row_mask is True (torch's
    ``x[mask].mean()``: the selected rows times the row width); with
    ``psum``, over every rank's rows."""
    n = torch.sum(row_mask)
    total = torch.sum(torch.where(row_mask[:, None], err,
                                  torch.zeros((), dtype=err.dtype,
                                              device=err.device)))
    if psum is not None:
        n, total = psum(n), psum(total)
    return total / torch.clamp_min(n * err.shape[-1], 1)


def loss_q_only_2axis(ra, rb, psum=None):
    """Pose + root-velocity loss. ra, rb: (N, 111) = 108 two-axis rotation
    channels + 3 root velocity; rb is the prediction. Rows whose xy root
    velocity is NaN are masked out; xy is weighted x6, z x12, pose x100."""
    loss_q = _mean((rb[:, :-3] - ra[:, :-3]) ** 2, psum) * 100.0
    xy_a, xy_b = ra[:, -3:-1], rb[:, -3:-1]
    mask = ~torch.any(torch.isnan(xy_a), dim=1)
    xy_a = torch.nan_to_num(xy_a)
    loss_xy = _masked_mean((xy_a - xy_b) ** 2, mask, psum) * 6.0
    z_a = torch.nan_to_num(ra[:, -1:])
    loss_z = _masked_mean((z_a - rb[:, -1:]) ** 2, mask, psum) * 12.0
    return loss_q + loss_xy + loss_z


def _bce_with_logits(logits, targets):
    """Numerically stable BCE(sigmoid(logits), targets), elementwise."""
    return (torch.clamp_min(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_constr_multi(ra, rb, n_sbps: int = 5, psum=None):
    """SBP loss. ra: (N, 4*n_sbps) ground truth [flag, offset*3] per SBP;
    rb: prediction [logit, offset*3]. Rows with any NaN are masked. Offsets
    are compared against 5 x the ground truth, weighted x4; the total is
    averaged over SBPs and scaled x2.5."""
    mask = ~torch.any(torch.isnan(ra), dim=1)
    ra = torch.nan_to_num(ra)
    total = 0.0
    for i in range(n_sbps):
        s = 4 * i
        c_l = _masked_mean(
            _bce_with_logits(rb[:, s:s + 1], ra[:, s:s + 1]), mask, psum)
        r_l = _masked_mean(
            (rb[:, s + 1:s + 4] - ra[:, s + 1:s + 4] * 5.0) ** 2, mask,
            psum)
        total = total + c_l + r_l * 4.0
    return total / n_sbps * 2.5


def loss_jerk(rb, psum=None):
    """Third-finite-difference smoothness loss on the pose channels.
    rb: (B, T, 108)."""
    jit_ = (rb[:, 3:, :] - 3 * rb[:, 2:-1, :] + 3 * rb[:, 1:-2, :]
            - rb[:, :-3, :])
    return _mean(jit_ ** 2, psum) * 100.0
