"""Developer visualization: SBP label QA and real-vs-synthetic IMU overlays
(twin of tip_tpu/viz/plots.py).

Matplotlib equivalents of the reference's viz_generated_sbp.py (SBP labels
and residue-drift plots) and viz_raw_DIP_TC.py (real DIP/TC IMU acc/ori
against the PyBullet-synthesised equivalents), both "untested and
uncleaned" dev tools there; here importable functions that write PNGs.
matplotlib is imported where drawing starts; without it the ImportError
names the package.
"""

import numpy as np
import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch import resolve_device


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("matplotlib is not installed; the plots of "
                          "tip_tpu_torch.viz.plots need it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_sbp_labels(constrs: np.ndarray, out_png: str,
                    link_names=("lankle", "rankle", "lwrist", "rwrist", "root")):
    """Contact flags + offset magnitudes over time for each SBP link."""
    plt = _plt()
    n = constrs.shape[1] // 4
    fig, axes = plt.subplots(n, 1, figsize=(10, 2 * n), sharex=True)
    t = np.arange(len(constrs)) * cst.DT
    for i in range(n):
        ax = axes[i] if n > 1 else axes
        c = constrs[:, 4 * i:4 * i + 4]
        ax.fill_between(t, 0, c[:, 0], alpha=0.3, label="contact")
        ax.plot(t, np.linalg.norm(c[:, 1:], axis=1), label="|offset| (m)")
        ax.set_ylabel(link_names[i] if i < len(link_names) else f"sbp{i}")
        ax.legend(loc="upper right", fontsize=7)
    (axes[-1] if n > 1 else axes).set_xlabel("time (s)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def sbp_residue_drift(pq_link: np.ndarray, constrs_link: np.ndarray,
                      dt: float = cst.DT, device=None) -> np.ndarray:
    """(T, 3) accumulated velocity-residue drift of one link's SBP labels:
    the residue of each contact frame (``ops/sbp.residue_from_contr`` of
    the frame and the one before, all frames in one batched call on
    ``device``, ``cuda`` unless given, in float64), integrated over
    time."""
    from tip_tpu_torch.ops import sbp as sbp_ops
    device = resolve_device(device)
    pq = torch.as_tensor(np.asarray(pq_link), dtype=torch.float64,
                         device=device)
    c = torch.as_tensor(np.asarray(constrs_link), dtype=torch.float64,
                        device=device)
    r = sbp_ops.residue_from_contr(pq[:-1, :3], pq[:-1, 3:], pq[1:, :3],
                                   pq[1:, 3:], dt, c[1:, 1:4])
    r = torch.where((c[1:, :1] == 1.0), r, torch.zeros_like(r))
    resid = torch.cat([torch.zeros_like(r[:1]), r]).cpu().numpy()
    return np.cumsum(resid * dt, axis=0)


def plot_sbp_residue_drift(pq_link: np.ndarray, constrs_link: np.ndarray,
                           out_png: str, dt: float = cst.DT, device=None):
    """Accumulated velocity-residue drift of one link's SBP labels, the
    reference's QA plot for label quality (viz_generated_sbp.py). Returns
    the drift (``sbp_residue_drift``)."""
    plt = _plt()
    drift = sbp_residue_drift(pq_link, constrs_link, dt, device)
    T = len(pq_link)

    fig, ax = plt.subplots(figsize=(10, 4))
    tt = np.arange(T) * dt
    for i, lbl in enumerate("xyz"):
        ax.plot(tt, drift[:, i], label=f"drift {lbl} (m)")
    ax.plot(tt, constrs_link[:, 0] * drift.max() if drift.max() else
            constrs_link[:, 0], alpha=0.2, label="contact")
    ax.legend()
    ax.set_xlabel("time (s)")
    ax.set_title("SBP residue drift (should stay near zero during contact)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return drift


def plot_terrain(region_heights: np.ndarray, out_png: str,
                 grid_size: float = cst.GRID_SIZE):
    """Render a terrain height field (runtime.terrain.height_field output):
    the matplotlib stand-in for the reference's PyBullet heightfield
    view."""
    plt = _plt()
    g = region_heights.shape[0]
    extent = [-g / 2 * grid_size, g / 2 * grid_size] * 2
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(np.asarray(region_heights).T, origin="lower",
                   extent=extent, cmap="terrain")
    fig.colorbar(im, ax=ax, label="height (m)")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_title("estimated terrain height regions")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_imu_overlay(real_imu: np.ndarray, syn_imu: np.ndarray, out_png: str,
                     sensor: int = 0):
    """Real vs synthetic IMU acc + one orientation column for one sensor
    (viz_raw_DIP_TC.py equivalent)."""
    plt = _plt()
    T = min(len(real_imu), len(syn_imu))
    t = np.arange(T) * cst.DT
    fig, axes = plt.subplots(2, 3, figsize=(14, 6), sharex=True)
    for a in range(3):
        axes[0, a].plot(t, real_imu[:T, 54 + sensor * 3 + a], label="real")
        axes[0, a].plot(t, syn_imu[:T, 54 + sensor * 3 + a], label="syn",
                        alpha=0.7)
        axes[0, a].set_title(f"acc[{a}]")
        axes[1, a].plot(t, real_imu[:T, sensor * 9 + a], label="real")
        axes[1, a].plot(t, syn_imu[:T, sensor * 9 + a], label="syn",
                        alpha=0.7)
        axes[1, a].set_title(f"R[0,{a}]")
    axes[0, 0].legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
