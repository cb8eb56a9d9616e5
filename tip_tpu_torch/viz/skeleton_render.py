"""Offline 3D skeleton + terrain renderer, matplotlib without PyBullet
(twin of tip_tpu/viz/skeleton_render.py).

The reference's visual output is PyBullet's GUI (render_funcs.py:69-227:
character body, SBP marker spheres, terrain boxes in an interactive
window). Here trajectories are run through the port's FK
(``ops/kinematics.fk_our_state``) on the skeleton's device, all rendered
frames in one batched call, and drawn on the host as 3D stick figures with
matplotlib's Agg backend, written as PNG frames or an animated GIF
(Pillow's writer, no ffmpeg). matplotlib and Pillow are imported where
drawing starts; without them the ImportError names the package and the
flags that need it.

Rendered elements, mirroring the reference GUI's information content:
  * the predicted skeleton (bones = joint-frame link segments), solid;
  * an optional ground-truth skeleton, dashed gray (the reference's
    GT-compare viewer, offline_testing_simple.py:228-260);
  * optional SBP markers: active-contact locations as red dots (the
    reference's marker spheres, render_funcs.py:178-205);
  * an optional terrain height map: the established cells of the runner's
    final map (``runtime/terrain.height_field``) drawn as boxes (the
    reference's terrain boxes).
"""

import os
from typing import Optional

import numpy as np
import torch

from tip_tpu_torch import resolve_device
from tip_tpu_torch.ops import kinematics as kin
from tip_tpu_torch.runtime import terrain as terrain_lib

_NEEDS = "the renderer (cli/evaluate --render_gifs, cli/render)"


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"matplotlib is not installed; {_NEEDS} needs "
                          f"it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"Pillow is not installed; {_NEEDS} writes its "
                          f"images with it") from e
    return Image


def fk_links(skel: kin.Skeleton, qdq_traj) -> np.ndarray:
    """(T, 114) our-states -> (T, J+1, 3) joint-frame link positions, one
    batched FK on the skeleton's device in its dtype, copied to the host."""
    s = torch.as_tensor(np.asarray(qdq_traj),
                        dtype=skel.joint_offset.dtype,
                        device=skel.joint_offset.device)
    _, pq_jf = kin.fk_our_state(skel, s, return_joint_frame=True)
    return pq_jf[..., :3].cpu().numpy()


def bone_segments(skel: kin.Skeleton):
    """(B, 2) link-index pairs: one bone per joint, parent link -> child
    link (pq rows are root-first, so joint j's child link is row j+1)."""
    return np.array([(p + 1, j + 1) for j, p in enumerate(skel.parent)],
                    dtype=np.int64)


def _draw_skeleton(ax, links: np.ndarray, bones: np.ndarray,
                   color: str, ls: str = "-", lw: float = 2.0, alpha=1.0):
    for a, b in bones:
        ax.plot(*zip(links[a], links[b]), color=color, ls=ls, lw=lw,
                alpha=alpha)
    ax.scatter(*links[0], color=color, s=18, alpha=alpha)   # root


def _draw_terrain(ax, terrain_state, terrain_cfg, pad_m: float = 2.0,
                  center_xy=(0.0, 0.0)):
    """Established cells of the height map near the character, as boxes."""
    conf = terrain_state.confidence.cpu().numpy()
    h = terrain_lib.height_field(terrain_state).cpu().numpy()
    G, gs = terrain_cfg.grid_num, terrain_cfg.grid_size
    xs = (np.arange(G) - G // 2) * gs
    keep = (np.abs(xs - center_xy[0]) <= pad_m)[:, None] \
        & (np.abs(xs - center_xy[1]) <= pad_m)[None, :]
    est = (conf > -99.0) & keep
    if not est.any():
        return
    ii, jj = np.nonzero(est)
    ax.bar3d(xs[ii] - gs / 2, xs[jj] - gs / 2, np.zeros(len(ii)),
             gs, gs, np.maximum(h[ii, jj], 1e-3),
             color="tan", alpha=0.35, shade=False, edgecolor="none")


def _draw_frame(links: np.ndarray, bones: np.ndarray,
                gt_links: Optional[np.ndarray] = None,
                sbp_locs: Optional[np.ndarray] = None,
                terrain_state=None, terrain_cfg=None,
                elev: float = 18.0, azim: float = -70.0,
                half_extent: float = 1.6, dpi: int = 80) -> np.ndarray:
    plt = _plt()
    fig = plt.figure(figsize=(5, 5), dpi=dpi)
    ax = fig.add_subplot(111, projection="3d")
    c = links[0]
    if terrain_state is not None and terrain_cfg is not None:
        _draw_terrain(ax, terrain_state, terrain_cfg,
                      pad_m=half_extent, center_xy=(c[0], c[1]))
    if gt_links is not None:
        _draw_skeleton(ax, gt_links, bones, color="gray", ls="--", lw=1.5,
                       alpha=0.8)
    _draw_skeleton(ax, links, bones, color="tab:blue")
    if sbp_locs is not None:
        act = np.asarray(sbp_locs)
        act = act[np.all(np.abs(act) < 99.0, axis=-1)]
        if len(act):
            ax.scatter(act[:, 0], act[:, 1], act[:, 2], color="red", s=30)

    ax.set_xlim(c[0] - half_extent, c[0] + half_extent)
    ax.set_ylim(c[1] - half_extent, c[1] + half_extent)
    ax.set_zlim(0.0, 2 * half_extent)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((1, 1, 1))
    fig.tight_layout(pad=0)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def render_frame(skel: kin.Skeleton, qdq: np.ndarray,
                 gt_qdq: Optional[np.ndarray] = None,
                 sbp_locs: Optional[np.ndarray] = None,
                 terrain_state=None, terrain_cfg=None,
                 **frame_kw) -> np.ndarray:
    """Render one posed frame to an (H, W, 3) uint8 RGB array.

    sbp_locs: (n_sbps, 3) active-contact world locations; rows >= 99 (the
    runner's "inactive" sentinel, runtime/runner.py viz track) are skipped.
    """
    gt_links = (None if gt_qdq is None
                else fk_links(skel, np.asarray(gt_qdq)[None])[0])
    return _draw_frame(fk_links(skel, np.asarray(qdq)[None])[0],
                       bone_segments(skel), gt_links=gt_links,
                       sbp_locs=sbp_locs, terrain_state=terrain_state,
                       terrain_cfg=terrain_cfg, **frame_kw)


def render_motion(skel: kin.Skeleton, qdq_traj: np.ndarray, out_path: str,
                  gt_qdq: Optional[np.ndarray] = None,
                  viz_locs: Optional[np.ndarray] = None,
                  terrain_state=None, terrain_cfg=None,
                  stride: int = 4, fps: int = 15, **frame_kw) -> int:
    """Render a trajectory to ``out_path`` (.gif animated through Pillow,
    or a printf-style .png pattern, e.g. frames_%04d.png). Returns the
    frame count.

    viz_locs: (T, n_sbps, 3) runner SBP viz track (inactive rows are 100s).
    Terrain, if given, is the run's FINAL map on every frame (the same
    simplification as viz/pybullet_viz.py's offline replay, a divergence
    from the reference's 15-frame re-mesh cadence).
    """
    idx = np.arange(0, len(qdq_traj), max(1, stride))
    links = fk_links(skel, np.asarray(qdq_traj)[idx])
    gt_links = (None if gt_qdq is None
                else fk_links(skel, np.asarray(gt_qdq)[idx]))
    bones = bone_segments(skel)
    frames = [_draw_frame(
        links[i], bones, gt_links=None if gt_links is None else gt_links[i],
        sbp_locs=None if viz_locs is None else viz_locs[t],
        terrain_state=terrain_state, terrain_cfg=terrain_cfg, **frame_kw)
        for i, t in enumerate(idx)]
    Image = _image()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    if out_path.endswith(".gif"):
        ims = [Image.fromarray(f) for f in frames]
        ims[0].save(out_path, save_all=True, append_images=ims[1:],
                    duration=int(1000 / fps), loop=0)
    else:
        for i, f in enumerate(frames):
            Image.fromarray(f).save(out_path % i)
    return len(frames)


def render_eval_dump(dump_path: str, out_path: str, motion: int = 0,
                     skel: Optional[kin.Skeleton] = None, device=None,
                     **kw) -> int:
    """Render one motion from an eval-harness raw-trajectory dump
    (``evaluate(save_trajs_path=...)``: {gt_list, ours_list, files}); the
    skeleton defaults to the AMASS humanoid on ``device`` (``cuda`` unless
    given)."""
    import pickle
    with open(dump_path, "rb") as fh:   # the harness's own dump
        d = pickle.load(fh)
    skel = skel or kin.amass_skeleton(device=resolve_device(device))
    return render_motion(skel, np.asarray(d["ours_list"][motion]), out_path,
                         gt_qdq=np.asarray(d["gt_list"][motion]), **kw)
