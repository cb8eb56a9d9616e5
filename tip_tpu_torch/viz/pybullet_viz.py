"""Optional PyBullet GUI backend (twin of tip_tpu/viz/pybullet_viz.py;
reference render_funcs.py:16-227).

The reference used PyBullet both as the FK engine and the renderer; here the
FK engine is the port's (tip_tpu_torch.ops.kinematics) and PyBullet survives
only as an optional viewer, imported inside the functions that need it: the
module imports without it, and a viewer made without it raises an
ImportError that names the package and the flags that need it.

Surface kept from the reference: two characters (prediction + GT), SBP marker
spheres, and a GEOM_HEIGHTFIELD terrain mesh refreshed from the runner's
region maps.
"""

from typing import Optional

import numpy as np

COLOR_OURS = [51 / 255.0, 153 / 255.0, 255 / 255.0, 1.0]
COLOR_GT = [0.6, 0.6, 0.6, 1.0]


def _pb():
    try:
        import pybullet as pb
        return pb
    except ImportError as e:
        raise ImportError(
            "pybullet is not installed; the viewer (cli/evaluate "
            "--viz_compare, cli/live_demo --viz) is optional — install the "
            "pybullet wheel to use tip_tpu_torch.viz.pybullet_viz") from e


class Viewer:
    def __init__(self, urdf_path: str, gui: bool = True, n_markers: int = 10,
                 compare_gt: bool = True):
        pb = _pb()
        self.pb = pb
        self.client = pb.connect(pb.GUI if gui else pb.DIRECT)
        flags = pb.URDF_MAINTAIN_LINK_ORDER
        self.body = pb.loadURDF(urdf_path, [0, 0, 0], useFixedBase=False,
                                flags=flags)
        self.body_gt = (pb.loadURDF(urdf_path, [0, 0, 0], useFixedBase=False,
                                    flags=flags) if compare_gt else None)
        self._set_color(self.body, COLOR_OURS)
        if self.body_gt is not None:
            self._set_color(self.body_gt, COLOR_GT)
        self.markers = [
            pb.createMultiBody(baseVisualShapeIndex=pb.createVisualShape(
                pb.GEOM_SPHERE, radius=0.03, rgbaColor=[1, 0, 0, 0.8]))
            for _ in range(n_markers)]
        self.h_shape = None
        self.h_body = None

    def _set_color(self, body, color):
        pb = self.pb
        pb.changeVisualShape(body, -1, rgbaColor=color)
        for j in range(pb.getNumJoints(body)):
            pb.changeVisualShape(body, j, rgbaColor=color)

    def set_pose(self, bullet_q: np.ndarray, gt: bool = False):
        """bullet_q: (57,) [xyz, root aa, 17 joint aa]."""
        pb = self.pb
        from scipy.spatial.transform import Rotation
        body = self.body_gt if gt else self.body
        pb.resetBasePositionAndOrientation(
            body, bullet_q[:3],
            Rotation.from_rotvec(bullet_q[3:6]).as_quat())
        active = [i for i in range(19) if i not in (14, 18)]
        qs = Rotation.from_rotvec(bullet_q[6:].reshape(17, 3)).as_quat()
        pb.resetJointStatesMultiDof(body, active, list(qs),
                                    [np.zeros(3)] * 17)

    def set_markers(self, locs: np.ndarray):
        for i, m in enumerate(self.markers[:len(locs)]):
            self.pb.resetBasePositionAndOrientation(m, locs[i], [0, 0, 0, 1])

    def update_heightfield(self, heights: np.ndarray, grid_size: float):
        """Replace the terrain mesh (reference update_height_field_pb,
        render_funcs.py:31-66)."""
        pb = self.pb
        rows, cols = heights.shape
        data = list(heights.T.reshape(-1))
        if self.h_shape is not None:
            self.h_shape = pb.createCollisionShape(
                shapeType=pb.GEOM_HEIGHTFIELD,
                meshScale=[grid_size, grid_size, 1.0],
                heightfieldData=data, numHeightfieldRows=rows,
                numHeightfieldColumns=cols,
                replaceHeightfieldIndex=self.h_shape)
        else:
            self.h_shape = pb.createCollisionShape(
                shapeType=pb.GEOM_HEIGHTFIELD,
                meshScale=[grid_size, grid_size, 1.0],
                heightfieldData=data, numHeightfieldRows=rows,
                numHeightfieldColumns=cols)
            self.h_body = pb.createMultiBody(0, self.h_shape)
        pb.resetBasePositionAndOrientation(self.h_body, [0, 0, 0],
                                           [0, 0, 0, 1])

    def close(self):
        self.pb.disconnect(self.client)


def replay_compare(viewer: "Viewer", pred_bullet: np.ndarray,
                   gt_bullet: Optional[np.ndarray] = None,
                   viz_locs: Optional[np.ndarray] = None,
                   heights: Optional[np.ndarray] = None,
                   grid_size: float = 0.1,
                   fps: Optional[float] = 60.0,
                   heightfield_every: int = 15):
    """Replay predicted (and optionally GT) bullet-format pose trajectories
    through the viewer: two characters + SBP markers + terrain heightfield,
    like the reference's offline compare loop
    (offline_testing_simple.py:228-260, render_funcs.py:69-227).

    Documented divergence: offline we re-mesh the FINAL terrain map every
    ``heightfield_every`` frames (the reference re-meshes the evolving map;
    the offline run only materialises the final state).
    """
    import time as _time
    T = len(pred_bullet)
    for t in range(T):
        viewer.set_pose(np.asarray(pred_bullet[t]))
        if gt_bullet is not None and viewer.body_gt is not None:
            viewer.set_pose(np.asarray(gt_bullet[t]), gt=True)
        if viz_locs is not None:
            viewer.set_markers(np.asarray(viz_locs[t]))
        if heights is not None and t % heightfield_every == 0:
            viewer.update_heightfield(np.asarray(heights), grid_size)
        if fps:
            _time.sleep(1.0 / fps)
