"""Emit a URDF from the skeleton tables for external viewers (twin of
tip_tpu/viz/urdf_export.py; its output text byte for byte).

The reference ships its character as a URDF asset (data/amass.urdf) that
PyBullet both simulates and renders; this package keeps the skeleton as
plain arrays (chars/amass_skeleton.py) and the FK in torch, so a viewer that
wants a URDF (tip_tpu_torch.viz.pybullet_viz, or any external tool) gets
one generated from the same tables. Round trip checked by test:
``parse_urdf(export(...))`` reproduces the source arrays exactly.

Visual geometry is synthesized (the framework does not vendor the
reference's hand-tuned collision spheres): a capsule along each bone plus a
sphere at each link CoM — enough for a faithful stick-figure render of the
kinematics the product actually computes.
"""

import os
from typing import Optional, Sequence

import numpy as np

from tip_tpu_torch.chars import amass as amass_char
from tip_tpu_torch.chars import amass_skeleton as tbl


def _vec(v) -> str:
    return " ".join(f"{x:.8g}" for x in np.asarray(v, dtype=float))


def _visuals(bone_vecs, radius: float) -> str:
    """Capsule visuals from this link's origin toward each child joint."""
    out = []
    for v in bone_vecs:
        length = float(np.linalg.norm(v))
        if length < 1e-6:
            continue
        mid = np.asarray(v) / 2.0
        # rotate capsule z-axis onto the bone direction
        d = np.asarray(v) / length
        # rpy for z->d: pitch = acos(dz), yaw = atan2(dy, dx) applied as
        # extrinsic xyz rpy (roll 0, pitch, yaw)
        pitch = float(np.arccos(np.clip(d[2], -1.0, 1.0)))
        yaw = float(np.arctan2(d[1], d[0]))
        out.append(
            f'      <visual>\n'
            f'        <origin xyz="{_vec(mid)}" rpy="0 {pitch:.8g} {yaw:.8g}"/>\n'
            f'        <geometry><capsule radius="{radius}" '
            f'length="{length:.8g}"/></geometry>\n'
            f'      </visual>')
    return "\n".join(out)


def skeleton_to_urdf(path: Optional[str] = None, *,
                     robot_name: str = "tip_amass",
                     joint_names: Optional[Sequence[str]] = None,
                     bone_radius: float = 0.035) -> str:
    """Generate the AMASS character URDF from chars/amass_skeleton tables.

    Joint order, origins, types (spherical / fixed wrists), inertial origins
    and masses match the tables (and hence the reference asset they
    transcribe, the reference's data/amass.urdf:565-703).  Returns the URDF
    text; writes it to ``path`` when given.
    """
    names = list(joint_names or amass_char.JOINT_NAMES)
    J = len(names)
    if J != len(tbl.PARENT):
        raise ValueError(f"{J} joint names for {len(tbl.PARENT)} joints")
    link_names = ["root"] + names

    # children of each link (by link index: 0 = root, j+1 = joint j's child)
    children = [[] for _ in range(J + 1)]
    for j in range(J):
        children[tbl.PARENT[j] + 1].append(j)

    chunks = [f'<?xml version="1.0"?>\n<robot name="{robot_name}">']
    for li, lname in enumerate(link_names):
        com = tbl.COM_OFFSET[li]
        mass = tbl.LINK_MASS[li]
        bones = [tbl.JOINT_OFFSET[c] for c in children[li]]
        vis = _visuals(bones, bone_radius)
        chunks.append(
            f'  <link name="{lname}">\n'
            f'    <inertial>\n'
            f'      <origin xyz="{_vec(com)}" rpy="0 0 0"/>\n'
            f'      <mass value="{mass:.8g}"/>\n'
            f'      <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.001" '
            f'iyz="0" izz="0.001"/>\n'
            f'    </inertial>\n'
            f'      <visual>\n'
            f'        <origin xyz="{_vec(com)}" rpy="0 0 0"/>\n'
            f'        <geometry><sphere radius="{bone_radius * 1.3:.8g}"/>'
            f'</geometry>\n'
            f'      </visual>\n'
            + (vis + "\n" if vis else "")
            + f'  </link>')
    for j, jname in enumerate(names):
        jtype = "fixed" if tbl.IS_FIXED[j] else "spherical"
        chunks.append(
            f'  <joint name="{jname}" type="{jtype}">\n'
            f'    <origin xyz="{_vec(tbl.JOINT_OFFSET[j])}" rpy="0 0 0"/>\n'
            f'    <parent link="{link_names[tbl.PARENT[j] + 1]}"/>\n'
            f'    <child link="{jname}"/>\n'
            f'  </joint>')
    chunks.append("</robot>\n")
    text = "\n".join(chunks)
    if path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return text


def default_urdf_path() -> str:
    """Write (once) and return a cached generated URDF for viewers."""
    import tempfile
    path = os.path.join(tempfile.gettempdir(), "tip_tpu_torch_amass.urdf")
    if not os.path.exists(path):
        skeleton_to_urdf(path)
    return path
