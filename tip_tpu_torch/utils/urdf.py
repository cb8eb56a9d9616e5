"""URDF -> flat skeleton arrays (the port's own copy of
tip_tpu/utils/urdf.py; numpy only).

The reference leans on Bullet's C++ URDF loader (via the pybullet wheel,
reference bullet_agent.py:65-69).  Here the skeleton is parsed once on the
host into flat arrays that feed the FK core
(tip_tpu_torch.ops.kinematics.skeleton_from_urdf).

Two parsers are provided with identical output:
  * a native C++ parser (native/urdf_parser.cpp, loaded through ctypes) — the
    production path, mirroring the reference's use of a native loader;
  * a pure-Python xml.etree fallback used when the shared library has not
    been built.

Joint order = file order, matching PyBullet's URDF_MAINTAIN_LINK_ORDER so the
reference's joint index tables (amass_char_info.py:28-47) apply unchanged.
"""

import ctypes
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_NATIVE_LIB = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "build", "libtipurdf.so")


@dataclass(frozen=True)
class UrdfSkeleton:
    """Host-side parse result (unscaled)."""
    joint_names: List[str]          # in file order
    parent: np.ndarray              # (J,) int32; -1 = root link
    joint_offset: np.ndarray        # (J, 3) joint origin xyz in parent link frame
    joint_rpy: np.ndarray           # (J, 3) joint origin rpy (all zero for amass)
    is_fixed: np.ndarray            # (J,) bool
    com_offset: np.ndarray          # (J+1, 3) inertial origin per link, root first
    link_mass: np.ndarray           # (J+1,)


def _parse_python(path: str) -> UrdfSkeleton:
    tree = ET.parse(path)
    robot = tree.getroot()

    def _vec(el, attr, default):
        if el is None or el.get(attr) is None:
            return np.array(default, dtype=np.float64)
        return np.array([float(x) for x in el.get(attr).split()], dtype=np.float64)

    links = {}
    link_order = []
    for link in robot.findall("link"):
        name = link.get("name")
        inertial = link.find("inertial")
        origin = inertial.find("origin") if inertial is not None else None
        mass_el = inertial.find("mass") if inertial is not None else None
        links[name] = {
            "com": _vec(origin, "xyz", [0.0, 0.0, 0.0]),
            "mass": float(mass_el.get("value")) if mass_el is not None else 0.0,
        }
        link_order.append(name)

    root_name = link_order[0]
    joint_names, offsets, rpys, fixed = [], [], [], []
    child_names, parent_links = [], []
    # two passes so a child joint may appear before its parent joint in file
    # order (the native parser resolves such forward references the same way)
    for joint in robot.findall("joint"):
        origin = joint.find("origin")
        joint_names.append(joint.get("name"))
        parent_links.append(joint.find("parent").get("link"))
        child_names.append(joint.find("child").get("link"))
        offsets.append(_vec(origin, "xyz", [0.0, 0.0, 0.0]))
        rpys.append(_vec(origin, "rpy", [0.0, 0.0, 0.0]))
        fixed.append(joint.get("type") == "fixed")

    for jname, plink, clink in zip(joint_names, parent_links, child_names):
        for link in (plink, clink):
            if link not in links:
                raise ValueError(
                    f"{path}: joint {jname!r} references undeclared link "
                    f"{link!r}")
    def _parent_idx(p):
        if p == root_name:
            return -1
        if p not in child_names:
            raise ValueError(f"{path}: parent link {p!r} is neither the "
                             f"root nor any joint's child")
        return child_names.index(p)

    parents = [_parent_idx(p) for p in parent_links]

    com = np.stack([links[root_name]["com"]] +
                   [links[c]["com"] for c in child_names])
    mass = np.array([links[root_name]["mass"]] +
                    [links[c]["mass"] for c in child_names])

    return UrdfSkeleton(
        joint_names=joint_names,
        parent=np.array(parents, dtype=np.int32),
        joint_offset=np.stack(offsets),
        joint_rpy=np.stack(rpys),
        is_fixed=np.array(fixed, dtype=bool),
        com_offset=com,
        link_mass=mass,
    )


def _parse_native(path: str) -> Optional[UrdfSkeleton]:
    if not os.path.exists(_NATIVE_LIB):
        return None
    lib = ctypes.CDLL(_NATIVE_LIB)
    lib.tip_urdf_parse.restype = ctypes.c_int
    lib.tip_urdf_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),     # parent (J)
        ctypes.POINTER(ctypes.c_double),  # joint_offset (J*3)
        ctypes.POINTER(ctypes.c_double),  # joint_rpy (J*3)
        ctypes.POINTER(ctypes.c_int),     # is_fixed (J)
        ctypes.POINTER(ctypes.c_double),  # com_offset ((J+1)*3)
        ctypes.POINTER(ctypes.c_double),  # link_mass (J+1)
        ctypes.c_char_p, ctypes.c_int,    # names out buffer
    ]
    max_j = 256
    parent = (ctypes.c_int * max_j)()
    joff = (ctypes.c_double * (max_j * 3))()
    jrpy = (ctypes.c_double * (max_j * 3))()
    fixed = (ctypes.c_int * max_j)()
    com = (ctypes.c_double * ((max_j + 1) * 3))()
    mass = (ctypes.c_double * (max_j + 1))()
    names_buf = ctypes.create_string_buffer(max_j * 64)
    n = lib.tip_urdf_parse(path.encode(), max_j, parent, joff, jrpy, fixed,
                           com, mass, names_buf, max_j * 64)
    if n <= 0:
        return None
    names = names_buf.value.decode().split(";")[:n]
    return UrdfSkeleton(
        joint_names=names,
        parent=np.frombuffer(parent, dtype=np.int32)[:n].copy(),
        joint_offset=np.frombuffer(joff, dtype=np.float64)[:n * 3].reshape(n, 3).copy(),
        joint_rpy=np.frombuffer(jrpy, dtype=np.float64)[:n * 3].reshape(n, 3).copy(),
        is_fixed=np.frombuffer(fixed, dtype=np.int32)[:n].astype(bool),
        com_offset=np.frombuffer(com, dtype=np.float64)[:(n + 1) * 3].reshape(n + 1, 3).copy(),
        link_mass=np.frombuffer(mass, dtype=np.float64)[:n + 1].copy(),
    )


def parse_urdf(path: str, prefer_native: bool = True) -> UrdfSkeleton:
    if prefer_native:
        res = _parse_native(path)
        if res is not None:
            return res
    return _parse_python(path)
