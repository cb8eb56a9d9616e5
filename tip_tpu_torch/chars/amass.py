"""AMASS humanoid character index tables — pure data.

Copy of the tables of tip_tpu/chars/amass.py that the streaming path uses.
Joint indices follow the URDF file order (= PyBullet link order), root = -1.
"""

import numpy as np

JOINT_NAMES = (
    "lhip", "lknee", "lankle",
    "rhip", "rknee", "rankle",
    "lowerback", "upperback", "chest", "lowerneck", "upperneck",
    "lclavicle", "lshoulder", "lelbow", "lwrist",
    "rclavicle", "rshoulder", "relbow", "rwrist",
)

# fixed (weld) joints — the wrists carry IMUs but have no DoF
FIXED_JOINTS = (14, 18)

_JID = {n: i for i, n in enumerate(JOINT_NAMES)}

# bullet joint index -> nimble *state* index; fixed joints -> -1
NIMBLE_STATE_MAP = {
    -1: 0,
    _JID["lhip"]: 1, _JID["lknee"]: 2, _JID["lankle"]: 3,
    _JID["lowerback"]: 4, _JID["upperback"]: 5, _JID["chest"]: 6,
    _JID["lclavicle"]: 7, _JID["lshoulder"]: 8, _JID["lelbow"]: 9,
    _JID["lowerneck"]: 10, _JID["upperneck"]: 11,
    _JID["rclavicle"]: 12, _JID["rshoulder"]: 13, _JID["relbow"]: 14,
    _JID["rhip"]: 15, _JID["rknee"]: 16, _JID["rankle"]: 17,
    _JID["lwrist"]: -1, _JID["rwrist"]: -1,
}

# actuated (spherical) joints, excluding root and the fixed wrists
NON_ROOT_ACTIVE_IDX = np.array(
    [i for i in range(len(JOINT_NAMES)) if i not in FIXED_JOINTS], np.int64)

# for each active joint (bullet order), the nimble-state aa slot
BULLET_FROM_NIMBLE_GATHER = np.array(
    [NIMBLE_STATE_MAP[int(i)] - 1 for i in NON_ROOT_ACTIVE_IDX], np.int64)

# IMU sensor placement, bullet joint indices. Order defines the 6x(9+3)
# feature layout: [root, lwrist, rwrist, lknee, rknee, upperneck] (the
# knee-IMU variant); the ankle-IMU variant below
IMU_JOINTS_KNEE = (-1, _JID["lwrist"], _JID["rwrist"], _JID["lknee"],
                   _JID["rknee"], _JID["upperneck"])
IMU_JOINTS_ANKLE = (-1, _JID["rankle"], _JID["lankle"], _JID["lwrist"],
                    _JID["rwrist"], _JID["upperneck"])

# SBP-constrained links, order defines the n_sbps*4 label layout
SBP_LINKS = (_JID["lankle"], _JID["rankle"], _JID["lwrist"], _JID["rwrist"],
             -1)

# IK chains: sbp name -> [parent, a, b, c] bullet links
IK_CHAIN_BULLET = {
    "lankle": (-1, 0, 1, 2),
    "rankle": (-1, 3, 4, 5),
    "lwrist": (11, 12, 13, 14),
    "rwrist": (15, 16, 17, 18),
}
# limb joints whose angles IK rewrites, nimble-state indices
IK_CHAIN_NIMBLE = {
    "lankle": (1, 2, 3),
    "rankle": (15, 16, 17),
    "lwrist": (8, 9),
    "rwrist": (13, 14),
}
