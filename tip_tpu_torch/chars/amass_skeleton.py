"""AMASS humanoid skeleton geometry as data (copy of
tip_tpu/chars/amass_skeleton.py).

Index order = chars.amass.JOINT_NAMES:
 0 lhip  1 lknee  2 lankle  3 rhip  4 rknee  5 rankle  6 lowerback
 7 upperback  8 chest  9 lowerneck 10 upperneck 11 lclavicle 12 lshoulder
13 lelbow 14 lwrist(fixed) 15 rclavicle 16 rshoulder 17 relbow 18 rwrist(fixed)
"""

import numpy as np

# parent joint index per joint (-1 = root link)
PARENT = np.array(
    [-1, 0, 1, -1, 3, 4, -1, 6, 7, 8, 9, 8, 11, 12, 13, 8, 15, 16, 17],
    dtype=np.int32)

# joint origin xyz in the parent link frame
JOINT_OFFSET = np.array([
    [0.08858, -0.08228, -0.01766],   # lhip      <- root
    [0.04345, -0.35647, 0.00804],    # lknee     <- lhip
    [-0.01479, -0.42687, -0.03743],  # lankle    <- lknee
    [-0.09031, -0.09051, -0.01354],  # rhip      <- root
    [-0.04326, -0.35369, -0.00484],  # rknee     <- rhip
    [0.01906, -0.42005, -0.03456],   # rankle    <- rknee
    [0.0, 0.1244, -0.03],            # lowerback <- root
    [0.0, 0.13796, 0.02682],         # upperback <- lowerback
    [0.0, 0.05603, 0.00285],         # chest     <- upperback
    [0.0, 0.15524, -0.03347],        # lowerneck <- chest
    [0.0, 0.08894, 0.02041],         # upperneck <- lowerneck
    [0.0717, 0.114, -0.0189],        # lclavicle <- chest
    [0.09, 0.0, 0.0],                # lshoulder <- lclavicle
    [0.26, 0.0, 0.0],                # lelbow    <- lshoulder
    [0.24, 0.0, 0.0],                # lwrist    <- lelbow (fixed)
    [-0.08295, 0.11247, -0.02371],   # rclavicle <- chest
    [-0.09, 0.0, 0.0],               # rshoulder <- rclavicle
    [-0.26, 0.0, 0.0],               # relbow    <- rshoulder
    [-0.24, 0.0, 0.0],               # rwrist    <- relbow (fixed)
])

IS_FIXED = np.zeros(19, dtype=bool)
IS_FIXED[[14, 18]] = True

# inertial (CoM / IMU mount) origin per link, root first
COM_OFFSET = np.array([
    [0.0, 0.0, 0.0],                 # root
    [0.02173, -0.19323, 0.00402],    # lhip
    [0.00, -0.05, 0.02],             # lknee (IMU)
    [0.01719, -0.06032, 0.05617],    # lankle
    [-0.02163, -0.19184, -0.00242],  # rhip
    [0.0, -0.05, 0.02],              # rknee (IMU)
    [-0.01719, -0.06032, 0.05617],   # rankle
    [0.0, 0.05, 0.013],              # lowerback
    [0.0, 0.02246, 0.00143],         # upperback
    [0.0, 0.057, -0.00687],          # chest
    [0.0, -0.01296, 0.01],           # lowerneck
    [0.0, 0.15, 0.0],                # upperneck (head IMU)
    [0.06146, 0.0226, -0.00952],     # lclavicle
    [0.12767, 0.0, 0.0],             # lshoulder
    [0.12285, 0.0, 0.0],             # lelbow
    [0.01, 0.03, 0.0],               # lwrist (IMU)
    [-0.05661, 0.02343, -0.00424],   # rclavicle
    [-0.13006, 0.0, 0.0],            # rshoulder
    [-0.12455, 0.0, 0.0],            # relbow
    [-0.01, 0.03, 0.0],              # rwrist (IMU)
])

LINK_MASS = np.array([
    5.0, 5.0, 3.0, 1.0, 5.0, 3.0, 1.0, 5.0, 5.0, 8.0, 0.5, 3.0,
    1.0, 2.0, 1.0, 0.5, 1.0, 2.0, 1.0, 0.5,
])
