"""Global pipeline constants (copy of tip_tpu/constants.py's values).

These values define the wire/data formats (60 Hz IMU streams, 40-frame
windows, 57-DoF pose vectors) that the pipeline is built around.
"""

# Stream timing
DT = 1.0 / 60.0
ACC_FD_N = 4                       # central-difference half window for synth acc
DT_FIN_ACC = DT * ACC_FD_N

# Synthetic-IMU generation
ROOT_COM_OFFSET = (0.0, 0.1, -0.1)  # root IMU mount point, root-local
NOMINAL_H = 1.7                    # nominal body height (m)
V_THRES = 0.15                     # SBP residue acceptance threshold

# IMU pre-processing
IMU_N_SMOOTH = 5                   # centered moving average half window
ACC_MOVING_AVE_LEN = IMU_N_SMOOTH * 2 + 1      # 11-frame window
ACC_SUM_WIN_LEN = 40               # running acc-sum feature window
ACC_SUM_DOWN_SCALE = 15.0          # scale acc-sum to the range of acc itself
BIAS_NOISE_ACC = 0.1               # constant per-sequence acc bias noise (train)

# Frame conventions: rot_up rotates the SMPL y-up body frame into the
# z-up world frame
ROT_UP_Q = (0.5, 0.5, 0.5, 0.5)     # xyzw
ROOT_Z_OFFSET = 0.95
N_DOFS = 57                        # 3 root xyz + 3 root aa + 17*3 joint aa

# Terrain grid
MAP_BOUND = 5.0
GRID_SIZE = 0.1
GRID_NUM = int(MAP_BOUND / GRID_SIZE) * 2

# Model I/O geometry
N_IMUS = 6
IMU_DIM = N_IMUS * (9 + 3)         # 72: 6 sensors x (3x3 rot + 3 acc)
ACC_SUM_DIM = 18                   # 6 sensors x 3
N_JOINTS_MODEL = 18                # root + 17 actuated joints predicted as 6D
ROOT_V_DIM = 3
SBP_DIM = 4                        # (flag, offset xyz)

# SMPL joint naming. The model does not predict toe/wrist/hand joints; 6
# IMUs are not informative enough for them.
SMPL_JOINTS = (
    "root", "lhip", "rhip", "lowerback", "lknee", "rknee", "upperback",
    "lankle", "rankle", "chest", "ltoe", "rtoe", "lowerneck", "lclavicle",
    "rclavicle", "upperneck", "lshoulder", "rshoulder", "lelbow", "relbow",
    "lwrist", "rwrist", "lhand", "rhand",
)
SMPL_JOINT_IDX = {n: i for i, n in enumerate(SMPL_JOINTS)}


def state_dim(n_sbps: int) -> int:
    """Width of the model's per-frame output/history state vector."""
    return N_JOINTS_MODEL * 6 + ROOT_V_DIM + n_sbps * SBP_DIM
