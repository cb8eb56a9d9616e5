"""The flagship trained checkpoint in this clone's git history, for the
trained-weight parity test (tests/test_torch_trained_weights.py) and the
drift report (scripts/torch_trained_drift.py): read with ``git archive``
into a temporary directory (never into the tree), restored with tip_tpu's
own restore, and run through tip_tpu's and the port's ``run_offline`` in
float64 over the first frames of an in-tree motion.

The caller has set JAX up as tests/conftest.py does (CPU, x64).
"""

import pickle
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import runner as JR
from tip_tpu.train import train as JT
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import runner as TR

ROOT = Path(__file__).resolve().parents[1]
COMMIT = "7879398"
CKPT = "artifacts/corpus_run_v2_repro/ckpt"
STEP = 389400
MOTION = ROOT / "artifacts" / "corpus_run_v3" / "corpus_extra" / \
    "freeform2_0000.pkl"
N_FRAMES = 300


def missing():
    """Why the checkpoint cannot be read here (git or the commit absent),
    or None."""
    if shutil.which("git") is None:
        return "git is not installed"
    have = subprocess.run(["git", "-C", str(ROOT), "cat-file", "-e",
                           f"{COMMIT}^{{commit}}"], capture_output=True)
    if have.returncode != 0:
        return f"commit {COMMIT} is not in this clone"
    return None


def extract_checkpoint(dest: Path) -> Path:
    """``git archive`` of the checkpoint's step directory into dest;
    returns the orbax directory (its parent)."""
    archive = subprocess.run(
        ["git", "-C", str(ROOT), "archive", COMMIT, f"{CKPT}/{STEP}"],
        capture_output=True, check=True)
    subprocess.run(["tar", "-x", "-C", str(dest)], input=archive.stdout,
                   check=True)
    return dest / CKPT


def config_from_checkpoint(ckpt_dir: Path) -> JM.ModelConfig:
    """The model config from the stored parameters' shapes (the head count
    is not in them: the paper's 16)."""
    import orbax.checkpoint as ocp
    with ocp.CheckpointManager(
            str(ckpt_dir),
            item_handlers=ocp.StandardCheckpointHandler()) as mngr:
        meta = mngr.item_metadata(STEP)
    p = getattr(meta, "tree", meta)["params"]
    size_s = p["out"]["b"].shape[0]
    in_dim, d = p["in_linear"]["w"].shape
    cfg = JM.ModelConfig(size_s=size_s, tf_in_dim=d,
                         tf_hid_size=p["layers"][0]["ff1"]["w"].shape[1],
                         tf_layers=len(p["layers"]),
                         rnn_hid_size=p["rnn"]["w_hh"].shape[0])
    with_sum = in_dim == JM.ModelConfig(size_s=size_s,
                                        with_acc_sum=True).input_dim
    return JM.ModelConfig(**{**vars(cfg), "with_acc_sum": with_sum})


def port_config(cfg: JM.ModelConfig) -> TM.ModelConfig:
    """The port's ModelConfig of the same widths (the port's defaults
    otherwise: the kernels' route)."""
    return TM.ModelConfig(**{k: getattr(cfg, k) for k in (
        "size_s", "with_acc_sum", "tf_in_dim", "tf_hid_size", "n_heads",
        "tf_layers", "rnn_hid_size")})


def load_trained(dest: Path):
    """(tip_tpu ModelConfig, parameters as numpy) of the checkpoint,
    extracted into dest."""
    ckpt_dir = extract_checkpoint(dest)
    cfg = config_from_checkpoint(ckpt_dir)
    params = JT.restore_checkpoint(str(ckpt_dir),
                                   JT.TrainConfig(model=cfg, n_sbps=5),
                                   params_only=True).params
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def load_motion():
    """(imu, s_init) of the motion's first N_FRAMES frames, float64."""
    with open(MOTION, "rb") as f:      # in-tree motion written by data gen
        d = pickle.load(f)
    return (np.asarray(d["imu"][:N_FRAMES], np.float64),
            np.asarray(d["nimble_qdq"][0], np.float64))


def run_both(cfg, params):
    """tip_tpu's and the port's run_offline (recompute; the port's plain
    path on the CPU) in float64 over the motion: (tip_tpu's outputs, the
    port's), each a list of numpy arrays (s_traj, c_traj, viz)."""
    imu, s_init = load_motion()
    p64 = jax.tree_util.tree_map(lambda p: p.astype(np.float64), params)
    j_out = JR.run_offline(p64, JR.RunnerConfig(model=cfg),
                           jkin.amass_skeleton(dtype=np.float64), s_init,
                           imu)
    tcfg = TR.RunnerConfig(model=port_config(cfg))
    model = TM.TIPModel(tcfg.model, device="cpu", dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(p64))
    t_out = TR.run_offline(model, tcfg,
                           tkin.amass_skeleton(dtype=torch.float64), s_init,
                           imu, device="cpu")
    return [np.asarray(a) for a in j_out], [a.numpy() for a in t_out]
