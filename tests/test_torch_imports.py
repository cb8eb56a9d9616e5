"""The port stands alone: no module of tip_tpu_torch, and not chip_smoke.py
or scripts/torch_k12_variants.py, imports JAX, Flax or tip_tpu; and its entry points run on CUDA unless the
caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from tip_tpu_torch import resolve_device
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import runner as TR
from tip_tpu_torch.runtime import streaming_cache as TSC
from tip_tpu_torch.runtime.serving import StreamPool
from tip_tpu_torch.train import train as TT
from tip_tpu_torch.cli import train as TCT

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tip_tpu")
PORT_FILES = sorted((ROOT / "tip_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_k12_variants.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_tip_tpu(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"tip_tpu_torch/runtime/runner.py", "tip_tpu_torch/ops/fused_rnn.py",
            "tip_tpu_torch/ops/fused_tail.py", "chip_smoke.py",
            "tip_tpu_torch/ops/fused_forward.py",
            "tip_tpu_torch/ops/metrics.py",
            "tip_tpu_torch/runtime/streaming_cache.py",
            "tip_tpu_torch/runtime/serving.py",
            "tip_tpu_torch/utils/urdf.py",
            "tip_tpu_torch/ops/hashmask.py",
            "tip_tpu_torch/ops/encoder_train.py",
            "tip_tpu_torch/train/train.py", "tip_tpu_torch/cli/train.py",
            "tip_tpu_torch/data_gen/combine.py",
            "tip_tpu_torch/data_gen/dip.py",
            "tip_tpu_torch/eval_harness.py",
            "tip_tpu_torch/eval_corruption.py",
            "tip_tpu_torch/cli/evaluate.py",
            "tip_tpu_torch/cli/import_torch_ckpt.py"} <= names


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")


def test_run_offline_without_device_raises_without_cuda():
    _no_cuda()
    cfg = TR.RunnerConfig(model=TM.ModelConfig(
        tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
        rnn_hid_size=24))
    model = TM.TIPModel(cfg.model, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.run_offline(model, cfg, tkin.amass_skeleton(), torch.zeros(114),
                       torch.zeros(8, 72))


@pytest.mark.parametrize("entry", ["model", "runner_init",
                                   "runner_init_kv_cache", "cache_init",
                                   "pool_init", "stream_pool", "resolve",
                                   "train_state", "train_loop", "cli_train"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "model":
            TM.TIPModel(TM.ModelConfig())
        elif entry == "runner_init":
            TR.runner_init(TR.RunnerConfig(), tkin.amass_skeleton(),
                           torch.zeros(114))
        elif entry == "runner_init_kv_cache":
            TR.runner_init(TR.RunnerConfig(serving_mode="kv_cache"),
                           tkin.amass_skeleton(), torch.zeros(114))
        elif entry == "cache_init":
            TSC.cache_init(TM.ModelConfig(), 40, batch=2)
        elif entry == "pool_init":
            TR.pool_init(TR.RunnerConfig(), tkin.amass_skeleton(),
                         torch.zeros(2, 114))
        elif entry == "stream_pool":
            cfg = TR.RunnerConfig(model=TM.ModelConfig(
                tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
                rnn_hid_size=24))
            StreamPool(TM.TIPModel(cfg.model, device="cpu"), cfg,
                       tkin.amass_skeleton(), capacity=2)
        elif entry == "train_state":
            TT.init_state(TT.TrainConfig())
        elif entry == "train_loop":
            TT.train_loop(TT.TrainConfig(), None)
        elif entry == "cli_train":
            TCT.main(["--data_prefix", str(_tiny_blobs(tmp_path)),
                      "--save_path", str(tmp_path / "run"),
                      "--with_acc_sum"])
        else:
            resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["evaluate", "cli_evaluate",
                                   "cli_import"])
def test_eval_entry_points_default_to_cuda(entry, tmp_path):
    """The evaluation harness and its CLIs run on cuda unless asked for
    the CPU (the harness's model is on the CPU here: the device is
    resolved before anything runs)."""
    from tip_tpu_torch import eval_harness as TH
    from tip_tpu_torch.cli import evaluate as TCE
    from tip_tpu_torch.cli import import_torch_ckpt as TCI
    _no_cuda()
    pt = tmp_path / "m.pt"
    torch.save({}, pt)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "evaluate":
            cfg = TR.RunnerConfig(model=TM.ModelConfig(
                tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
                rnn_hid_size=24))
            TH.evaluate(TM.TIPModel(cfg.model, device="cpu"),
                        TH.EvalConfig(runner=cfg), [])
        elif entry == "cli_evaluate":
            TCE.main(["--ckpt", str(pt), "--data_root", str(tmp_path)])
        else:
            TCI.main(["--pt", str(pt), "--out", str(tmp_path / "o")])


def _tiny_blobs(d):
    """A prefix of blobs that exist (the CLI loads them before it trains)."""
    import numpy as np
    for name, shape in (("imu", (50, 72)), ("sum_imu", (50, 18)),
                        ("s", (50, 131))):
        np.save(d / f"b_{name}.npy", np.zeros(shape, np.float32))
    np.save(d / "b_info.npy", np.array([[0, 50, 1]], np.int64))
    return d / "b"


def test_runner_rejects_model_on_another_device():
    model = TM.TIPModel(TM.ModelConfig(tf_in_dim=32, tf_hid_size=64,
                                       n_heads=4, tf_layers=2,
                                       rnn_hid_size=24), device="cpu")
    cfg = TR.RunnerConfig(model=model.cfg)
    with pytest.raises(ValueError, match="meta"):
        TR.run_offline(model, cfg, tkin.amass_skeleton(), torch.zeros(114),
                       torch.zeros(8, 72), device="meta")
