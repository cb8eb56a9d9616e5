"""The port stands alone: no module of tip_tpu_torch, and not chip_smoke.py,
scripts/torch_k12_variants.py, scripts/torch_train_convergence.py, the
four-card mesh scripts scripts/torch_mesh_cards.py and
scripts/torch_mesh_convergence.py, the pools at tip_tpu's sizes
scripts/torch_pool_sizes.py and the churn soak scripts/torch_soak_pool.py,
the full-runner soak scripts/torch_soak.py, the end-to-end demo
scripts/torch_e2e_synthetic_demo.py and the corruption sweep
scripts/torch_eval_corruption.py, the
wire helper tests/torch_wire.py that chip_smoke.py imports or the mesh's
test worker tests/torch_mesh_worker.py, imports JAX,
Flax or tip_tpu, nor orbax, tensorstore or zstandard (the port reads
tip_tpu's checkpoints with a reader of its own); and its entry points run
on CUDA unless the caller asks for the CPU."""

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
FORBIDDEN = ("jax", "jaxlib", "flax", "tip_tpu", "orbax", "tensorstore",
             "zstandard")
PORT_FILES = sorted((ROOT / "tip_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_k12_variants.py",
     ROOT / "scripts" / "torch_train_convergence.py",
     ROOT / "scripts" / "torch_mesh_cards.py",
     ROOT / "scripts" / "torch_mesh_convergence.py",
     ROOT / "scripts" / "torch_pool_sizes.py",
     ROOT / "scripts" / "torch_soak_pool.py",
     ROOT / "scripts" / "torch_soak.py",
     ROOT / "scripts" / "torch_e2e_synthetic_demo.py",
     ROOT / "scripts" / "torch_eval_corruption.py",
     ROOT / "tests" / "torch_wire.py", ROOT / "tests" / "torch_mesh_worker.py"]
# the serving daemon, live I/O and data generation from SMPL motions
SERVING_AND_DATAGEN = (
    "tip_tpu_torch/runtime/calibration.py",
    "tip_tpu_torch/runtime/imu_client.py",
    "tip_tpu_torch/utils/observability.py",
    "tip_tpu_torch/runtime/serve_daemon.py",
    "tip_tpu_torch/cli/serve.py", "tip_tpu_torch/cli/live_demo.py",
    "tip_tpu_torch/ops/sbp.py", "tip_tpu_torch/data_gen/smpl.py",
    "tip_tpu_torch/data_gen/amass_syn.py", "tip_tpu_torch/data_gen/dip.py",
    "tip_tpu_torch/cli/preprocess_dip.py", "tip_tpu_torch/cli/gen_data.py",
    "tests/torch_wire.py")
# the convergence recipe: the procedural corpus, the epoch function and its
# sampler, the xla loop and the rng masks, the recipe's script
CONVERGENCE_RECIPE = (
    "tip_tpu_torch/data_gen/corpus.py", "tip_tpu_torch/train/data.py",
    "tip_tpu_torch/train/train.py", "tip_tpu_torch/models/tip_model.py",
    "tip_tpu_torch/cli/train.py", "scripts/torch_train_convergence.py")
# the orbax reader and the last single-device modules (ROADMAP A6, A7)
ORBAX_AND_A7 = (
    "tip_tpu_torch/utils/orbax_read.py", "tip_tpu_torch/ops/dynamics.py",
    "tip_tpu_torch/utils/seeding.py", "tip_tpu_torch/viz/plots.py",
    "tip_tpu_torch/viz/skeleton_render.py",
    "tip_tpu_torch/viz/urdf_export.py", "tip_tpu_torch/viz/pybullet_viz.py",
    "tip_tpu_torch/cli/render.py", "tip_tpu_torch/cli/evaluate.py",
    "tip_tpu_torch/cli/live_demo.py")
# the (data, model) mesh (ROADMAP A6, the last module) and its test worker,
# which runs in processes of its own beside the tests that import JAX
MESH = ("tip_tpu_torch/parallel/__init__.py", "tip_tpu_torch/parallel/mesh.py",
        "tests/torch_mesh_worker.py")
# the mesh across four cards over NCCL (path Z) and the twin of
# scripts/mesh_convergence.py
MESH_CARDS = ("scripts/torch_mesh_cards.py",
              "scripts/torch_mesh_convergence.py")
# tip_tpu's throughput rows on the card and the churn soak's twin
POOL_SIZES = ("scripts/torch_pool_sizes.py", "scripts/torch_soak_pool.py")
# the last three scripts of tip_tpu's surface: the full-runner soak,
# synthesize -> train -> evaluate, and the corruption sweep
LAST_DRIVERS = ("scripts/torch_soak.py", "scripts/torch_e2e_synthetic_demo.py",
                "scripts/torch_eval_corruption.py")


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


@pytest.mark.parametrize("name", SERVING_AND_DATAGEN + CONVERGENCE_RECIPE
                         + ORBAX_AND_A7 + MESH + MESH_CARDS + POOL_SIZES
                         + LAST_DRIVERS)
def test_serving_and_datagen_files_are_checked(name):
    """Each module of the serving daemon, live I/O and data generation is
    among the files checked above, and imports no JAX and nothing of
    tip_tpu."""
    assert ROOT / name in PORT_FILES, name
    bad = sorted(set(_imported_roots(ROOT / name)) & set(FORBIDDEN))
    assert not bad, f"{name} imports {bad}"


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


@pytest.mark.parametrize("entry", ["synthesize", "nimble_qdq", "cli_serve",
                                   "cli_live_demo", "cli_gen_data",
                                   "cli_preprocess_dip"])
def test_serving_and_datagen_entry_points_default_to_cuda(entry, tmp_path):
    """Data generation and the serving CLIs run on cuda unless asked for
    the CPU: each resolves its device before it runs anything."""
    import numpy as np
    from tip_tpu_torch.cli import gen_data, live_demo, preprocess_dip, serve
    from tip_tpu_torch.data_gen import amass_syn, smpl
    _no_cuda()
    pt = str(tmp_path / "m.pt")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "synthesize":
            amass_syn.synthesize(smpl.SmplMotion(
                np.zeros((40, 24, 3)), np.zeros((40, 3)), 60.0), height=1.7)
        elif entry == "nimble_qdq":
            amass_syn.nimble_qdq(np.zeros((4, 24, 3)), np.zeros((4, 3)))
        elif entry == "cli_serve":
            serve.main(["--ckpt", pt, "--port", "0"])
        elif entry == "cli_live_demo":
            live_demo.main(["--ckpt", pt, "--port", "0"])
        elif entry == "cli_gen_data":
            gen_data.main(["--src_dir", str(tmp_path),
                           "--save_dir", str(tmp_path / "o")])
        else:
            preprocess_dip.main(["--dip", "--src_dir", str(tmp_path),
                                 "--save_dir", str(tmp_path / "o")])


@pytest.mark.parametrize("entry", ["generate_corpus", "window_sampler",
                                   "convergence_script"])
def test_convergence_recipe_entry_points_default_to_cuda(entry, tmp_path):
    """The corpus, the on-device sampler and the recipe's script run on
    cuda unless asked for the CPU: each resolves its device first."""
    import importlib.util
    import numpy as np
    from tip_tpu_torch.data_gen import corpus
    from tip_tpu_torch.train import data as TD
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "generate_corpus":
            corpus.generate_corpus(str(tmp_path), 1)
        elif entry == "window_sampler":
            TD.make_window_sampler(np.array([[0, 60, 1]]), 10)
        else:
            spec = importlib.util.spec_from_file_location(
                "torch_train_convergence",
                ROOT / "scripts" / "torch_train_convergence.py")
            script = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(script)
            script.main(["--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


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
