"""A model that requires grad (a training state's model, as
``train_loop`` and ``restore_checkpoint`` return it) serves as it is, on
the CPU in float64: ``runner_step`` (recompute and ``kv_cache``) and
``pool_step`` run without autograd, their outputs and carries need no
gradient and equal the same model's with ``requires_grad_(False)`` to
1e-12. ``TIPModel.forward`` with grad on trains through the RNN head's
differentiable wrapper (``fused_rnn_train``: K1 forward, K10 backward on
the card), with the values of the inference forward and the gradient of
the plain recurrence. ``cli.train`` accepts tip_tpu's ``--device_data``.
"""

import copy
import dataclasses
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from tip_tpu_torch.cli import combine_data as TCC
from tip_tpu_torch.cli import train as TCT
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import fused_rnn as FR
from tip_tpu_torch.ops import fused_tail as FT
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import runner as TR
from tip_tpu_torch.train import train as TT

torch.set_num_threads(1)

CORPUS = (Path(__file__).resolve().parents[1] / "artifacts" / "corpus_run_v3"
          / "corpus_extra")
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
FRAMES = 50                    # past the warm-up and the window's slide
TOL = 1e-12


def _motion(i):
    with open(CORPUS / f"freeform2_{i:04d}.pkl", "rb") as f:
        d = pickle.load(f)         # in-tree motion written by data gen
    return (np.asarray(d["imu"][:FRAMES], np.float64),
            np.asarray(d["nimble_qdq"][0], np.float64))


def _models():
    """A training state's model (requires grad) and a detached copy."""
    cfg = TT.TrainConfig(model=TM.ModelConfig(**TINY), batch_size=4,
                         seq_len=10)
    live = TT.init_state(cfg, "cpu", dtype=torch.float64).model
    assert all(p.requires_grad for p in live.parameters())
    return live, copy.deepcopy(live).requires_grad_(False)


@pytest.fixture
def detached_kernel_inputs(monkeypatch):
    """The kernel wrappers on these paths (K1, K2, K3) take only tensors
    that need no gradient, as their CUDA launches do (a CPU tensor runs
    the plain version and would not show it): hold the CPU run to it."""
    def guard(fn):
        def wrapped(*args, **kwargs):
            for a in (*args, *kwargs.values()):
                assert not (isinstance(a, torch.Tensor) and a.requires_grad)
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(TM, "fused_rnn", guard(TM.fused_rnn))
    for name in ("decode_fused", "tail_fused"):
        monkeypatch.setattr(FT, name, guard(getattr(FT, name)))


def _leaves(carry):
    """The tensors of a runner or pool carry, its cache's included."""
    out = {}
    for f in dataclasses.fields(carry):
        v = getattr(carry, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif f.name == "cache" and v is not None:
            for g in dataclasses.fields(v):
                out["cache." + g.name] = getattr(v, g.name)
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert not a[k].requires_grad, k
        assert torch.equal(torch.isnan(a[k]), torch.isnan(b[k])), k
        if a[k].dtype == torch.bool:
            assert torch.equal(a[k], b[k]), k
            continue
        err = (a[k] - b[k]).nan_to_num().abs().max().item() if (
            a[k].numel()) else 0.0
        assert err <= TOL, (k, err)


@pytest.mark.parametrize("mode", ["recompute", "kv_cache"])
def test_runner_step_serves_a_model_that_requires_grad(
        mode, detached_kernel_inputs):
    live, frozen = _models()
    cfg = TR.RunnerConfig(model=live.cfg, serving_mode=mode)
    skel = tkin.amass_skeleton(dtype=torch.float64)
    imu, s_init = _motion(0)
    carries = [TR.runner_init(cfg, skel, s_init, dtype=torch.float64,
                              device="cpu") for _ in range(2)]
    for t in range(FRAMES):
        outs = []
        for i, model in enumerate((live, frozen)):
            carries[i], o = TR.runner_step(model, carries[i], imu[t], cfg,
                                           skel)
            outs.append(o)
        _assert_same(*outs)
        _assert_same(*(_leaves(c) for c in carries))
    assert carries[0].n_out == FRAMES - cfg.imu_n_smooth


@pytest.mark.parametrize("mode", ["recompute", "kv_cache"])
def test_pool_step_serves_a_model_that_requires_grad(
        mode, detached_kernel_inputs):
    live, frozen = _models()
    cfg = TR.RunnerConfig(model=live.cfg, serving_mode=mode)
    skel = tkin.amass_skeleton(dtype=torch.float64)
    streams = [_motion(i) for i in range(2)]
    imu = np.stack([m[0] for m in streams], axis=1)       # (T, 2, 72)
    s_inits = np.stack([m[1] for m in streams])
    carries = [TR.pool_init(cfg, skel, s_inits, dtype=torch.float64,
                            device="cpu") for _ in range(2)]
    for t in range(FRAMES):
        outs = []
        for i, model in enumerate((live, frozen)):
            carries[i], o = TR.pool_step(model, carries[i], imu[t], cfg,
                                         skel, tick=t)
            outs.append(o)
        _assert_same(*outs)
        _assert_same(*(_leaves(c) for c in carries))


def _graph_has(t, name):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == name:
            return True
        todo.extend(f for f, _ in fn.next_functions)
    return False


def test_forward_with_grad_trains_through_fused_rnn_train(monkeypatch):
    live, _ = _models()
    rng = np.random.default_rng(3)
    x_imu = torch.as_tensor(rng.normal(size=(3, 12, live.cfg.input_dim
                                              - live.cfg.size_s)))
    x_s = torch.as_tensor(rng.normal(size=(3, 12, live.cfg.size_s)) * 0.3)
    g = torch.as_tensor(rng.normal(size=(3, 12, live.cfg.size_s)))
    with torch.no_grad():
        y_ref = live(x_imu, x_s)
    y = live(x_imu, x_s)
    assert _graph_has(y, "_FusedRNNTrainBackward")
    assert (y - y_ref).abs().max().item() <= TOL
    params = list(live.parameters())
    grads = torch.autograd.grad(y, params, g)
    # the reference: autograd through the plain recurrence
    monkeypatch.setattr(TM, "fused_rnn_train",
                        lambda xin, w, impl: FR.fused_rnn_plain(xin, w))
    y_plain = live(x_imu, x_s)
    assert not _graph_has(y_plain, "_FusedRNNTrainBackward")
    ref = torch.autograd.grad(y_plain, params, g)
    # held to the largest entry of all: b_k's gradient is 0 in exact
    # arithmetic (softmax ignores a constant per row)
    scale = max(b.abs().max().item() for b in ref)
    for (name, _), a, b in zip(live.named_parameters(), grads, ref):
        assert (a - b).abs().max().item() <= 1e-12 * scale, name
    assert grads[[n for n, _ in live.named_parameters()].index(
        "rnn.w_hh")].abs().max().item() > 0


def test_cli_train_accepts_device_data(tmp_path):
    TCC.main(["--data_root", str(CORPUS.parent), "--datasets",
              "corpus_extra", "--rates", "60", "--name_contains",
              "freeform2_0000", "--out_prefix", str(tmp_path / "d")])
    state = TCT.main([
        "--data_prefix", str(tmp_path / "d"), "--save_path",
        str(tmp_path / "run"), "--batch_size", "8", "--seq_len", "10",
        "--epochs", "1", "--with_acc_sum", "--tf_in_dim", "32",
        "--tf_nhid", "64", "--n_heads", "4", "--tf_layers", "2",
        "--rnn_nhid", "24", "--device_data", "--device", "cpu"])
    assert state.step > 0
    assert os.path.exists(tmp_path / "run" / "ckpt_1.pt")
