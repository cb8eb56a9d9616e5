"""The port's streaming runner as a whole against tip_tpu's.

tip_tpu_torch.runtime.runner.run_offline on the CPU (plain path: the
wrappers run the kernels' plain versions for CPU tensors) and
tip_tpu.runtime.runner.run_offline (XLA path) stream the same recorded
motion through the same weights in float64; trajectories agree to 1e-8.
"""

import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import runner as JR
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import runner as TR

torch.set_num_threads(1)

MOTION = (Path(__file__).resolve().parents[1] / "artifacts" / "corpus_run_v3"
          / "corpus_extra" / "freeform2_0000.pkl")
N_FRAMES = 120
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)


@pytest.fixture(scope="module")
def stream():
    with open(MOTION, "rb") as f:      # in-tree motion written by data gen
        d = pickle.load(f)
    return (np.asarray(d["imu"][:N_FRAMES], np.float64),
            np.asarray(d["nimble_qdq"][0], np.float64))


@pytest.fixture(scope="module")
def runs(stream):
    imu, s_init = stream
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**TINY))
    params = jax.tree_util.tree_map(
        lambda p: p.astype(np.float64),
        JM.init_params(jax.random.PRNGKey(0), jcfg.model))
    j_out = JR.run_offline(params, jcfg, jkin.amass_skeleton(dtype=np.float64),
                           s_init, imu)
    tcfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY))
    model = TM.TIPModel(tcfg.model, device="cpu", dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    t_out = TR.run_offline(model, tcfg,
                           tkin.amass_skeleton(dtype=torch.float64),
                           s_init, imu, device="cpu")
    return ([np.asarray(a) for a in j_out], [a.numpy() for a in t_out])


@pytest.mark.parametrize("i,name", [(0, "s_traj"), (1, "c_traj"),
                                    (2, "viz")])
def test_run_offline_matches_tip_tpu(runs, i, name):
    j, t = runs[0][i], runs[1][i]
    assert t.shape == j.shape, name
    # both paths are the same f64 arithmetic in another order
    np.testing.assert_allclose(t, j, atol=1e-8, rtol=0, err_msg=name)


def test_run_offline_two_sbps_matches_tip_tpu(stream):
    """The feet-only layout (2 SBPs, size_s 119), which K3 does not take,
    runs the plain tail on the CPU; it matches tip_tpu's too."""
    imu, s_init = stream
    kw = dict(TINY, size_s=119)
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**kw), n_sbps=2)
    params = jax.tree_util.tree_map(
        lambda p: p.astype(np.float64),
        JM.init_params(jax.random.PRNGKey(1), jcfg.model))
    j_out = JR.run_offline(params, jcfg, jkin.amass_skeleton(dtype=np.float64),
                           s_init, imu[:60])
    tcfg = TR.RunnerConfig(model=TM.ModelConfig(**kw), n_sbps=2)
    model = TM.TIPModel(tcfg.model, device="cpu", dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    t_out = TR.run_offline(model, tcfg,
                           tkin.amass_skeleton(dtype=torch.float64),
                           s_init, imu[:60], device="cpu")
    for j, t in zip(j_out, t_out):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-8,
                                   rtol=0)


def test_run_offline_has_active_sbps(runs):
    """The stream exercises the SBP paths: some flags set, so viz holds
    real positions and the z fix runs."""
    c = runs[1][1]
    assert (c[:, 0::4] > 0.5).any()
    assert (np.abs(runs[1][2]) < 100.0).any()


def test_trim_latency_matches_tip_tpu(runs):
    s = runs[1][0]
    np.testing.assert_array_equal(TR.trim_latency(s, 7),
                                  JR.trim_latency(s, 7))
    out = TR.trim_latency(s, 7)
    np.testing.assert_array_equal(out[:-7], s[7:])
    np.testing.assert_array_equal(out[-7:], np.repeat(s[-1:], 7, axis=0))


def test_warmup_frames_return_s_init(runs, stream):
    """Frames before the first smoothed IMU frame run no model."""
    s = runs[1][0]
    for t in range(1, 6):
        np.testing.assert_array_equal(s[t], stream[1])
    assert not np.array_equal(s[6], stream[1])


@pytest.mark.parametrize("kw,err", [
    (dict(serving_mode="kv_cache"), NotImplementedError),
    (dict(model=TM.ModelConfig(forward_impl="fused")), NotImplementedError),
    (dict(tail_impl="xla"), ValueError),
    (dict(n_sbps=2, tail_impl="fused"), ValueError),
])
def test_runner_config_rejects_unported(kw, err):
    with pytest.raises(err):
        TR.RunnerConfig(**kw)


class _OnCard:
    """Stands in for a CUDA tensor: the kernel-or-plain choice reads only
    ``is_cuda``."""
    is_cuda = True


def test_tail_impl_auto_resolution():
    """'auto' is the kernel for a CUDA tensor whatever the SBP count (K3's
    wrapper then raises for n_sbps != 5) and the plain version for a CPU
    tensor; 'plain' is plain everywhere."""
    cpu, card = torch.zeros(1), _OnCard()
    for option, explicit in (("tail_impl", "fused"), ("rnn_impl", "kernel")):
        assert not K.use_kernel("auto", cpu, option, explicit)
        assert K.use_kernel("auto", card, option, explicit)
        assert K.use_kernel(explicit, card, option, explicit)
        assert not K.use_kernel("plain", card, option, explicit)
        assert not K.use_kernel("plain", cpu, option, explicit)
        with pytest.raises(ValueError, match="CUDA"):
            K.use_kernel(explicit, cpu, option, explicit)
        with pytest.raises(ValueError, match="auto"):
            K.use_kernel("xla", cpu, option, explicit)


def test_run_offline_auto_four_sbps_on_cpu_runs_plain(stream):
    """A CUDA-less 'auto' run with another SBP count than K3's 5 takes the
    plain versions: no launch, and the same trajectory as 'plain'."""
    imu, s_init = stream
    kw = dict(TINY, size_s=127)
    outs = []
    for rnn_impl, tail_impl in (("auto", "auto"), ("plain", "plain")):
        cfg = TR.RunnerConfig(model=TM.ModelConfig(**kw, rnn_impl=rnn_impl),
                              n_sbps=4, tail_impl=tail_impl)
        model = TM.TIPModel(cfg.model, device="cpu",
                            generator=torch.Generator().manual_seed(2))
        K.reset_launch_counts()
        outs.append(TR.run_offline(model, cfg, tkin.amass_skeleton(), s_init,
                                   imu[:30], device="cpu"))
        assert sum(K.launch_counts.values()) == 0
    for a, p in zip(*outs):
        assert torch.isfinite(a).all()
        assert torch.equal(a, p)


@pytest.mark.parametrize("impl", ["rnn", "tail"])
def test_explicit_kernel_on_cpu_raises(stream, impl):
    """An explicit kernel request on CPU tensors raises, never falls back."""
    imu, s_init = stream
    mcfg = TM.ModelConfig(**TINY, rnn_impl="kernel" if impl == "rnn"
                          else "auto")
    cfg = TR.RunnerConfig(model=mcfg,
                          tail_impl="fused" if impl == "tail" else "auto")
    model = TM.TIPModel(mcfg, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        TR.run_offline(model, cfg, tkin.amass_skeleton(), s_init, imu[:8],
                       device="cpu")


def test_run_offline_checks_model_config(stream):
    imu, s_init = stream
    model = TM.TIPModel(TM.ModelConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="ModelConfig"):
        TR.run_offline(model, TR.RunnerConfig(), tkin.amass_skeleton(),
                       s_init, imu[:8], device="cpu")
