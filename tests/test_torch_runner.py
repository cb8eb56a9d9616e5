"""The port's streaming runner as a whole against tip_tpu's.

tip_tpu_torch.runtime.runner.run_offline on the CPU (plain path: the
wrappers run the kernels' plain versions for CPU tensors) and
tip_tpu.runtime.runner.run_offline (XLA path) stream the same recorded
motion through the same weights in float64; trajectories agree to 1e-8.

The opt-in paths run in float32 as tip_tpu's own tests run them:
``forward_impl="fused"`` against tip_tpu's fused runner while the window
grows (tip_tpu's returns the bare output bias once it slides) and against
the port's plain path past the slide; ``fk_impl`` with the plain tail
against tip_tpu's ``fk_impl="pallas"``.
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


@pytest.mark.parametrize("filter_len", [17, 20])
def test_run_offline_long_filter_matches_tip_tpu(stream, filter_len):
    """An output filter longer than one chunk of K2's sum (16 rows), which
    tip_tpu takes at any length: the port's runner matches it on the CPU
    (K2's plain version) once the filter is on."""
    imu, s_init = stream
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**TINY),
                           filter_len=filter_len)
    params = jax.tree_util.tree_map(
        lambda p: p.astype(np.float64),
        JM.init_params(jax.random.PRNGKey(2), jcfg.model))
    j_out = JR.run_offline(params, jcfg, jkin.amass_skeleton(dtype=np.float64),
                           s_init, imu[:40])
    tcfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY),
                           filter_len=filter_len)
    model = TM.TIPModel(tcfg.model, device="cpu", dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    t_out = TR.run_offline(model, tcfg,
                           tkin.amass_skeleton(dtype=torch.float64),
                           s_init, imu[:40], device="cpu")
    for j, t in zip(j_out, t_out):
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
    (dict(serving_mode="paged"), ValueError),
    (dict(serving_mode="kv_cache"), None),
    (dict(serving_mode="kv_cache_rnn_carry",
          model=TM.ModelConfig(forward_impl="fused",
                               compute_dtype="bfloat16")), None),
    (dict(model=TM.ModelConfig(forward_impl="fused")), None),
    (dict(tail_impl="xla"), ValueError),
    (dict(n_sbps=2, tail_impl="fused"), ValueError),
    (dict(fk_impl="pallas"), ValueError),
    (dict(fk_impl="kernel"), ValueError),          # needs tail_impl="plain"
    (dict(fk_impl="auto", tail_impl="fused"), ValueError),
    (dict(fk_impl="kernel", tail_impl="plain"), None),
])
def test_runner_config_rejects_unported(kw, err):
    """Unknown values raise (an unknown serving mode with ValueError); the
    KV-cache modes, the fused forward and the FK kernel of the plain tail
    are accepted. The packing dtype is ``compute_dtype``, else bfloat16 for
    the windowed forward and the carry's dtype for the cached modes."""
    if err is None:
        cfg = TR.RunnerConfig(**kw)
        assert cfg.cached == (cfg.serving_mode != "recompute")
        want = torch.float32 if kw.get("serving_mode") == "kv_cache" \
            else torch.bfloat16
        assert TR.pack_dtype(cfg) == want
        return
    with pytest.raises(err):
        TR.RunnerConfig(**kw)


# ---------------------------------------------------------------------------
# the opt-in paths: forward_impl="fused", fk_impl
# ---------------------------------------------------------------------------

def _pair(stream, n_frames, jkw, tkw, seed=0):
    """The same float32 stream and weights through tip_tpu's run_offline
    (options jkw) and the port's (options tkw)."""
    imu, s_init = (a.astype(np.float32) for a in stream)
    jm = dict(TINY, **jkw.pop("model", {}))
    tm = dict(TINY, **tkw.pop("model", {}))
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**jm), **jkw)
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg.model)
    j_out = JR.run_offline(params, jcfg, jkin.amass_skeleton(),
                           jax.numpy.asarray(s_init),
                           jax.numpy.asarray(imu[:n_frames]))
    tcfg = TR.RunnerConfig(model=TM.ModelConfig(**tm), **tkw)
    model = TM.TIPModel(tcfg.model, device="cpu")
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    t_out = TR.run_offline(model, tcfg, tkin.amass_skeleton(), s_init,
                           imu[:n_frames], device="cpu")
    return [np.asarray(a) for a in j_out], [a.numpy() for a in t_out], model


@pytest.fixture(scope="module")
def fused_runs(stream):
    """46 frames = 5 warmup + 40 model frames: the window fills and never
    slides, where tip_tpu's fused runner is still right."""
    fused = dict(forward_impl="fused", compute_dtype="float32")
    return _pair(stream, 46, dict(model=dict(fused)), dict(model=dict(fused)))


@pytest.mark.parametrize("i,name", [(0, "s_traj"), (1, "c_traj"),
                                    (2, "viz")])
def test_run_offline_fused_matches_tip_tpu_while_the_window_grows(
        fused_runs, i, name):
    j, t = fused_runs[0][i], fused_runs[1][i]
    assert t.shape == j.shape and t.dtype == np.float32
    assert np.isfinite(t).all()
    # f32 on both sides, the same casts, sums in another order, fed back
    # through the autoregressive window of a random model for 40 frames;
    # tip_tpu holds its fused runner to its XLA runner at 2e-3 over 12
    np.testing.assert_allclose(t, j, atol=2e-3, rtol=0, err_msg=name)


@pytest.mark.parametrize("dt,atol", [("float32", 2e-3), (None, None)])
def test_run_offline_fused_matches_plain_past_the_slide(stream, dt, atol):
    """70 frames: 65 model frames, 25 of them after the 40-row window
    starts to slide (where tip_tpu's fused runner returns the output bias).
    f32 packing tracks the port's plain path; the default bf16 packing
    drifts from it chaotically on a random model, so that run is held to
    be finite and, like the f32 one, to keep moving after the slide (a
    bias-only output would freeze the pose)."""
    imu, s_init = (a.astype(np.float32) for a in stream)
    outs = {}
    for impl in ("plain", "fused"):
        cfg = TR.RunnerConfig(model=TM.ModelConfig(
            **TINY, forward_impl=impl, compute_dtype=dt))
        model = TM.TIPModel(cfg.model, device="cpu",
                            generator=torch.Generator().manual_seed(3))
        K.reset_launch_counts()
        outs[impl] = TR.run_offline(model, cfg, tkin.amass_skeleton(), s_init,
                                    imu[:70], device="cpu")
        assert sum(K.launch_counts.values()) == 0
    for p, f in zip(outs["plain"], outs["fused"]):
        assert f.shape == p.shape and torch.isfinite(f).all()
    s_p, s_f = outs["plain"][0].numpy(), outs["fused"][0].numpy()
    if atol is not None:
        np.testing.assert_allclose(s_f, s_p, atol=atol, rtol=0)
    else:
        assert TR.pack_dtype(cfg) == torch.bfloat16
    # the pose keeps moving after the slide: the output is not a constant
    assert np.abs(np.diff(s_f[50:, 6:57], axis=0)).max() > 1e-4


def test_runner_step_packed_ws_is_the_models_pack(stream):
    """pack_fused_weights hoists the pack out of the frame loop: a step
    with it equals a step that looks the pack up in the model; None unless
    the fused forward is on."""
    imu, s_init = (a.astype(np.float32) for a in stream)
    cfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY, forward_impl="fused"))
    model = TM.TIPModel(cfg.model, device="cpu")
    skel = tkin.amass_skeleton()
    ws = TR.pack_fused_weights(model, cfg)
    assert ws is model.packed_weights(torch.bfloat16)
    assert ws[0].dtype == torch.bfloat16
    carries = [TR.runner_init(cfg, skel, s_init, device="cpu")
               for _ in range(2)]
    with torch.no_grad():
        for t in range(8):
            carries[0], a = TR.runner_step(model, carries[0],
                                           torch.as_tensor(imu[t]), cfg, skel)
            carries[1], b = TR.runner_step(model, carries[1],
                                           torch.as_tensor(imu[t]), cfg, skel,
                                           packed_ws=ws)
            assert torch.equal(a["qdq"], b["qdq"])
    plain = TR.RunnerConfig(model=TM.ModelConfig(**TINY))
    assert TR.pack_fused_weights(TM.TIPModel(plain.model, device="cpu"),
                                 plain) is None


@pytest.mark.parametrize("fk_impl", ["auto", "plain"])
def test_run_offline_fk_impl_matches_tip_tpu_pallas(stream, fk_impl):
    """tail_impl="plain" with the FK by fk_impl (on the CPU "auto" runs
    K6's plain version) against tip_tpu's fk_impl="pallas" run, at
    tip_tpu's own tolerance for that pair (tests/test_kinematics.py)."""
    j_out, t_out, _ = _pair(stream, 30, dict(fk_impl="pallas"),
                            dict(fk_impl=fk_impl, tail_impl="plain"))
    for j, t in zip(j_out, t_out):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=5e-5, rtol=0)


def test_fk_impl_kernel_on_cpu_raises(stream):
    imu, s_init = stream
    cfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY), fk_impl="kernel",
                          tail_impl="plain")
    model = TM.TIPModel(cfg.model, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        TR.run_offline(model, cfg, tkin.amass_skeleton(), s_init, imu[:8],
                       device="cpu")


class _OnCard:
    """Stands in for a CUDA tensor: the kernel-or-plain choice reads only
    ``is_cuda``."""
    is_cuda = True


def test_tail_impl_auto_resolution():
    """'auto' is the kernel for a CUDA tensor whatever the SBP count (K3's
    wrapper then raises for n_sbps != 5) and the plain version for a CPU
    tensor; 'plain' is plain everywhere."""
    cpu, card = torch.zeros(1), _OnCard()
    for option, explicit in (("tail_impl", "fused"), ("rnn_impl", "kernel"),
                             ("forward_impl", "fused"),
                             ("fk_impl", "kernel")):
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
