"""scripts/torch_soak.py, the port's twin of scripts/soak.py, and its core
``chip_smoke.full_soak``, on the CPU at a small size; and
``chip_smoke.kernel_breakdown``'s second profile.

(a) The counterpart of tests/test_terrain_full_runner.py::
test_full_runner_long_stream_soak: the small model in float64, multi_sbp,
a terrain grid of +-3 m and a table of 16 regions, 4 chunks of 500 frames
of a random stream through the soak's core: the outputs and the state
finite, the table saturated gracefully (within capacity), the carry's
shapes fixed. (b) The core's first 200 frames (two chunks of 100) in
float64, in recompute and in kv_cache_rnn_carry, equal tip_tpu's soak.py
step loop (``lax.scan`` of
``full_runner_step``, the same configuration at the small width, the same
weights through ``params_from_jax``): the root track, the regions used
and their heights to 1e-8. (c) The script at 2 chunks of 60 frames with
``--device cpu`` prints every key of soak.py's JSON line; without CUDA
and without ``--device cpu`` it raises. (d) A profile with no device
event is taken once more; two empty ones fail.
"""

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import full_runner as JF
from tip_tpu.runtime import runner as JR
from tip_tpu.runtime import terrain as JT
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import terrain as TT

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
TOL = 1e-8
CPU = torch.device("cpu")


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_soak", ROOT / "scripts" / "torch_soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


S = _script()


def tiny_config(serving_mode="recompute", **terrain):
    """The soak's configuration (chip_smoke.soak_config) at the small
    width."""
    cfg = CS.soak_config(serving_mode, terrain=TT.TerrainConfig(**terrain))
    base = dataclasses.replace(
        cfg.base, model=dataclasses.replace(cfg.base.model, **TINY))
    return dataclasses.replace(cfg, base=base)


@pytest.fixture(scope="module")
def weights():
    """The small model's weights from PRNGKey(0) in float64: tip_tpu's
    params and the port's state dict of them."""
    params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float64),
        JM.init_params(jax.random.PRNGKey(0), JM.ModelConfig(**TINY)))
    return params, TM.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             params))


def tiny_model(cfg, state_dict):
    model = TM.TIPModel(cfg.base.model, device=CPU, dtype=torch.float64)
    model.load_state_dict(state_dict)
    return model


@pytest.fixture(scope="module")
def long_soak(weights):
    cfg = tiny_config(map_bound=3.0, max_regions=16)
    model = tiny_model(cfg, weights[1])
    s_init = CS.s_init_pose().astype(np.float64)
    s_init[6:57] = np.random.default_rng(3).normal(size=51) * 0.1
    res, roots, carry = CS.full_soak(
        model, cfg, tkin.amass_skeleton(dtype=torch.float64), s_init, 2000,
        500, CPU, log=lambda m: None)
    return cfg, res, roots, carry


def test_full_runner_long_stream_soak(long_soak):
    cfg, res, roots, carry = long_soak
    assert carry.base.t == 2000 and roots.shape == (2000, 3)
    assert np.isfinite(roots).all()
    assert torch.isfinite(carry.base.last_s).all()
    # random weights and a random stream saturate the table, which must
    # degrade gracefully (the cursor clamps, the last slot is reused)
    assert int(carry.terrain.n_regions) <= cfg.terrain.max_regions
    assert res["terrain_regions_used"] == cfg.terrain.max_regions
    assert torch.isfinite(carry.terrain.region_height).all()
    # the carry is a fixed set of tensors: no buffer grew
    assert res["carry_shapes_fixed"] and res["ok"]
    assert res["device_mb_by_chunk"] == [None] * 4


def _jax_soak(params, frames, chunk, serving_mode):
    """tip_tpu's scripts/soak.py loop (its run_chunk) at the small width in
    float64: (roots, final carry)."""
    import bench
    base = JR.RunnerConfig(model=JM.ModelConfig(rnn_impl="pallas", **TINY),
                           serving_mode=serving_mode)
    fcfg = JF.FullRunnerConfig(base=base, terrain=JT.TerrainConfig(),
                               multi_sbp=True)
    skel = jkin.amass_skeleton(dtype=jnp.float64)

    @jax.jit
    def run_chunk(params, carry, chunk):
        def sstep(c, x):
            c, out = JF.full_runner_step(params, c, x, fcfg, skel)
            return c, out["qdq"][:3]
        return jax.lax.scan(sstep, carry, chunk)

    carry = JF.full_runner_init(fcfg, skel, jnp.asarray(CS.s_init_pose()),
                                dtype=jnp.float64)
    roots = []
    for i in range(frames // chunk):
        carry, r = run_chunk(params, carry, jnp.asarray(
            bench.make_stream(chunk, seed=i), jnp.float64))
        roots.append(np.asarray(r))
    return np.concatenate(roots), carry


@pytest.mark.parametrize("serving_mode", ["recompute", "kv_cache_rnn_carry"])
def test_soak_core_matches_tip_tpus_soak_loop(weights, serving_mode):
    params, state_dict = weights
    j_roots, j_carry = _jax_soak(params, 200, 100, serving_mode)
    cfg = tiny_config(serving_mode)
    res, roots, carry = CS.full_soak(
        tiny_model(cfg, state_dict), cfg,
        tkin.amass_skeleton(dtype=torch.float64),
        CS.s_init_pose(), 200, 100, CPU, log=lambda m: None)
    np.testing.assert_allclose(roots, j_roots, rtol=0, atol=TOL)
    assert int(carry.terrain.n_regions) == int(j_carry.terrain.n_regions)
    assert res["terrain_regions_used"] > 1          # the table was used
    np.testing.assert_allclose(carry.terrain.region_height.numpy(),
                               np.asarray(j_carry.terrain.region_height),
                               rtol=0, atol=TOL)


def soak_py_keys():
    """The keys of the JSON line scripts/soak.py prints."""
    tree = ast.parse((ROOT / "scripts" / "soak.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("scripts/soak.py prints no JSON dict")


def test_script_prints_soak_py_keys(capsys):
    assert S.main(["--frames", "120", "--chunk", "60",
                   "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.startswith("chunk ") for ln in lines[:-1]] == [True] * 2
    res = json.loads(lines[-1])
    keys = soak_py_keys()
    assert len(keys) == 10 and set(keys) <= set(res)
    assert res["metric"] == "soak_full_runner" and res["frames"] == 120
    assert res["serving_mode"] == "recompute" and res["ok"] is True
    assert res["terrain_capacity"] == TT.TerrainConfig().max_regions
    for k in ("device_mb_after_chunk1", "device_mb_end",
              "device_growth_mb_after_chunk1", "device_peak_mb",
              "launches_per_frame", "card"):
        assert k in res, k


def test_script_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        S.main(["--frames", "2", "--chunk", "1"])


class _Event:
    key = "some_kernel"
    self_device_time_total = 2000.0
    count = 5


def _stub_profiler(monkeypatch, profiles):
    """torch.profiler.profile replaced by one that hands out the given
    lists of events in turn; returns the list of profiles taken."""
    taken = []

    class Profile:
        def __init__(self, **kw):
            self.events = profiles[len(taken)]
            taken.append(self.events)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return taken


def test_kernel_breakdown_profiles_again_when_empty(monkeypatch):
    calls = []
    taken = _stub_profiler(monkeypatch, [[], [_Event()]])
    rows = CS.kernel_breakdown(lambda: calls.append(1), n=5)
    assert len(taken) == 2 and len(calls) == 1 + 2 * 5
    assert rows == [["some_kernel", 2000.0 / 1e3 / 5, 1.0]]


def test_kernel_breakdown_fails_on_two_empty_profiles(monkeypatch):
    taken = _stub_profiler(monkeypatch, [[], [], [_Event()]])
    with pytest.raises(AssertionError, match="two profiles"):
        CS.kernel_breakdown(lambda: None, n=3)
    assert len(taken) == 2


def test_kernel_breakdown_first_profile_kept(monkeypatch):
    """A profile with device events is not taken again, and a kernel that
    no longer exists still fails at once."""
    gone = type("Gone", (_Event,), {"key": "widen_bf16_kernel"})
    taken = _stub_profiler(monkeypatch, [[_Event()], [_Event()]])
    assert len(CS.kernel_breakdown(lambda: None)) == 1 and len(taken) == 1
    _stub_profiler(monkeypatch, [[gone()], [_Event()]])
    with pytest.raises(AssertionError, match="no longer exist"):
        CS.kernel_breakdown(lambda: None)
