"""scripts/torch_soak_pool.py, the port's twin of scripts/soak_pool.py, on the
CPU at a small size.

The soak's core (``chip_smoke.soak``) runs two float64 pools of 8 slots of a narrow
model for 120 ticks, a failure injected at tick 60, on tip_tpu's route
(kv_cache_rnn_carry) with the plain forward: the sentinel equals the
churn-free pool bit for bit before the injection and tip_tpu's StreamPool
fed the same schedule (1e-8, tests/test_torch_serving.py's float64
tolerance); the injected failure, which poisons the pool's state in place
and raises, is recovered and every later active output is finite. A failed
tick frees the state it failed on at once (ROADMAP C18). Each flag of the
script is parsed and acts.
"""

import gc
import importlib.util
import json
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.runtime import runner as JR
from tip_tpu.runtime import serving as JS
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import runner as TR
from tip_tpu_torch.runtime.serving import StreamPool

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
MODE = "kv_cache_rnn_carry"
CAPACITY, TICKS = 8, 120
OUTS = ("qdq", "viz_locs", "ct")


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_soak_pool", ROOT / "scripts" / "torch_soak_pool.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


S = _script()


def _port_pools(model, cfg, n=2):
    return [StreamPool(model, cfg, tkin.amass_skeleton(dtype=torch.float64),
                       capacity=CAPACITY, dtype=torch.float64, device="cpu")
            for _ in range(n)]


@pytest.fixture(scope="module")
def soaked():
    """The core's result on the port, and the same weights' tip_tpu
    setting."""
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**TINY), serving_mode=MODE)
    params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float64),
        JM.init_params(jax.random.PRNGKey(0), jcfg.model))
    tcfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY), serving_mode=MODE)
    model = TM.TIPModel(tcfg.model, device="cpu", dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    stream = CS.make_stream(600)
    with torch.no_grad():
        res = CS.soak(*_port_pools(model, tcfg), TICKS, stream,
                      CS.s_init_pose(), log=lambda m: None, keep=True)
    return res, (jcfg, params), stream


def test_sentinel_is_bit_equal_to_the_churn_free_pool(soaked):
    res = soaked[0]
    assert res["ok"] and res["sentinel_isolation_max_diff"] == 0.0
    assert len(res["sentinel"]) == TICKS // 2
    for a, b in zip(res["sentinel"], res["sentinel_ref"]):
        for n in OUTS:
            np.testing.assert_array_equal(a[n], b[n])
    # the churn went on around the sentinel
    assert res["adds"] >= 10 and res["drops"] >= 10
    assert all(s != 0 for ev in res["events"].values() for k, s in ev)


def test_injected_failure_is_recovered(soaked):
    res = soaked[0]
    assert res["injected_failure_recovered"] and res["rebuilt_state_finite"]
    assert res["active_outputs_finite"]
    assert res["rss_mb_end"] > 0 and res["device_mb_end"] is None


def test_sentinel_equals_tip_tpus_pool_on_the_same_schedule(soaked):
    """tip_tpu's StreamPool driven by the events the port's soak recorded,
    with the frames the soak feeds: the sentinel tick by tick, float64."""
    res, (jcfg, params), stream = soaked
    jpool = JS.StreamPool(params, jcfg, jkin.amass_skeleton(
        dtype=jnp.float64), capacity=CAPACITY, dtype=jnp.float64)
    idle = CS.idle_frame()
    batch = np.tile(idle, (CAPACITY, 1)).astype(np.float64)
    s_init = CS.s_init_pose()
    assert jpool.add_stream(s_init) == 0
    for _ in range(CAPACITY // 2 - 1):
        jpool.add_stream(s_init)
    for t in range(TICKS // 2):
        for kind, slot in res["events"].get(t, ()):
            if kind == "remove":
                jpool.remove_stream(slot)
                batch[slot] = idle
            else:
                assert jpool.add_stream(s_init) == slot
        for slot in np.flatnonzero(jpool.active):
            batch[slot] = stream[(t + slot) % len(stream)]
        out = jpool.step(batch)
        for n in OUTS:
            np.testing.assert_allclose(res["sentinel"][t][n],
                                       np.asarray(out[n][0]), atol=1e-8,
                                       rtol=0, err_msg=f"{n}, tick {t}")


def test_failed_tick_frees_its_state_at_once():
    """ROADMAP C18: StreamPool.step kept the raised error in its frame, and
    the error's traceback held the frame, so the state the tick failed on
    (at 4,096 streams 0.77 GB of rings on the card) stayed allocated until
    the cyclic collector ran. With the collector off, the poisoned state is
    gone once the error has been handled."""
    cfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY), serving_mode=MODE)
    model = TM.TIPModel(cfg.model, device="cpu")
    pool = StreamPool(model, cfg, capacity=4, device="cpu")
    pool.add_stream(CS.s_init_pose())
    old = weakref.ref(pool._carries.cache.k)
    pool._step = CS.poison_and_raise
    enabled = gc.isenabled()
    gc.disable()
    try:
        with pytest.raises(RuntimeError, match="injected failure"):
            pool.step(np.zeros((4, 72)))
        assert old() is None
    finally:
        if enabled:
            gc.enable()
    del pool._step
    out = pool.step(np.zeros((4, 72)))
    assert torch.isfinite(out["qdq"]).all()
    assert torch.isfinite(pool._carries.cache.k).all()


def test_flags_parse_and_act(capsys):
    """--ticks, --capacity, --serving_mode, --forward_impl, --device, and
    --block_each_tick or --device_time_window, at full width on the CPU."""
    assert vars(S.parse_args([])) == dict(
        ticks=3000, capacity=64, serving_mode="kv_cache_rnn_carry",
        forward_impl="fused", block_each_tick=False, device_time_window=0,
        device="cuda")
    assert S.main(["--device", "cpu", "--ticks", "16", "--capacity", "4",
                   "--serving_mode", "kv_cache", "--forward_impl", "plain",
                   "--block_each_tick"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (res["ticks"], res["capacity"], res["serving_mode"],
            res["forward_impl"], res["device"]) == (16, 4, "kv_cache",
                                                    "plain", "cpu")
    assert res["tick_latency"]["count"] == 16
    assert res["tick_device_ms"] is None
    assert res["ok"]
    assert S.main(["--device", "cpu", "--ticks", "16", "--capacity", "4",
                   "--device_time_window", "3"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["forward_impl"] == "fused" and res["tick_latency"] is None
    assert res["tick_device_ms"]["window"] == 3
    assert res["tick_device_ms"]["n_windows"] == 2      # 7 ticks after
    assert res["ok"]
