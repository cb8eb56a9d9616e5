"""The route of the decode and tail (K2, K3 or their plain versions) is
chosen once from the configuration: ``RunnerConfig.resolved_tail_impl``,
pure in (tail_impl, n_sbps, device type), as tip_tpu's
``resolved_tail_impl``. "auto" takes the kernels only on a CUDA device
with the 5-SBP layout, so a 2-SBP configuration (cli/serve's and
cli/live_demo's defaults, cli/evaluate without --five_sbp) runs the plain
versions on the card instead of reaching K3, which takes 5 SBPs only.
The runner's frame step, the pool's tick and the full runner all read it.
(run_offline with 2 SBPs equals tip_tpu's in float64:
tests/test_torch_runner.py::test_run_offline_two_sbps_matches_tip_tpu.)
"""

import itertools
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import fused_tail as FT
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import full_runner as TFR
from tip_tpu_torch.runtime import runner as TR
from tip_tpu_torch.runtime.serving import StreamPool

torch.set_num_threads(1)

MOTION = (Path(__file__).resolve().parents[1] / "artifacts" / "corpus_run_v3"
          / "corpus_extra" / "freeform2_0000.pkl")
TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)


@pytest.mark.parametrize("impl,n_sbps,device_type", list(itertools.product(
    ("auto", "fused", "plain"), (2, 4, 5), ("cuda", "cpu"))))
def test_resolved_tail_impl(impl, n_sbps, device_type):
    if impl == "fused" and n_sbps != 5:
        with pytest.raises(ValueError, match="5-SBP"):
            TR.RunnerConfig(model=TM.ModelConfig(
                size_s=cst.state_dim(n_sbps)), n_sbps=n_sbps, tail_impl=impl)
        return
    cfg = TR.RunnerConfig(model=TM.ModelConfig(size_s=cst.state_dim(n_sbps)),
                          n_sbps=n_sbps, tail_impl=impl)
    want = impl
    if impl == "auto":
        want = "fused" if (device_type == "cuda" and n_sbps == 5) else "plain"
    assert cfg.resolved_tail_impl(device_type) == want


@pytest.fixture(scope="module")
def stream():
    with open(MOTION, "rb") as f:      # in-tree motion written by data gen
        d = pickle.load(f)
    return (np.asarray(d["imu"][:14], np.float32),
            np.asarray(d["nimble_qdq"][0], np.float32))


@pytest.mark.parametrize("n_sbps,route", [(2, "plain"), (5, "fused")])
@pytest.mark.parametrize("entry", ["run_offline", "pool", "full_runner"])
def test_every_path_reads_the_resolved_route(stream, monkeypatch, entry,
                                            n_sbps, route):
    """With the configuration resolved as on a CUDA device, the wrappers
    of K2 and K3 are handed the route ``resolved_tail_impl`` names, on
    every frame of the single-stream runner, the pool and the full runner
    (they then run their plain versions here, on CPU tensors)."""
    imu, s_init = stream
    seen = []
    resolve = TR.RunnerConfig.resolved_tail_impl
    monkeypatch.setattr(TR.RunnerConfig, "resolved_tail_impl",
                        lambda self, device_type: resolve(self, "cuda"))
    for name in ("decode_fused", "tail_fused"):
        def record(*a, impl, _f=getattr(FT, name), _n=name, **kw):
            seen.append((_n, impl))
            return _f(*a, impl="plain", **kw)
        monkeypatch.setattr(FT, name, record)
    cfg = TR.RunnerConfig(model=TM.ModelConfig(
        **TINY, size_s=cst.state_dim(n_sbps)), n_sbps=n_sbps)
    model = TM.TIPModel(cfg.model, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    skel = tkin.amass_skeleton()
    if entry == "run_offline":
        out = TR.run_offline(model, cfg, skel, s_init, imu, device="cpu")[0]
    elif entry == "pool":
        pool = StreamPool(model, cfg, skel, capacity=2, device="cpu")
        pool.add_stream(s_init)
        out = torch.stack([pool.step(np.stack([x, x]))["qdq"] for x in imu])
    else:
        fcfg = TFR.FullRunnerConfig(base=cfg)
        out = TFR.run_offline_full(model, fcfg, skel, s_init, imu,
                                   device="cpu")[0]
    assert torch.isfinite(out).all()
    assert {n for n, _ in seen} == {"decode_fused", "tail_fused"}
    assert {impl for _, impl in seen} == {route}
