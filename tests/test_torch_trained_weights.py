"""Trained weights (ROADMAP A3a): the flagship checkpoint in this clone's
git history, read with tip_tpu's own restore, converted with
``params_from_jax``, and the port's ``run_offline`` (recompute, the plain
path on the CPU) held against tip_tpu's in float64 over 300 frames of the
in-tree motion: 1e-8, as tests/test_torch_runner.py holds random weights.

The checkpoint is read with ``git archive`` into the test's temporary
directory and never into the tree (tests/trained_checkpoint.py); the test
skips where git or the commit is absent (a shallow clone, an unpacked
archive). scripts/torch_trained_drift.py reports the other routes' drift
from the same run.
"""

import numpy as np
import pytest
import torch

import trained_checkpoint as TC
from tip_tpu_torch.models import tip_model as TM

torch.set_num_threads(1)

TOL = 1e-8


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    reason = TC.missing()
    if reason:
        pytest.skip(reason)
    return TC.load_trained(tmp_path_factory.mktemp("trained"))


def test_checkpoint_is_the_flagship_configuration(trained):
    cfg, params = trained
    assert (cfg.size_s, cfg.with_acc_sum, cfg.tf_in_dim, cfg.tf_hid_size,
            cfg.tf_layers, cfg.rnn_hid_size) == (131, True, 256, 1024, 4,
                                                 512)
    sd = TM.params_from_jax(params)
    model = TM.TIPModel(TC.port_config(cfg), device="cpu")
    assert set(sd) == set(model.state_dict())
    assert all(torch.isfinite(v).all() for v in sd.values())


@pytest.fixture(scope="module")
def runs(trained):
    return TC.run_both(*trained)


@pytest.mark.parametrize("i,name", [(0, "s_traj"), (1, "c_traj"),
                                    (2, "viz")])
def test_trained_run_offline_matches_tip_tpu(runs, i, name):
    j, t = runs[0][i], runs[1][i]
    assert t.shape == j.shape == (TC.N_FRAMES,) + j.shape[1:]
    np.testing.assert_allclose(t, j, atol=TOL, rtol=0, err_msg=name)


def test_trained_model_moves(runs):
    """The trained model's trajectory is finite and leaves s_init (its root
    travels 1.35 m over the 300 frames)."""
    s = runs[1][0]
    assert np.isfinite(s).all()
    assert np.abs(s[-1, :3] - s[0, :3]).max() > 0.5
