"""scripts/torch_train_convergence.py end to end on the CPU at tiny counts:
two training motions and one held-out motion from the port's corpus, one
epoch of one batch of a narrow model with either sampler, the eval's four
serving modes; then a run resumed from a checkpoint, which ends where the
uninterrupted run ends.
"""

import importlib.util
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "torch_train_convergence", ROOT / "scripts" / "torch_train_convergence.py")
TTC = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TTC)

torch.set_num_threads(1)

TINY = ["--tf_in_dim", "32", "--tf_nhid", "64", "--n_heads", "4",
        "--tf_layers", "2", "--rnn_nhid", "24", "--batch_size", "8",
        "--max_batches", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus phase once: 2 training motions (seed 100) and 1 held-out
    motion (seed 900, 12.5 s), packed."""
    base = tmp_path_factory.mktemp("corpus")
    assert TTC.phase_corpus(str(base), 2, 1, device="cpu",
                            log=lambda *a: None) == 3
    prefix = TTC.phase_pack(str(base), log=lambda *a: None)
    return base, prefix


def _with_corpus(out, corpus):
    base, _ = corpus
    for d in ("corpus_train", "corpus_test"):
        shutil.copytree(base / d, out / d)


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_script_runs_end_to_end(sampler, corpus, tmp_path):
    """All phases: the corpus found in place, packed, one epoch of one
    batch, a checkpoint, the eval's four modes with finite means; a second
    eval reads its cache."""
    _with_corpus(tmp_path, corpus)
    argv = ["--out", str(tmp_path), "--epochs", "1", "--n_train", "2",
            "--n_test", "1", "--test_len", "200", "--sampler", sampler,
            *TINY]
    results = TTC.main(argv)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["ckpt_1.pt"]
    recs = [json.loads(ln) for ln in open(tmp_path / "train_metrics.jsonl")]
    assert [r["epoch"] for r in recs] == [1]
    assert recs[0]["skipped"] == 0 and np.isfinite(recs[0]["mean_loss"])
    assert results["step"] == 1 and results["n_test"] == 1
    assert list(results["modes"]) == [m for m, _ in TTC.EVAL_MODES]
    for mode in results["modes"].values():
        assert mode["n_motions"] == 1
        assert mode["means"] and all(np.isfinite(v)
                                     for v in mode["means"].values())
        assert mode["by_family"]
    assert "terrain" in results["modes"]["recompute_full_terrain"]
    assert "sbp" in results["modes"]["recompute"]
    written = json.loads(json.dumps(results))
    with open(tmp_path / "results.json") as f:
        assert json.load(f) == written
    again = TTC.main(argv[:2] + ["--phase", "eval", "--epochs", "1",
                                 "--test_len", "200", *TINY])
    assert again == written


def _ckpt(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_script_resumes_where_it_stopped(sampler, corpus, tmp_path):
    """Two epochs with a checkpoint after each; a second run handed only
    the first checkpoint resumes at epoch 2 (the host sampler replays its
    numpy stream) and writes the same second checkpoint: parameters,
    moments, step and generators."""
    _, prefix = corpus
    logs = []
    argv = ["--phase", "train", "--data_prefix", prefix, "--epochs", "2",
            "--save_every", "1", "--sampler", sampler, *TINY]
    TTC.phase_train(str(tmp_path / "a"), prefix, 2, sampler=sampler,
                    device="cpu", max_batches=1, save_every=1,
                    log=logs.append, **_sizes())
    os.makedirs(tmp_path / "b" / "ckpt")
    shutil.copy(tmp_path / "a" / "ckpt" / "ckpt_1.pt",
                tmp_path / "b" / "ckpt")
    TTC.main(["--out", str(tmp_path / "b"), *argv])
    a = _ckpt(tmp_path / "a" / "ckpt" / "ckpt_2.pt")
    b = _ckpt(tmp_path / "b" / "ckpt" / "ckpt_2.pt")
    assert a["step"] == b["step"] == 2
    for k in ("gen", "noise_gen"):
        assert torch.equal(a[k], b[k]), k
    for k in ("params", "mu", "nu"):
        assert a[k].keys() == b[k].keys()
        for n in a[k]:
            assert torch.equal(a[k][n], b[k][n]), (k, n)
    recs = [json.loads(ln)
            for ln in open(tmp_path / "b" / "train_metrics.jsonl")]
    assert [r["epoch"] for r in recs] == [2]
    first = [json.loads(ln)
             for ln in open(tmp_path / "a" / "train_metrics.jsonl")]
    assert recs[0]["mean_loss"] == first[1]["mean_loss"]
    # a finished run trains no more
    logs.clear()
    TTC.phase_train(str(tmp_path / "a"), prefix, 2, sampler=sampler,
                    device="cpu", max_batches=1, log=logs.append,
                    **_sizes())
    assert "training already complete" in logs


def _sizes():
    return dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
                rnn_hid_size=24, batch_size=8)


def test_make_train_cfg_is_the_recipe():
    cfg = TTC.make_train_cfg(1100)
    m = cfg.model
    assert (m.compute_dtype, m.rnn_impl, m.encoder_impl, m.dropout_impl) == (
        "bfloat16", "auto", "xla", "rng")
    assert (m.tf_in_dim, m.tf_hid_size, m.n_heads, m.tf_layers,
            m.rnn_hid_size, m.size_s, m.with_acc_sum) == (
        256, 1024, 16, 4, 512, 131, True)
    assert (cfg.batch_size, cfg.seq_len, cfg.lr, cfg.optimizer,
            cfg.weight_decay, cfg.clip, cfg.cosine_lr, cfg.seed,
            cfg.dropout_rng_impl) == (256, 40, 1e-4, "AdamW", 1e-4, 5.0,
                                      True, 5104, "rbg")


@pytest.mark.parametrize("flag", [["--git_ckpt_every", "5"],
                                  ["--platform", "cpu"]])
def test_script_refuses_what_is_not_ported(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        TTC.main(["--out", str(tmp_path), *flag, "--device", "cpu"])
