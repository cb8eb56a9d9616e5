"""The port's procedural corpus (tip_tpu_torch/data_gen/corpus.py) against
tip_tpu's on the CPU: every family's motion bit for bit from the same
seed, ``generate_corpus``'s files in float64 (names equal, payloads within
tests/test_torch_datagen.py's synthesis tolerances, flags equal), and its
resume, ``exclude`` and ``families`` behaviour, errors included.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from tip_tpu.data_gen import amass_syn as jsyn
from tip_tpu.data_gen import corpus as JCO
from tip_tpu_torch.data_gen import amass_syn as tsyn
from tip_tpu_torch.data_gen import corpus as TCO

torch.set_num_threads(1)

# a synthesized motion against tip_tpu's in float64
# (tests/test_torch_datagen.py's TOL_IMU, TOL_QDQ, TOL_OFFSET)
TOL_IMU = 1e-9
TOL_QDQ = 1e-12
TOL_OFFSET = 1e-9

FAMILIES = [f[0] for f in JCO._FAMILIES + JCO._EXTRA_FAMILIES]


def _same_motion(a, b):
    (fa, ma), (fb, mb) = a, b
    assert fa == fb
    assert ma.fps == mb.fps
    for x, y in ((ma.poses, mb.poses), (ma.trans, mb.trans)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_the_family_tables_are_tip_tpus():
    for mine, theirs in ((TCO._FAMILIES, JCO._FAMILIES),
                         (TCO._EXTRA_FAMILIES, JCO._EXTRA_FAMILIES)):
        assert [(n, w) for n, w, _ in mine] == [(n, w) for n, w, _ in theirs]
    rng = np.random.default_rng(0)
    for (_, _, a), (_, _, b) in zip(TCO._FAMILIES + TCO._EXTRA_FAMILIES,
                                    JCO._FAMILIES + JCO._EXTRA_FAMILIES):
        assert a(rng) == b(rng)


@pytest.mark.parametrize("family", FAMILIES)
def test_make_motion_equals_tip_tpus(family):
    """Each family's planner from one seed, with the family's own random
    duration (its 2-second quantisation included): tip_tpu's motion bit
    for bit."""
    for seed in (3, 41):
        _same_motion(TCO.make_motion(np.random.default_rng(seed), family),
                     JCO.make_motion(np.random.default_rng(seed), family))


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_make_motion_draws_the_family_and_duration_as_tip_tpu(seed):
    """The family drawn from the mix and a fixed duration, and the rng's
    state after the draw: tip_tpu's."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    _same_motion(TCO.make_motion(a), JCO.make_motion(b))
    _same_motion(TCO.make_motion(a, duration_s=4.0),
                 JCO.make_motion(b, duration_s=4.0))
    assert a.integers(1 << 30) == b.integers(1 << 30)


def test_leg_and_arm_geometry_are_tip_tpus():
    for mine, theirs in zip(TCO.leg_geometry() + TCO.arm_geometry(),
                            JCO.leg_geometry() + JCO.arm_geometry()):
        for k, v in vars(theirs).items():
            np.testing.assert_array_equal(getattr(mine, k), v)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)      # written by this test


def test_generate_corpus_equals_tip_tpus(tmp_path):
    """Two 2-second motions synthesized in float64 on the CPU: tip_tpu's
    file names and, within the synthesis tolerances, its payloads."""
    logged = []
    n_t = TCO.generate_corpus(str(tmp_path / "t"), 2, seed=100,
                              duration_s=2.0, log=logged.append,
                              device="cpu")
    n_j = JCO.generate_corpus(str(tmp_path / "j"), 2, seed=100,
                              duration_s=2.0, log=logged.append)
    assert n_t == n_j == 2
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert all(n.endswith(".pkl") for n in names)
    for n in names:
        got, want = _load(tmp_path / "t" / n), _load(tmp_path / "j" / n)
        assert set(got) == set(want) == {"imu", "nimble_qdq", "constrs"}
        for k in got:
            assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got["imu"], want["imu"], atol=TOL_IMU,
                                   rtol=0)
        np.testing.assert_allclose(got["nimble_qdq"], want["nimble_qdq"],
                                   atol=TOL_QDQ, rtol=0)
        np.testing.assert_array_equal(got["constrs"][:, 0::4],
                                      want["constrs"][:, 0::4])
        np.testing.assert_allclose(got["constrs"], want["constrs"],
                                   atol=TOL_OFFSET, rtol=0)


@pytest.fixture
def stub_synthesis(monkeypatch):
    """Both packages' synthesis replaced by a record of the motion it was
    handed (the draw stream and the file handling are what is compared;
    ``test_generate_corpus_equals_tip_tpus`` holds the synthesis)."""
    def stub(motion, rng=None, **kw):
        return {"poses": motion.poses, "trans": motion.trans,
                "after": rng.integers(1 << 30)}
    monkeypatch.setattr(tsyn, "synthesize", stub)
    monkeypatch.setattr(jsyn, "synthesize", stub)


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        x, y = _load(os.path.join(a, n)), _load(os.path.join(b, n))
        assert x["after"] == y["after"]
        np.testing.assert_array_equal(x["poses"], y["poses"])
    return names


@pytest.mark.parametrize("kw", [
    dict(), dict(start=5), dict(exclude=("walk_flat", "idle")),
    dict(families=("freeform2",)), dict(families=("sit", "walk_ramp")),
], ids=["mix", "start", "exclude", "freeform2", "two_families"])
def test_generate_corpus_draws_and_names_as_tip_tpu(kw, tmp_path,
                                                    stub_synthesis):
    n_t = TCO.generate_corpus(str(tmp_path / "t"), 12, seed=900,
                              log=lambda *a: None, device="cpu", **kw)
    n_j = JCO.generate_corpus(str(tmp_path / "j"), 12, seed=900,
                              log=lambda *a: None, **kw)
    assert n_t == n_j == 12
    names = _same_files(tmp_path / "t", tmp_path / "j")
    start = kw.get("start", 0)
    assert sorted(n[-8:] for n in names) == [
        f"{i:04d}.pkl" for i in range(start, start + 12)]
    fams = {n.rsplit("_", 1)[0] for n in names}
    if "exclude" in kw:
        assert not fams & set(kw["exclude"])
    if "families" in kw:
        assert fams <= set(kw["families"])


def test_generate_corpus_resumes(tmp_path, stub_synthesis):
    """A rerun writes nothing; a file taken away is written again, the same
    as before, and nothing else is; no temporary file is left."""
    out = str(tmp_path / "c")
    assert TCO.generate_corpus(out, 6, seed=3, log=lambda *a: None,
                               device="cpu") == 6
    names = sorted(os.listdir(out))
    gone = names[2]
    before = _load(os.path.join(out, gone))
    assert TCO.generate_corpus(out, 6, seed=3, device="cpu") == 0
    os.remove(os.path.join(out, gone))
    assert TCO.generate_corpus(out, 6, seed=3, device="cpu") == 1
    assert sorted(os.listdir(out)) == names
    again = _load(os.path.join(out, gone))
    assert again["after"] == before["after"]
    np.testing.assert_array_equal(again["poses"], before["poses"])
    # a longer run picks up after the files there
    assert TCO.generate_corpus(out, 8, seed=3, device="cpu") == 2
    assert len(os.listdir(out)) == 8
    assert not [n for n in os.listdir(out) if n.endswith(".tmp")]


@pytest.mark.parametrize("kw, match", [
    (dict(families=("sit",), exclude=("idle",)), "mutually exclusive"),
    (dict(families=("sit", "moonwalk")), "unknown corpus families"),
    (dict(exclude=("freeform2",)), "unknown corpus families"),
    (dict(exclude=("moonwalk",)), "unknown corpus families"),
])
def test_generate_corpus_refuses_as_tip_tpu(kw, match, tmp_path):
    with pytest.raises(ValueError, match=match) as mine:
        TCO.generate_corpus(str(tmp_path / "t"), 1, device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        JCO.generate_corpus(str(tmp_path / "j"), 1, **kw)
    assert str(mine.value) == str(theirs.value)
