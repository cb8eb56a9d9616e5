"""The port's data generation from SMPL motions on the CPU, against
tip_tpu's in float64: the SBP label search (ops/sbp.py's label half), the
SMPL containers and resampling (data_gen/smpl.py), the synthesis of IMU,
ground truth and SBP labels (data_gen/amass_syn.py), the DIP/TotalCapture
preprocessing (data_gen/dip.py) and the two CLIs (cli/gen_data.py,
cli/preprocess_dip.py). Mirrors tests/test_sbp.py and
tests/test_dip_pipeline.py; the motions are procedural (the repo holds no
AMASS or DIP data).
"""

import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from tip_tpu.cli import gen_data as jgen
from tip_tpu.cli import preprocess_dip as jprep
from tip_tpu.data_gen import amass_syn as jsyn
from tip_tpu.data_gen import dip as jdip
from tip_tpu.data_gen import smpl as jsmpl
from tip_tpu.ops import sbp as jsbp
from tip_tpu_torch.cli import gen_data as tgen
from tip_tpu_torch.cli import preprocess_dip as tprep
from tip_tpu_torch.data_gen import amass_syn as tsyn
from tip_tpu_torch.data_gen import dip as tdip
from tip_tpu_torch.data_gen import smpl as tsmpl
from tip_tpu_torch.ops import sbp as tsbp

torch.set_num_threads(1)

# a synthesized motion: IMU rows (matrices and central-difference accs),
# SBP offsets and nimble ground truth, against tip_tpu's in float64
TOL_IMU = 1e-9
TOL_QDQ = 1e-12
TOL_OFFSET = 1e-9
# one label search step's offsets
TOL_SOL = 1e-12


def _link_traj(T=40, stationary=True):
    """A link rotating about a fixed world point (true rot center), as
    tests/test_sbp.py's."""
    pivot = np.array([0.3, 0.1, 0.0])
    offset = np.array([0.0, 0.0, 0.10])
    pq = np.zeros((T, 7))
    for t in range(T):
        ang = 0.4 * np.sin(t * 0.15)
        r = Rotation.from_rotvec([ang, 0.2 * ang, 0])
        drift = np.zeros(3) if stationary else np.array([0.02 * t, 0, 0])
        pq[t, :3] = pivot - r.apply(offset) + drift
        pq[t, 3:] = r.as_quat()
    return pq


def make_motion(rng, T=420, fps=120.0):
    """A procedural SMPL motion: a randomised swing of 14 joints and a
    drifting, bobbing root (scripts/e2e_synthetic_demo.py's)."""
    t = np.arange(T) / fps
    poses = np.zeros((T, 24, 3))
    poses[:, 0] = [1.20919958, 1.20919958, 1.20919958]
    for j in (1, 2, 4, 5, 7, 8, 3, 6, 12, 15, 16, 17, 18, 19):
        amp = rng.uniform(0.05, 0.45)
        f = rng.uniform(0.3, 1.2)
        ph = rng.uniform(0, 2 * np.pi)
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        poses[:, j] = np.outer(amp * np.sin(2 * np.pi * f * t + ph), ax)
    trans = np.zeros((T, 3))
    trans[:, 2] = 0.95 + 0.03 * np.sin(2 * np.pi * 0.9 * t)
    trans[:, 0] = rng.uniform(-0.5, 0.5) * t
    trans[:, 1] = rng.uniform(-0.3, 0.3) * t
    return poses, trans, fps


# ---------------------------------------------------------------------------
# SBP labels
# ---------------------------------------------------------------------------

def test_grids_equal_tip_tpus():
    for link in (14, 18, 2, 5, -1):
        np.testing.assert_array_equal(tsbp.grid_for_link(link),
                                      jsbp.grid_for_link(link))
    with pytest.raises(ValueError):
        tsbp.grid_for_link(7)


@pytest.mark.parametrize("stationary", [True, False])
def test_rot_center_sample_equals_tip_tpus(stationary):
    """Step by step, each side carrying its own (sol, active): flags equal,
    offsets and velocities within TOL_SOL."""
    grid = jsbp.GRID_FOOT
    pq = _link_traj(stationary=stationary)
    dt = 2.0 / 60.0
    j_sol, j_act = jnp.zeros(3), jnp.asarray(False)
    t_sol, t_act = torch.zeros(3, dtype=torch.float64), torch.tensor(False)
    seen = 0
    for t in range(2, 30):
        x1, q1, x2, q2 = pq[t - 1, :3], pq[t - 1, 3:], pq[t + 1, :3], \
            pq[t + 1, 3:]
        jr = jsbp.rot_center_sample(*map(jnp.asarray, (x1, q1, x2, q2)), dt,
                                    j_sol, j_act, jnp.asarray(grid))
        tr = tsbp.rot_center_sample(*map(torch.as_tensor, (x1, q1, x2, q2)),
                                    dt, t_sol, t_act, torch.as_tensor(grid))
        assert bool(tr.active) == bool(jr.active), t
        seen += bool(tr.active)
        np.testing.assert_allclose(tr.sol.numpy(), np.asarray(jr.sol),
                                   atol=TOL_SOL, rtol=0)
        np.testing.assert_allclose(tr.vel.numpy(), np.asarray(jr.vel),
                                   atol=TOL_SOL, rtol=0)
        j_sol, j_act, t_sol, t_act = jr.sol, jr.active, tr.sol, tr.active
    if stationary:
        assert seen > 0


@pytest.mark.parametrize("stationary", [True, False])
@pytest.mark.parametrize("link", [2, 14, -1])
def test_link_contact_sequence_equals_tip_tpus(stationary, link):
    pq = _link_traj(T=60, stationary=stationary)
    if not stationary:
        pq[:, 0] += np.arange(60) * 0.03
    grid = jsbp.grid_for_link(link)
    want = np.asarray(jsbp.link_contact_sequence(
        jnp.asarray(pq), 1.0 / 60.0, jnp.asarray(grid)))
    got = tsbp.link_contact_sequence(torch.as_tensor(pq), 1.0 / 60.0,
                                     grid).numpy()
    assert got.shape == (60, 4)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=TOL_SOL, rtol=0)
    assert (got[:2] == 0).all() and (got[-2:] == 0).all()


def test_link_contact_sequences_equal_one_link_at_a_time():
    """The five links in one loop, each over its own (padded) grid, equal
    tip_tpu's scan of each link alone."""
    rng = np.random.default_rng(4)
    pq = np.stack([_link_traj(T=50) + rng.normal(size=(50, 7)) * 1e-3
                   for _ in range(5)], axis=1)
    pq[..., 3:] /= np.linalg.norm(pq[..., 3:], axis=-1, keepdims=True)
    links = (2, 5, 14, 18, -1)
    got = tsbp.link_contact_sequences(
        torch.as_tensor(pq), 1.0 / 60.0,
        [tsbp.grid_for_link(k) for k in links]).numpy()
    assert got[:, :, 0].any()
    for i, k in enumerate(links):
        want = np.asarray(jsbp.link_contact_sequence(
            jnp.asarray(pq[:, i]), 1.0 / 60.0,
            jnp.asarray(jsbp.grid_for_link(k))))
        np.testing.assert_array_equal(got[:, i, 0], want[:, 0])
        np.testing.assert_allclose(got[:, i, 1:], want[:, 1:], atol=TOL_SOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# SMPL containers
# ---------------------------------------------------------------------------

def test_smpl_tables_and_resampling_equal_tip_tpus():
    np.testing.assert_array_equal(tsmpl.CHAR_TO_SMPL, jsmpl.CHAR_TO_SMPL)
    np.testing.assert_array_equal(tsmpl.SMPL_PARENTS, jsmpl.SMPL_PARENTS)
    poses, trans, fps = make_motion(np.random.default_rng(0), T=90)
    for tr in (trans, None):
        tm = tsmpl.SmplMotion(poses, tr, fps)
        jm = jsmpl.SmplMotion(poses, tr, fps)
        assert tm.length_s == jm.length_s
        np.testing.assert_array_equal(tsmpl.resample_times(tm.length_s),
                                      jsmpl.resample_times(jm.length_s))
        for a, b in zip(tsmpl.resample_motion(tm),
                        jsmpl.resample_motion(jm)):
            np.testing.assert_array_equal(a, b)


def test_smpl_loaders_equal_tip_tpus(tmp_path):
    poses, trans, fps = make_motion(np.random.default_rng(1), T=30)
    npz = tmp_path / "m_poses.npz"
    np.savez(npz, poses=np.concatenate([poses.reshape(30, 72),
                                        np.zeros((30, 84))], 1),
             trans=trans, mocap_framerate=fps)
    pkl = tmp_path / "s.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"gt": poses.reshape(30, 72)}, f)
    for load in ("load_amass_npz", "load_dip_pkl"):
        path = npz if load == "load_amass_npz" else pkl
        t, j = getattr(tsmpl, load)(path), getattr(jsmpl, load)(path)
        np.testing.assert_array_equal(t.poses, j.poses)
        assert t.fps == j.fps
        assert (t.trans is None) == (j.trans is None)
        if t.trans is not None:
            np.testing.assert_array_equal(t.trans, j.trans)


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def motion():
    """About 400 frames at 120 fps: 200 frames at the 60 Hz grid."""
    return make_motion(np.random.default_rng(11), T=400)


@pytest.mark.parametrize("knee", [True, False], ids=["knee", "ankle"])
def test_synthesize_equals_tip_tpus(motion, knee):
    poses, trans, fps = motion
    want = jsyn.synthesize(jsmpl.SmplMotion(poses, trans, fps), height=1.78,
                           use_knee_imu=knee)
    got = tsyn.synthesize(tsmpl.SmplMotion(poses, trans, fps), height=1.78,
                          use_knee_imu=knee, device="cpu")
    assert set(got) == set(want) == {"imu", "nimble_qdq", "constrs"}
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float64
    np.testing.assert_allclose(got["imu"], want["imu"], atol=TOL_IMU, rtol=0)
    np.testing.assert_allclose(got["nimble_qdq"], want["nimble_qdq"],
                               atol=TOL_QDQ, rtol=0)
    flags = got["constrs"][:, 0::4]
    np.testing.assert_array_equal(flags, want["constrs"][:, 0::4])
    assert flags.any()
    np.testing.assert_allclose(got["constrs"], want["constrs"],
                               atol=TOL_OFFSET, rtol=0)


def test_synthesize_draws_the_height_as_tip_tpu(motion):
    poses, trans, fps = motion
    got = tsyn.synthesize(tsmpl.SmplMotion(poses[:120], trans[:120], fps),
                          rng=np.random.default_rng(3), device="cpu")
    want = jsyn.synthesize(jsmpl.SmplMotion(poses[:120], trans[:120], fps),
                           rng=np.random.default_rng(3))
    np.testing.assert_allclose(got["imu"], want["imu"], atol=TOL_IMU, rtol=0)
    with pytest.raises(ValueError, match="too short"):
        tsyn.synthesize(tsmpl.SmplMotion(poses[:12], trans[:12], fps),
                        height=1.7, device="cpu")


def _write_npz(path, poses, trans, fps):
    T = len(poses)
    np.savez(path, poses=np.concatenate([poses.reshape(T, 72),
                                         np.zeros((T, 84))], 1),
             trans=trans, mocap_framerate=fps)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)      # written by this test


def test_synthesize_file_writes_tip_tpus_pickle(motion, tmp_path):
    poses, trans, fps = motion
    src = tmp_path / "walk_poses.npz"
    _write_npz(src, poses[:160], trans[:160], fps)
    assert tsyn.synthesize_file(str(src), str(tmp_path / "t.pkl"),
                                rng=np.random.default_rng(5), device="cpu")
    assert jsyn.synthesize_file(str(src), str(tmp_path / "j.pkl"),
                                rng=np.random.default_rng(5))
    got, want = _load(tmp_path / "t.pkl"), _load(tmp_path / "j.pkl")
    assert set(got) == set(want)
    np.testing.assert_allclose(got["imu"], want["imu"], atol=TOL_IMU, rtol=0)
    np.testing.assert_array_equal(got["constrs"][:, 0::4],
                                  want["constrs"][:, 0::4])
    # an unreadable file is skipped, as the reference does
    bad = tmp_path / "bad_poses.npz"
    bad.write_bytes(b"not an npz")
    assert not tsyn.synthesize_file(str(bad), str(tmp_path / "b.pkl"),
                                    device="cpu")
    assert not (tmp_path / "b.pkl").exists()


# ---------------------------------------------------------------------------
# the CLI gen_data
# ---------------------------------------------------------------------------

def _amass_tree(root, n=3, T=40):
    rng = np.random.default_rng(8)
    for i in range(n):
        d = root / f"Subject {i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        _write_npz(d / f"take{i}_poses.npz", *make_motion(rng, T=T))
        (d / f"take{i}_shape.npz").write_bytes(b"")
    return root


def test_iter_jobs_shards_and_resumes_as_tip_tpu(tmp_path):
    src = _amass_tree(tmp_path / "src", n=6)
    save = tmp_path / "out"
    save.mkdir()
    for k, n in ((0, 1), (0, 2), (1, 2), (2, 3)):
        got = sorted(tgen.iter_jobs(str(src), str(save), "", k, n))
        assert got == sorted(jgen.iter_jobs(str(src), str(save), "", k, n))
    every = sorted(tgen.iter_jobs(str(src), str(save), "", 0, 1))
    assert len(every) == 6 and all(" " not in os.path.basename(d)
                                   for _, d in every)
    assert sorted(sum((list(tgen.iter_jobs(str(src), str(save), "", k, 3))
                       for k in range(3)), [])) == every
    # a written output is not made again
    open(every[0][1], "wb").close()
    assert sorted(tgen.iter_jobs(str(src), str(save), "", 0, 1)) == every[1:]
    assert sorted(tgen.iter_jobs(str(src), str(save), "take1", 0, 1)) == \
        sorted(jgen.iter_jobs(str(src), str(save), "take1", 0, 1))


@pytest.mark.parametrize("n_proc", [1, 2])
def test_gen_data_cli_writes_tip_tpus_pickles(tmp_path, monkeypatch, n_proc):
    """The same files as tip_tpu's CLI with the same seed (the RNG stream
    of a motion comes from its output name), in one process or in two
    spawned workers; a second run has nothing left to do."""
    src = _amass_tree(tmp_path / "src", n=2, T=50)
    count = tgen.main(["--src_dir", str(src), "--save_dir",
                       str(tmp_path / "t"), "--seed", "3", "--n_proc",
                       str(n_proc), "--device", "cpu"])
    assert count == 2
    monkeypatch.setattr(sys, "argv", ["gen_data", "--src_dir", str(src),
                                      "--save_dir", str(tmp_path / "j"),
                                      "--seed", "3"])
    jgen.main()
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 2
    for n in names:
        got, want = _load(tmp_path / "t" / n), _load(tmp_path / "j" / n)
        np.testing.assert_allclose(got["imu"], want["imu"], atol=TOL_IMU,
                                   rtol=0)
        np.testing.assert_array_equal(got["constrs"][:, 0::4],
                                      want["constrs"][:, 0::4])
    assert tgen.main(["--src_dir", str(src), "--save_dir",
                      str(tmp_path / "t"), "--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# DIP / TotalCapture
# ---------------------------------------------------------------------------

def _dip_pkl(path, T, rng, tc=False):
    """A DIP-like pickle (SMPL 'gt', 17 sensor slots with dropouts) or a
    TotalCapture-like one (6 sensors, 'ori'/'acc')."""
    n = 6 if tc else 17
    ori = Rotation.from_rotvec(rng.normal(size=(T * n, 3))).as_matrix() \
        .reshape(T, n, 3, 3)
    acc = rng.normal(size=(T, n, 3))
    ori[12, 1] = np.nan        # dropouts in used slots
    acc[20:22, 2] = np.nan
    data = ({"ori": ori, "acc": acc} if tc else
            {"imu_ori": ori, "imu_acc": acc,
             "gt": make_motion(rng, T=T, fps=60.0)[0].reshape(T, 72)})
    with open(path, "wb") as f:
        pickle.dump(data, f)


def _equal_payloads(got, want):
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=TOL_QDQ, rtol=0,
                                   err_msg=k)


def test_preprocess_dip_file_equals_tip_tpus(tmp_path):
    path = tmp_path / "s_01" / "01.pkl"
    path.parent.mkdir()
    _dip_pkl(path, 60, np.random.default_rng(2))
    got = tdip.preprocess_dip_file(str(path), device="cpu")
    _equal_payloads(got, jdip.preprocess_dip_file(str(path)))
    np.testing.assert_allclose(got["nimble_qdq"][:, :3],
                               [[0, 0, 0.95]] * len(got["nimble_qdq"]),
                               atol=1e-12)


def test_preprocess_tc_pair_equals_tip_tpus(tmp_path):
    rng = np.random.default_rng(3)
    _write_npz(tmp_path / "acting1_poses.npz", *make_motion(rng, T=70,
                                                              fps=60.0))
    _dip_pkl(tmp_path / "s1_acting1.pkl", 69, rng, tc=True)
    args = (str(tmp_path / "acting1_poses.npz"),
            str(tmp_path / "s1_acting1.pkl"))
    _equal_payloads(tdip.preprocess_tc_pair(*args, device="cpu"),
                    jdip.preprocess_tc_pair(*args))


def test_dip_synthetic_root_equals_tip_tpus():
    """DIP motions (no translation) get the upright z-up root."""
    poses = np.zeros((80, 24, 3))
    poses[:, 0] = np.random.default_rng(1).normal(size=3) * 0.1
    got = tdip._qdq_from_gt(tsmpl.SmplMotion(poses, None, 60.0), False,
                            device="cpu")
    want = jdip._qdq_from_gt(jsmpl.SmplMotion(poses, None, 60.0), False)
    np.testing.assert_allclose(got, want, atol=TOL_QDQ, rtol=0)
    assert 1.9 < np.linalg.norm(got[0, 3:6]) < 2.3


def test_augment_and_split_equal_tip_tpus(tmp_path):
    """augment_with_sbp merges SBP pickles into the motions and
    copy_train_split keeps subjects 1-8, as tip_tpu's (synthetic labels:
    the shipped ones are not in the repo)."""
    rng = np.random.default_rng(0)
    motions, sbp = tmp_path / "m", tmp_path / "c"
    motions.mkdir()
    sbp.mkdir()
    for n in ("dipimu_s_01_01", "dipimu_s_01_02", "dipimu_s_09_01",
              "dipimu_s_10_03"):
        T = int(rng.integers(20, 40))
        with open(motions / f"{n}.pkl", "wb") as f:
            pickle.dump({"imu": rng.normal(size=(T, 72)),
                         "nimble_qdq": rng.normal(size=(T, 114))}, f)
        if n != "dipimu_s_01_02":           # no labels: skipped
            with open(sbp / f"{n}.pkl", "wb") as f:
                pickle.dump({"constrs": rng.normal(size=(T, 20))}, f)
    for side, lib in (("t", tdip), ("j", jdip)):
        out = tmp_path / f"{side}_with_c"
        assert lib.augment_with_sbp(str(motions), str(sbp), str(out)) == 3
        assert lib.augment_with_sbp(str(motions), str(sbp), str(out)) == 0
        assert lib.copy_train_split(str(out)) == 1
    for d in ("with_c", "with_c_train"):
        names = sorted(os.listdir(tmp_path / f"t_{d}"))
        assert names == sorted(os.listdir(tmp_path / f"j_{d}"))
        for n in names:
            got, want = (_load(tmp_path / f"{s}_{d}" / n) for s in "tj")
            assert set(got) == set(want) == {"imu", "nimble_qdq", "constrs"}
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
    assert os.listdir(tmp_path / "t_with_c_train") == ["dipimu_s_01_01.pkl"]


def test_preprocess_dip_cli_equals_tip_tpus(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    src = tmp_path / "DIP_IMU"
    for s, k in (("s_01", "01"), ("s_09", "02")):
        (src / s).mkdir(parents=True)
        _dip_pkl(src / s / f"{k}.pkl", 40, rng)
    got = tprep.main(["--dip", "--src_dir", str(src), "--save_dir",
                      str(tmp_path / "t"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["preprocess_dip", "--dip", "--src_dir",
                                      str(src), "--save_dir",
                                      str(tmp_path / "j")])
    jprep.main()
    names = sorted(os.listdir(tmp_path / "t"))
    assert got == 2 and names == sorted(os.listdir(tmp_path / "j"))
    assert names == ["dipimu_s_01_01.pkl", "dipimu_s_09_02.pkl"]
    for n in names:
        _equal_payloads(_load(tmp_path / "t" / n), _load(tmp_path / "j" / n))
    assert tprep.main(["--dip", "--src_dir", str(src), "--save_dir",
                       str(tmp_path / "t"), "--device", "cpu"]) == 0
