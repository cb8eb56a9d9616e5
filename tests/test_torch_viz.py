"""The port's viewers and renderer (tip_tpu_torch.viz, cli/render.py and
the viewer flags of cli/evaluate and cli/live_demo) against tip_tpu's, on
the CPU: the URDF text byte for byte, the renderer's links in float64, the
plots and GIFs written, and the PyBullet viewer driven through a fake
pybullet module (a copy of tests/test_viz_wiring.py's, the wheel being no
dependency of either package)."""

import json
import os
import pickle
import shutil
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.ops import kinematics as jkin
from tip_tpu.viz import plots as jplots
from tip_tpu.viz import skeleton_render as JSR
from tip_tpu.viz import urdf_export as jurdf
from tip_tpu_torch.cli import evaluate as TCE
from tip_tpu_torch.cli import live_demo as TLD
from tip_tpu_torch.cli import render as TCR
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.ops import sbp as tsbp
from tip_tpu_torch.runtime import terrain as tterrain
from tip_tpu_torch.train import train as TT
from tip_tpu_torch.viz import plots as tplots
from tip_tpu_torch.viz import pybullet_viz as tpb
from tip_tpu_torch.viz import skeleton_render as TSR
from tip_tpu_torch.viz import urdf_export as turdf

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CORPUS = ROOT / "artifacts" / "corpus_run_v3" / "corpus_extra"


class _FakePB(types.ModuleType):
    """Minimal pybullet stand-in recording every call."""

    GUI, DIRECT = 1, 2
    GEOM_SPHERE, GEOM_HEIGHTFIELD = 2, 9
    URDF_MAINTAIN_LINK_ORDER = 131072

    def __init__(self):
        super().__init__("pybullet")
        self.calls = []
        self._bodies = 0
        self._shapes = 0

    def connect(self, mode):
        self.calls.append(("connect", mode))
        return 0

    def disconnect(self, client):
        self.calls.append(("disconnect", client))

    def loadURDF(self, path, pos, useFixedBase=False, flags=0):
        self.calls.append(("loadURDF", path))
        self._bodies += 1
        return self._bodies

    def getNumJoints(self, body):
        return 19

    def changeVisualShape(self, body, link, rgbaColor=None):
        self.calls.append(("color", body, link))

    def createVisualShape(self, kind, radius=None, rgbaColor=None):
        self._shapes += 1
        return self._shapes

    def createCollisionShape(self, shapeType=None, meshScale=None,
                             heightfieldData=None, numHeightfieldRows=0,
                             numHeightfieldColumns=0,
                             replaceHeightfieldIndex=None):
        self.calls.append(("heightfield", numHeightfieldRows,
                           numHeightfieldColumns,
                           replaceHeightfieldIndex))
        self._shapes += 1
        return self._shapes

    def createMultiBody(self, mass=0, baseVisualShapeIndex=None):
        self._bodies += 1
        return self._bodies

    def resetBasePositionAndOrientation(self, body, pos, quat):
        self.calls.append(("base", body, tuple(np.asarray(pos))))

    def resetJointStatesMultiDof(self, body, joints, quats, vels):
        self.calls.append(("joints", body, len(joints), len(quats)))


@pytest.fixture()
def fake_pb(monkeypatch):
    pb = _FakePB()
    monkeypatch.setitem(sys.modules, "pybullet", pb)
    return pb


def _motion(i=0):
    with open(CORPUS / f"freeform2_{i:04d}.pkl", "rb") as f:
        return pickle.load(f)    # in-tree motion written by data gen


# ---------------------------------------------------------------------------
# the URDF exporter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"robot_name": "other",
                                     "bone_radius": 0.05}])
def test_urdf_text_is_tip_tpus_byte_for_byte(kw, tmp_path):
    text = turdf.skeleton_to_urdf(str(tmp_path / "t.urdf"), **kw)
    assert text == jurdf.skeleton_to_urdf(str(tmp_path / "j.urdf"), **kw)
    assert (tmp_path / "t.urdf").read_bytes() == \
        (tmp_path / "j.urdf").read_bytes()


def test_urdf_export_roundtrip(tmp_path):
    """The port's parse_urdf(skeleton_to_urdf(...)) == the source tables,
    and the default path holds the same text."""
    from tip_tpu_torch.chars import amass as amass_char
    from tip_tpu_torch.chars import amass_skeleton as tbl
    from tip_tpu_torch.utils.urdf import parse_urdf
    path = str(tmp_path / "gen.urdf")
    turdf.skeleton_to_urdf(path)
    sk = parse_urdf(path, prefer_native=False)
    assert sk.joint_names == list(amass_char.JOINT_NAMES)
    np.testing.assert_array_equal(sk.parent, tbl.PARENT)
    np.testing.assert_allclose(sk.joint_offset, tbl.JOINT_OFFSET, atol=1e-7)
    np.testing.assert_array_equal(sk.is_fixed, tbl.IS_FIXED)
    np.testing.assert_allclose(sk.com_offset, tbl.COM_OFFSET, atol=1e-7)
    np.testing.assert_allclose(sk.link_mass, tbl.LINK_MASS, atol=1e-7)
    with open(turdf.default_urdf_path()) as f:
        assert f.read() == turdf.skeleton_to_urdf()


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames", [slice(0, 1), slice(0, 40, 3)])
def test_skeleton_links_match_tip_tpu(frames):
    qdq = np.asarray(_motion()["nimble_qdq"], np.float64)[frames]
    got = TSR.fk_links(tkin.amass_skeleton(dtype=torch.float64), qdq)
    want = np.asarray(JSR._fk_links(jkin.amass_skeleton(dtype=np.float64),
                                    jnp.asarray(qdq)))
    assert got.shape == want.shape == (len(qdq), 20, 3)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    np.testing.assert_array_equal(
        TSR.bone_segments(tkin.amass_skeleton()),
        JSR.bone_segments(jkin.amass_skeleton()))


def _walk(T=13):
    qdq = np.tile(np.asarray(_motion()["nimble_qdq"][0], np.float32), (T, 1))
    qdq[:, 0] = np.linspace(0.0, 1.0, T)          # walk +x
    return qdq


def test_skeleton_render_frames_and_gif(tmp_path):
    """Frames are RGB images that track the pose; the GIF and PNG writers
    write files; SBP markers and the terrain draw."""
    skel = tkin.amass_skeleton()
    qdq = _walk()
    f0 = TSR.render_frame(skel, qdq[0])
    fN = TSR.render_frame(skel, qdq[-1], gt_qdq=qdq[0])
    assert f0.dtype == np.uint8 and f0.ndim == 3 and f0.shape[2] == 3
    assert f0.shape == fN.shape and (f0 != fN).any() and f0.std() > 1.0

    tcfg = tterrain.TerrainConfig(map_bound=3.0)
    ts = tterrain.terrain_init(tcfg, device="cpu")
    ts, _ = tterrain.update_height_map(
        ts, tcfg, torch.tensor([0.5, 0.0, 0.2]), torch.tensor(True))
    locs = np.full((5, 3), 100.0)
    locs[0] = [0.5, 0.0, 0.2]                      # one active SBP
    fT = TSR.render_frame(skel, qdq[0], sbp_locs=locs, terrain_state=ts,
                          terrain_cfg=tcfg)
    assert (fT != f0).any()

    gif = tmp_path / "walk.gif"
    assert TSR.render_motion(skel, qdq, str(gif), gt_qdq=qdq, stride=4) == 4
    assert os.path.getsize(gif) > 5000
    pngs = tmp_path / "f_%02d.png"
    assert TSR.render_motion(skel, qdq[:5], str(pngs), stride=4) == 2
    assert os.path.getsize(tmp_path / "f_01.png") > 1000


def test_render_eval_dump(tmp_path):
    qdq = _walk(9)
    dump = tmp_path / "trajs.pkl"
    with open(dump, "wb") as fh:
        pickle.dump({"gt_list": [qdq], "ours_list": [qdq + 0.01],
                     "files": ["m0"]}, fh)
    assert TSR.render_eval_dump(str(dump), str(tmp_path / "d.gif"),
                                device="cpu", stride=4) == 3


@pytest.mark.parametrize("src", ["dump", "motion_pkl"])
def test_render_cli(src, tmp_path, capsys):
    qdq = _walk(9)
    qdq[:, 1] = np.linspace(0.0, 0.5, 9)
    if src == "dump":
        path = tmp_path / "trajs.pkl"
        payload = {"gt_list": [qdq], "ours_list": [qdq + 0.01],
                   "files": ["m0"]}
        extra = []
    else:
        path = tmp_path / "motion.pkl"
        payload = {"nimble_qdq": qdq}
        extra = ["--max_frames", "5"]
    with open(path, "wb") as fh:
        pickle.dump(payload, fh)
    out = tmp_path / f"{src}.gif"
    n = TCR.main([f"--{src}", str(path), "--out", str(out), "--stride", "4",
                  "--device", "cpu", *extra])
    assert n == (3 if src == "dump" else 2)
    assert os.path.getsize(out) > 3000
    assert f"rendered {n} frames" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the plots
# ---------------------------------------------------------------------------

def _lankle(d):
    """The left ankle's CoM-frame (p, q) track and its SBP labels."""
    pq = tkin.fk_our_state(tkin.amass_skeleton(dtype=torch.float64),
                           torch.as_tensor(np.asarray(d["nimble_qdq"],
                                                      np.float64)))
    return (pq[:, tsbp.SBP_PQ_ROWS[0]].numpy(),
            np.asarray(d["constrs"], np.float64)[:, :4])


def test_residue_drift_matches_tip_tpu(tmp_path):
    """The drift, batched over frames in the port, equals tip_tpu's
    frame-by-frame plot's in float64; labelled contacts drift little."""
    d = _motion()
    pq, c = _lankle(d)
    pq, c = pq[:240], c[:240]
    assert c[:, 0].sum() > 10
    got = tplots.plot_sbp_residue_drift(pq, c, str(tmp_path / "t.png"),
                                        device="cpu")
    want = jplots.plot_sbp_residue_drift(pq, c, str(tmp_path / "j.png"))
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert np.abs(got).max() < 0.5
    assert os.path.getsize(tmp_path / "t.png") > 1000


@pytest.mark.parametrize("plot", ["sbp_labels", "imu_overlay", "terrain"])
def test_plots_are_written(plot, tmp_path):
    d = _motion()
    out = tmp_path / f"{plot}.png"
    if plot == "sbp_labels":
        tplots.plot_sbp_labels(np.asarray(d["constrs"]), str(out))
    elif plot == "imu_overlay":
        imu = np.asarray(d["imu"])
        tplots.plot_imu_overlay(imu, imu * 0.98, str(out))
    else:
        h = np.zeros((40, 40))
        h[10:20, 5:15] = 0.3
        tplots.plot_terrain(h, str(out))
    assert os.path.getsize(out) > 1000


# ---------------------------------------------------------------------------
# the PyBullet viewer
# ---------------------------------------------------------------------------

def test_viewer_and_replay_compare(fake_pb, tmp_path):
    urdf = str(tmp_path / "amass.urdf")
    turdf.skeleton_to_urdf(urdf)
    v = tpb.Viewer(urdf, gui=False, n_markers=10, compare_gt=True)
    assert sum(1 for c in fake_pb.calls if c[0] == "loadURDF") == 2
    T, rng = 31, np.random.default_rng(0)
    pred = rng.normal(size=(T, 57)) * 0.1
    gt = rng.normal(size=(T, 57)) * 0.1
    tpb.replay_compare(v, pred, gt, viz_locs=rng.normal(size=(T, 5, 3)),
                       heights=np.zeros((16, 16)), grid_size=0.1, fps=None)
    joints = [c for c in fake_pb.calls if c[0] == "joints"]
    assert len(joints) == 2 * T and all(c[2] == 17 for c in joints)
    hf = [c for c in fake_pb.calls if c[0] == "heightfield"]
    assert len(hf) == int(np.ceil(T / 15))
    assert hf[0][3] is None and hf[1][3] is not None
    v.close()


def test_viewer_without_pybullet_names_it_and_the_flags(monkeypatch):
    monkeypatch.setitem(sys.modules, "pybullet", None)
    with pytest.raises(ImportError, match="pybullet is not installed; the "
                       "viewer \\(cli/evaluate --viz_compare, cli/live_demo "
                       "--viz\\)"):
        tpb.Viewer(turdf.default_urdf_path(), gui=False)


def test_renderer_without_matplotlib_names_it_and_the_flags(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib is not installed; the "
                       "renderer \\(cli/evaluate --render_gifs, "
                       "cli/render\\)"):
        TSR.render_frame(tkin.amass_skeleton(), _walk(1)[0])


# ---------------------------------------------------------------------------
# the CLIs' viewer flags
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """A checkpoint of this package at the CLIs' widths (5 SBPs, acc-sum)."""
    d = tmp_path_factory.mktemp("ckpt")
    st = TT.init_state(TT.TrainConfig(model=TM.ModelConfig(
        with_acc_sum=True)), device="cpu")
    TT.save_checkpoint(str(d), st, 0)
    return str(d)


def test_cli_evaluate_viz_compare_and_render_gifs(fake_pb, port_ckpt,
                                                  tmp_path):
    """--viz_compare replays each motion (ours and GT, SBP markers, the
    full runner's terrain) and --render_gifs writes a GIF a motion, the two
    hooks chained as tip_tpu's; the metrics are those of a run without
    them."""
    data = tmp_path / "data"
    (data / "syn_AMASS_CMU_v0").mkdir(parents=True)
    shutil.copy(CORPUS / "freeform2_0002.pkl", data / "syn_AMASS_CMU_v0")
    common = ["--ckpt", port_ckpt, "--data_root", str(data),
              "--name_contains", "freeform2", "--test_len", "100",
              "--five_sbp", "--with_acc_sum", "--full_runner",
              "--device", "cpu"]
    gifs = tmp_path / "gifs"
    _, means, _ = TCE.main(common + ["--viz_compare", "--render_gifs",
                                     str(gifs), "--render_stride", "20"])
    assert os.path.getsize(gifs / "freeform2_0002.gif") > 5000
    joints = [c for c in fake_pb.calls if c[0] == "joints"]
    frames = len(joints) // 2
    assert frames > 20 and len(joints) == 2 * frames
    assert [c for c in fake_pb.calls if c[0] == "heightfield"]
    _, plain_means, _ = TCE.main(common)
    assert means == plain_means


def test_cli_live_demo_viz(fake_pb, port_ckpt, tmp_path):
    """--viz shows each frame's pose and SBP markers and the terrain every
    15 frames."""
    import torch_wire as W
    server = W.ReplayServer(W.wire_frames(np.asarray(_motion()["imu"][:200])),
                            hz=60.0)
    out = tmp_path / "poses.jsonl"
    try:
        frames, _ = TLD.main([
            "--ckpt", port_ckpt, "--port", str(server.port), "--five_sbp",
            "--with_acc_sum", "--skip_calibration", "--seconds", "1.0",
            "--out", str(out), "--viz", "--device", "cpu"])
    finally:
        server.stop()
    joints = [c for c in fake_pb.calls if c[0] == "joints"]
    assert frames > 5 and len(joints) == frames
    assert len([c for c in fake_pb.calls if c[0] == "heightfield"]) == \
        -(-frames // 15)
    poses = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(poses) == frames


@pytest.mark.parametrize("entry", ["render_cli", "render_eval_dump",
                                   "residue_drift"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "render_cli":
            TCR.main(["--motion_pkl", str(tmp_path / "m.pkl"), "--out",
                      str(tmp_path / "o.gif")])
        elif entry == "render_eval_dump":
            TSR.render_eval_dump(str(CORPUS / "freeform2_0000.pkl"),
                                 str(tmp_path / "o.gif"))
        else:
            tplots.sbp_residue_drift(np.zeros((3, 7)), np.zeros((3, 4)))
