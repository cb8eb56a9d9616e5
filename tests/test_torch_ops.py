"""The port's numeric ops (tip_tpu_torch.ops) against tip_tpu's, in float64.

Same inputs, made from a seed with numpy, go through both packages; every
function agrees to 1e-12 (the two differ only in summation order and in
tip_tpu's cos written as sin(pi/2 - x)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from tip_tpu.ops import imu as jimu
from tip_tpu.ops import kinematics as jkin
from tip_tpu.ops import rotations as jrot
from tip_tpu.ops import sbp as jsbp
from tip_tpu_torch.ops import imu as timu
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.ops import rotations as trot
from tip_tpu_torch.ops import sbp as tsbp

torch.set_num_threads(1)

ATOL = 1e-12


def _close(t, j, atol=ATOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), atol=atol, rtol=0)


def _matrices(rng, n):
    """Random rotations plus the Shepperd branch cases: identity, near-pi
    about each axis and about a random axis, exact pi about x/y/z."""
    aa = rng.normal(size=(n, 3))
    extra = [np.zeros(3)]
    for axis in np.eye(3):
        extra += [axis * (np.pi - 1e-4), axis * np.pi]
    ax = rng.normal(size=3)
    extra.append(ax / np.linalg.norm(ax) * (np.pi - 1e-7))
    aa = np.concatenate([aa, np.stack(extra)])
    return Rotation.from_rotvec(aa).as_matrix()


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

UNARY = {
    "aa_to_q": lambda rng: rng.normal(size=(64, 3)),
    "q_to_aa": lambda rng: rng.normal(size=(64, 4)) / 2.0,
    "q_normalize": lambda rng: rng.normal(size=(64, 4)),
    "q_conj": lambda rng: rng.normal(size=(64, 4)),
    "q_to_matrix": lambda rng: rng.normal(size=(64, 4)),
    "matrix_to_q": lambda rng: _matrices(rng, 64),
    "matrix_to_aa": lambda rng: _matrices(rng, 64),
    "aa_to_sixd": lambda rng: rng.normal(size=(8, 7, 3)),
    "sixd_to_matrix": lambda rng: rng.normal(size=(64, 6)),
    "sixd_to_aa": lambda rng: rng.normal(size=(64, 6)),
    "aa_to_matrix": lambda rng: rng.normal(size=(64, 3)) * 2.0,
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_rotation_unary_matches_tip_tpu(name):
    x = UNARY[name](np.random.default_rng(len(name)))
    _close(getattr(trot, name)(_t(x)), getattr(jrot, name)(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["q_mult", "q_rotate"])
def test_rotation_binary_matches_tip_tpu(name):
    rng = np.random.default_rng(7)
    a = rng.normal(size=(5, 9, 4))
    b = rng.normal(size=(5, 9, 4 if name == "q_mult" else 3))
    _close(getattr(trot, name)(_t(a), _t(b)),
           getattr(jrot, name)(jnp.asarray(a), jnp.asarray(b)))


def test_angular_velocity_matches_tip_tpu():
    rng = np.random.default_rng(8)
    q1 = Rotation.random(64, random_state=1).as_quat()
    q2 = Rotation.from_rotvec(rng.normal(size=(64, 3)) * 0.05).as_quat()
    q2 = (Rotation.from_quat(q2) * Rotation.from_quat(q1)).as_quat()
    q2[::2] *= -1.0                           # both branches of the sign pick
    _close(trot.angular_velocity_from_quats(_t(q1), _t(q2), 1 / 60.0),
           jrot.angular_velocity_from_quats(jnp.asarray(q1),
                                            jnp.asarray(q2), 1 / 60.0),
           atol=1e-10)                        # /dt scales rounding by 60


def test_small_angles_use_the_series():
    """Below 1e-6 rad both codecs take their series branch."""
    aa = np.array([[0.0, 0.0, 0.0], [1e-9, -2e-9, 3e-9], [3e-7, 0.0, 0.0]])
    _close(trot.aa_to_q(_t(aa)), jrot.aa_to_q(jnp.asarray(aa)))
    q = np.array([[1e-9, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, -1.0]])
    _close(trot.q_to_aa(_t(q)), jrot.q_to_aa(jnp.asarray(q)))


def test_matrix_to_q_tie_break_and_sign():
    """Exact ties pick the first candidate (argmax's rule) and w == 0 keeps
    the sign +1: a pi rotation about x has tw == ty == tz == 0 < tx."""
    m = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]),
                  np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])])
    got = trot.matrix_to_q(_t(m)).numpy()
    _close(got, jrot.matrix_to_q(jnp.asarray(m)), atol=0.0)
    np.testing.assert_array_equal(got, [[0, 0, 0, 1], [1, 0, 0, 0],
                                        [0, 1, 0, 0], [0, 0, 1, 0]])


# ---------------------------------------------------------------------------
# imu, kinematics, sbp
# ---------------------------------------------------------------------------

def test_imu_rotate_to_local_matches_tip_tpu():
    rng = np.random.default_rng(9)
    imu = rng.normal(size=(3, 17, 72))
    imu[..., :54] = Rotation.random(3 * 17 * 6, random_state=2).as_matrix() \
        .reshape(3, 17, 54)
    _close(timu.imu_rotate_to_local(_t(imu)),
           jimu.imu_rotate_to_local(jnp.asarray(imu)))


@pytest.mark.parametrize("size", [4, 11])
def test_uniform_filter1d_nearest_matches_tip_tpu(size):
    x = np.random.default_rng(size).normal(size=(5, 30, 3))
    _close(timu.uniform_filter1d_nearest(_t(x), size, 1),
           jimu.uniform_filter1d_nearest(jnp.asarray(x), size, 1))


def test_windowed_acc_sum_and_central_diff_match_tip_tpu():
    rng = np.random.default_rng(12)
    acc = rng.normal(size=(90, 18))
    _close(timu.windowed_acc_sum(_t(acc)),
           jimu.windowed_acc_sum(jnp.asarray(acc)))
    pos = rng.normal(size=(50, 6, 3))
    _close(timu.central_diff_acc(_t(pos)),
           jimu.central_diff_acc(jnp.asarray(pos)), atol=1e-9)  # / dt^2


@pytest.mark.parametrize("lead", [(), (4,), (2, 3)])
def test_fk_our_state_matches_tip_tpu(lead):
    rng = np.random.default_rng(10)
    s = rng.normal(size=lead + (114,)) * 0.5
    jskel = jkin.amass_skeleton(scale=1.1, dtype=jnp.float64)
    tskel = tkin.amass_skeleton(scale=1.1, dtype=torch.float64)
    t_com, t_jf = tkin.fk_our_state(tskel, _t(s), return_joint_frame=True)
    j_com, j_jf = jkin.fk_our_state(jskel, jnp.asarray(s),
                                    return_joint_frame=True)
    _close(t_com, j_com)
    _close(t_jf, j_jf)


def test_levels_matches_tip_tpu():
    parent = tuple(int(p) for p in jkin.amass_skeleton().parent)
    assert tkin._levels(parent) == jkin._levels(parent)
    shuffled = (2, -1, 1, 2)          # a child listed before its parent
    assert tkin._levels(shuffled) == jkin._levels(shuffled)
    with pytest.raises(ValueError):
        tkin._levels((1, 0))


@pytest.mark.parametrize("seed", range(4))
def test_root_correction_matches_tip_tpu(seed):
    rng = np.random.default_rng(20 + seed)
    jskel = jkin.amass_skeleton(dtype=jnp.float64)
    tskel = tkin.amass_skeleton(dtype=torch.float64)
    s = rng.normal(size=114) * 0.4
    prev = s + rng.normal(size=114) * 0.01
    c = rng.normal(size=(5, 4)) * 0.05
    c[:, 0] = rng.integers(0, 2, size=5)
    if seed == 0:
        c[:2, 0] = 0.0                        # no foot active: vel_res = 0
    c = c.reshape(-1)
    j_prev = jkin.fk_our_state(jskel, jnp.asarray(prev))
    j_cur = jkin.fk_our_state(jskel, jnp.asarray(s))
    j = jsbp.root_correction_from_constrs(j_prev, j_cur, jnp.asarray(c))
    t = tsbp.root_correction_from_constrs(
        tkin.fk_our_state(tskel, _t(prev)), tkin.fk_our_state(tskel, _t(s)),
        _t(c))
    np.testing.assert_array_equal(t.active.numpy(), np.asarray(j.active))
    np.testing.assert_array_equal(np.isnan(t.raw_residues.numpy()),
                                  np.isnan(np.asarray(j.raw_residues)))
    # residues divide by dt = 1/60
    _close(t.raw_residues, j.raw_residues, atol=1e-10)
    _close(t.vel_res, j.vel_res, atol=1e-10)
    _close(t.c_locs, j.c_locs)


# ---------------------------------------------------------------------------
# rotations: q_inv, q_diff, slerp
# ---------------------------------------------------------------------------

def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("name", ["q_inv", "q_diff"])
def test_q_inv_q_diff_match_tip_tpu(name):
    rng = np.random.default_rng(20)
    a, b = _unit_quats(rng, 32), _unit_quats(rng, 32)
    args = (a,) if name == "q_inv" else (a, b)
    _close(getattr(trot, name)(*(_t(x) for x in args)),
           getattr(jrot, name)(*(jnp.asarray(x) for x in args)))
    # q ∘ q⁻¹ is the identity rotation
    ident = trot.q_diff(_t(a), _t(a)).numpy()
    np.testing.assert_allclose(ident, np.tile([0, 0, 0, 1.0], (32, 1)),
                               atol=1e-12)


@pytest.mark.parametrize("t", [0.0, 0.3, 1.0])
def test_slerp_matches_tip_tpu(t):
    """Random pairs, plus the near-parallel pair (linear branch), the same
    quaternion twice and an antipodal pair (sign flip)."""
    rng = np.random.default_rng(21)
    q0, q1 = _unit_quats(rng, 16), _unit_quats(rng, 16)
    q1[0] = q0[0] + 1e-9
    q1[0] /= np.linalg.norm(q1[0])
    q1[1] = q0[1]
    q1[2] = -q0[2]
    got = trot.slerp(_t(q0), _t(q1), t)
    _close(got, jrot.slerp(jnp.asarray(q0), jnp.asarray(q1), t))
    _close(torch.linalg.vector_norm(got, dim=-1), np.ones(16))
    # a tensor t broadcasts like a scalar
    got_t = trot.slerp(_t(q0), _t(q1), torch.full((16, 1), t,
                                                  dtype=torch.float64))
    _close(got_t, got.numpy())


# ---------------------------------------------------------------------------
# URDF skeleton
# ---------------------------------------------------------------------------

def test_skeleton_from_urdf_matches_tip_tpu(tmp_path):
    """The generated AMASS URDF through the port's own parser copy and
    skeleton_from_urdf: the same tables as tip_tpu's, and FK over it equals
    tip_tpu's FK over its URDF skeleton."""
    from tip_tpu.utils import urdf as jurdf
    from tip_tpu.viz import urdf_export
    from tip_tpu_torch.utils import urdf as turdf

    path = str(tmp_path / "amass.urdf")
    urdf_export.skeleton_to_urdf(path)
    ju = jurdf.parse_urdf(path, prefer_native=False)
    tu = turdf.parse_urdf(path, prefer_native=False)
    assert tu.joint_names == ju.joint_names
    for f in ("parent", "joint_offset", "joint_rpy", "is_fixed", "com_offset",
              "link_mass"):
        np.testing.assert_array_equal(getattr(tu, f), getattr(ju, f), f)
    jskel = jkin.skeleton_from_urdf(ju, scale=1.1, dtype=jnp.float64)
    tskel = tkin.skeleton_from_urdf(tu, scale=1.1, dtype=torch.float64)
    assert tskel.parent == tuple(jskel.parent)
    assert tskel.is_fixed == tuple(jskel.is_fixed)
    assert tkin.fk_plan(tskel.parent) == tkin.fk_plan(tkin.amass_skeleton()
                                                     .parent)
    _close(tskel.joint_offset, jskel.joint_offset)
    _close(tskel.com_offset, jskel.com_offset)
    _close(tskel.link_mass, jskel.link_mass)
    tkin.check_pose_skeleton(tskel, "fk")      # fits kernels K3 and K6
    s = np.random.default_rng(22).normal(size=114) * 0.3
    _close(tkin.fk_our_state(tskel, _t(s)),
           jkin.fk_our_state(jskel, jnp.asarray(s)))


def test_skeleton_from_urdf_rejects_joint_rpy(tmp_path):
    from tip_tpu.viz import urdf_export
    from tip_tpu_torch.utils import urdf as turdf

    path = str(tmp_path / "amass.urdf")
    urdf_export.skeleton_to_urdf(path)
    u = turdf.parse_urdf(path, prefer_native=False)
    u.joint_rpy[3, 1] = 0.2
    with pytest.raises(NotImplementedError, match="rpy"):
        tkin.skeleton_from_urdf(u)


def test_urdf_parser_copy_forward_refs_and_undeclared_link(tmp_path):
    """The port's parser copy resolves a child joint listed before its
    parent joint and rejects an undeclared link, like tip_tpu's."""
    from tip_tpu.utils import urdf as jurdf
    from tip_tpu_torch.utils import urdf as turdf

    text = """<?xml version="1.0"?>
<robot name="t">
  <link name="base"><inertial><origin xyz="0 0 0"/><mass value="1"/></inertial></link>
  <link name="a"><inertial><origin xyz="0.1 0 0"/><mass value="2"/></inertial></link>
  <link name="b"><inertial><origin xyz="0 0.2 0"/><mass value="3"/></inertial></link>
  <joint name="j_ab" type="spherical">
    <origin xyz="0 0 0.5"/><parent link="a"/><child link="b"/>
  </joint>
  <joint name="j_base_a" type="fixed">
    <origin xyz="0 0 1"/><parent link="base"/><child link="a"/>
  </joint>
</robot>
"""
    p = tmp_path / "fwd.urdf"
    p.write_text(text)
    t, j = turdf._parse_python(str(p)), jurdf._parse_python(str(p))
    np.testing.assert_array_equal(t.parent, [1, -1])
    for f in ("parent", "joint_offset", "is_fixed", "com_offset", "link_mass"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    bad = tmp_path / "bad.urdf"
    bad.write_text(text.replace('<child link="b"/>', '<child link="bb"/>'))
    with pytest.raises(ValueError, match="undeclared"):
        turdf._parse_python(str(bad))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

METRICS = ["loss_angle", "loss_j_pos", "loss_global_angle", "loss_max_jerk",
           "loss_root_jerk", "loss_sip", "loss_root_dist_pos"]


@pytest.fixture(scope="module")
def metric_trajs():
    """Two (T, 57) bullet-pose trajectories (a smooth one and a perturbed
    copy) with their (T, 20, 7) FK frames."""
    rng = np.random.default_rng(23)
    T = 90
    a1 = np.cumsum(rng.normal(size=(T, 57)) * 0.02, axis=0)
    a1[:, 2] += 0.9
    a2 = a1 + rng.normal(size=(T, 57)) * 0.05
    skel = jkin.amass_skeleton(dtype=jnp.float64)
    pq = [np.array(jkin.fk_bullet_state(skel, jnp.asarray(a)))
          for a in (a1, a2)]
    return a1, a2, pq[0], pq[1]


@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_tip_tpu(metric_trajs, name):
    from tip_tpu.ops import metrics as jmet
    from tip_tpu_torch.ops import metrics as tmet

    a1, a2, pq1, pq2 = metric_trajs
    j = getattr(jmet, name)(*(jnp.asarray(x) for x in metric_trajs))
    t = getattr(tmet, name)(*(_t(x) for x in metric_trajs))
    assert t.shape == () and float(t) > 0.0
    _close(t, j, atol=1e-10)
    # identical trajectories: no error; the jerks read traj 2 only
    same = getattr(tmet, name)(_t(a2), _t(a2), _t(pq2), _t(pq2))
    if "jerk" in name:
        _close(same, t.numpy())
    else:
        assert abs(float(same)) < 1e-5


def test_root_dist_pos_clamps_the_index(metric_trajs):
    from tip_tpu.ops import metrics as jmet
    from tip_tpu_torch.ops import metrics as tmet

    short = [x[:20] for x in metric_trajs]
    _close(tmet.loss_root_dist_pos(*(_t(x) for x in short), t=2.0),
           jmet.loss_root_dist_pos(*(jnp.asarray(x) for x in short), t=2.0))
