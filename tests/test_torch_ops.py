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
