"""The port's PD-family torques and seeding (tip_tpu_torch.ops.dynamics,
tip_tpu_torch.utils.seeding) against tip_tpu's, on the CPU: the same
seeded inputs through both in float64, and the properties of
tests/test_dynamics.py as parametrised cases."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from tip_tpu.ops import dynamics as jdyn
from tip_tpu_torch.ops import dynamics as tdyn
from tip_tpu_torch.utils import seeding as tseed

torch.set_num_threads(1)

J = 19
MODES = ["SPD", "PD", "CPD", "CP", "V"]


def _inputs(seed, lead=(), scale=0.4):
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead, dtype=int)) * J
    q_cur = Rotation.from_rotvec(rng.normal(size=(n, 3)) * scale).as_quat()
    q_des = Rotation.from_rotvec(rng.normal(size=(n, 3)) * scale).as_quat()
    shape = lead + (J,)
    return (q_cur.reshape(shape + (4,)), q_des.reshape(shape + (4,)),
            rng.normal(size=shape + (3,)), rng.normal(size=shape + (3,)))


def _t(*a):
    return [torch.as_tensor(x, dtype=torch.float64) for x in a]


def _j(*a):
    return [jnp.asarray(x, jnp.float64) for x in a]


@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_pd_torques_match_tip_tpu(lead, seed):
    args = _inputs(seed, lead)
    got = tdyn.pd_torques(*_t(*args))
    want = np.asarray(jdyn.pd_torques(*_j(*args)))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("dt", [0.0, 1.0 / 60.0, 0.1])
@pytest.mark.parametrize("lead", [(), (4,)])
def test_spd_torques_match_tip_tpu(dt, lead):
    args = _inputs(7, lead, scale=0.3)
    got = tdyn.spd_torques(*_t(*args), dt=dt)
    want = np.asarray(jdyn.spd_torques(*_j(*args), dt=dt))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_mode_gains_match_tip_tpu(mode):
    kp, kd = tdyn.mode_gains(mode, device="cpu", dtype=torch.float64)
    jkp, jkd = jdyn.mode_gains(mode)
    np.testing.assert_allclose(kp.numpy(), np.asarray(jkp), rtol=1e-15)
    np.testing.assert_allclose(kd.numpy(), np.asarray(jkd), rtol=1e-15)
    args = _inputs(3)
    got = tdyn.pd_torques(*_t(*args), kp=kp, kd=kd)
    want = np.asarray(jdyn.pd_torques(*_j(*args), kp=jkp, kd=jkd))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)


def test_mode_gains_refuse_an_unknown_mode():
    with pytest.raises(ValueError, match="TQ"):
        tdyn.mode_gains("TQ", device="cpu")


# the properties of tests/test_dynamics.py, in the port


@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_pd_torque_direction_and_clipping(scale):
    rng = np.random.default_rng(17)
    q_cur = Rotation.from_rotvec(rng.normal(size=(J, 3)) * 0.2).as_quat()
    delta = rng.normal(size=(J, 3)) * 0.05 * scale
    q_des = (Rotation.from_quat(q_cur) * Rotation.from_rotvec(delta)).as_quat()
    w = np.zeros((J, 3))
    tau = tdyn.pd_torques(*_t(q_cur, q_des, w, w)).numpy()
    lim = tdyn.MAX_FORCE.numpy()[:, None]
    assert (np.abs(tau) <= lim + 1e-9).all()
    np.testing.assert_array_equal(tau[[14, 18]], 0.0)   # fixed wrists
    if scale == 1.0:
        np.testing.assert_allclose(tau, tdyn.KP.numpy()[:, None] * delta,
                                   atol=1e-4)


def test_pd_damping_opposes_velocity():
    q = np.tile([0, 0, 0, 1.0], (J, 1))
    w_cur = np.random.default_rng(17).normal(size=(J, 3))
    tau = tdyn.pd_torques(*_t(q, q, w_cur, np.zeros((J, 3)))).numpy()
    lim = tdyn.MAX_FORCE.numpy()[:, None]
    np.testing.assert_allclose(
        tau, np.clip(-tdyn.KD.numpy()[:, None] * w_cur, -lim, lim),
        atol=1e-12)


def test_pd_torques_match_manual_numpy():
    q_cur, q_des, w_cur, w_des = _inputs(0)
    err = (Rotation.from_quat(q_cur).inv()
           * Rotation.from_quat(q_des)).as_rotvec()
    kp, kd = tdyn.KP.numpy()[:, None], tdyn.KD.numpy()[:, None]
    lim = tdyn.MAX_FORCE.numpy()[:, None]
    np.testing.assert_allclose(
        tdyn.pd_torques(*_t(q_cur, q_des, w_cur, w_des)).numpy(),
        np.clip(kp * err + kd * (w_des - w_cur), -lim, lim), atol=1e-9)


def test_spd_reduces_to_pd_at_dt_zero():
    args = _t(*_inputs(1, scale=0.3))
    torch.testing.assert_close(tdyn.spd_torques(*args, dt=0.0),
                               tdyn.pd_torques(*args), atol=1e-12, rtol=0)


@pytest.mark.parametrize("which,final", [("spd", "converges"),
                                         ("pd", "oscillates")])
def test_spd_is_stable_where_explicit_pd_oscillates(which, final):
    """Stiff gains, no explicit damping: predicted-state evaluation
    converges to the target, plain PD oscillates undamped (Tan et al.
    2011, Bullet's STABLE_PD_CONTROL)."""
    dt = 1.0 / 60.0
    kp, kd, lim = _t([2000.0], [0.0], [1e9])
    q_des = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float64)
    zero = torch.zeros((1, 3), dtype=torch.float64)
    theta, omega = 1.0, 0.0
    for _ in range(600):                   # 10 s at 60 Hz
        q = torch.as_tensor(Rotation.from_rotvec([theta, 0, 0]).as_quat())[
            None]
        w = torch.tensor([[omega, 0.0, 0.0]], dtype=torch.float64)
        if which == "spd":
            tau = tdyn.spd_torques(q, q_des, w, zero, dt=dt, kp=kp, kd=kd,
                                   max_force=lim)
        else:
            tau = tdyn.pd_torques(q, q_des, w, zero, kp=kp, kd=kd,
                                  max_force=lim)
        omega += dt * float(tau[0, 0])
        theta += dt * omega
    if final == "converges":
        assert abs(theta) < 0.02, theta
    else:
        assert abs(theta) > 0.3, theta


def test_gains_follow_the_inputs_device_and_dtype():
    args = [torch.as_tensor(a, dtype=torch.float32) for a in _inputs(2)]
    tau = tdyn.pd_torques(*args)
    assert tau.dtype == torch.float32
    assert tdyn.KP.dtype == torch.float64       # the tables stay as they are


# seeding


def test_set_seed_pins_python_numpy_and_torch():
    draws = []
    for _ in range(2):
        tseed.set_seed(5)
        draws.append((random.random(), np.random.rand(),
                      torch.rand(()).item()))
    assert draws[0] == draws[1]


def test_generator_is_seeded_on_the_device_given():
    g = tseed.generator(11, device="cpu")
    assert g.device == torch.device("cpu")
    a = torch.rand(4, generator=g)
    assert torch.equal(a, torch.rand(4, generator=tseed.generator(11, "cpu")))


@pytest.mark.parametrize("entry", ["mode_gains", "generator"])
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "mode_gains":
            tdyn.mode_gains("SPD")
        else:
            tseed.generator(0)
