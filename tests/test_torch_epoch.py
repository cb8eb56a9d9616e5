"""The port's whole-epoch training (train.make_epoch_fn) and its on-device
window sampler (data.WindowSampler, make_window_sampler,
device_sample_epoch) against tip_tpu's, on the CPU.

tip_tpu's epoch function runs its kernel configuration (encoder_impl=
"pallas", rnn_impl="pallas", dropout_impl="hash") with its Pallas kernels
in interpret mode, in float64; its noise and dropout seeds are computed
from its rng chain and handed to the port's epoch in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.train import data as JD
from tip_tpu.train import train as JT
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.train import data as TD
from tip_tpu_torch.train import train as TT

torch.set_num_threads(1)

SMALL = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
             rnn_hid_size=24)
B, T = 8, 10
# the epoch against tip_tpu's in float64 (relative)
TOL_F64 = 1e-9


def _info(n_seg=6, seg=60):
    return np.array([[i * seg, (i + 1) * seg, 1 + i % 3]
                     for i in range(n_seg)], np.int64)


def _blobs(info, seed=0):
    rng = np.random.default_rng(seed)
    n = int(info[-1, 1])
    return (rng.normal(size=(n, 72)), rng.normal(size=(n, 18)),
            rng.normal(size=(n, 131)) * 0.3)


# segment tables: uneven rates, a segment too short for one window, one
# that rounds to a single pick, and none at all
INFOS = {
    "even": _info(),
    "uneven": np.array([[0, 60, 1], [60, 75, 2], [75, 80, 1], [80, 200, 7],
                        [200, 212, 30]], np.int64),
    "empty": np.array([[0, 8, 1]], np.int64),
}


@pytest.mark.parametrize("name", sorted(INFOS))
def test_sampler_tables_equal_tip_tpus(name):
    info = INFOS[name]
    j = JD.make_window_sampler(info, T)
    t = TD.make_window_sampler(info, T, "cpu")
    assert t.n_select == j.n_select
    for k in ("cands", "seg_id", "keep"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)))
    assert t.cands.dtype == torch.int64 and t.keep.dtype == torch.bool


def _segments(info):
    """Each segment's candidate ends [lo, hi) and its k_i, as
    sample_epoch_indices draws them."""
    out = []
    for start, end, rate in info:
        lo, hi = start + T, end - 1
        n = hi - lo
        if n > 0:
            out.append((lo, hi, min(max(int(round(n / rate)), 1), n)))
    return out


def test_device_sample_epoch_properties():
    """Over 200 draws: the shape, no end twice, at most k_i ends of a
    segment, every end inside its segment; every candidate drawn at some
    point; the same generator seed gives the same ends."""
    info = INFOS["uneven"]
    sampler = TD.make_window_sampler(info, T, "cpu")
    segs = _segments(info)
    n_batches = sampler.n_select // B
    gen = torch.Generator().manual_seed(5)
    seen = set()
    for _ in range(200):
        ends = TD.device_sample_epoch(sampler, gen, n_batches, B)
        assert ends.shape == (n_batches, B) and ends.dtype == torch.int64
        flat = ends.flatten().tolist()
        assert len(set(flat)) == len(flat)
        for lo, hi, k in segs:
            assert sum(lo <= e < hi for e in flat) <= k
        assert all(any(lo <= e < hi for lo, hi, _ in segs) for e in flat)
        seen.update(flat)
    assert seen == {e for lo, hi, _ in segs for e in range(lo, hi)}
    a = TD.device_sample_epoch(sampler, torch.Generator().manual_seed(9),
                               n_batches, B)
    b = TD.device_sample_epoch(sampler, torch.Generator().manual_seed(9),
                               n_batches, B)
    assert torch.equal(a, b)
    # the whole table drawn: each segment gives exactly its k_i
    ends = TD.device_sample_epoch(sampler, gen, 1, sampler.n_select)
    for lo, hi, k in segs:
        assert int(((ends >= lo) & (ends < hi)).sum()) == k


def test_device_sample_epoch_refuses_an_epoch_too_large():
    sampler = TD.make_window_sampler(INFOS["even"], T, "cpu")
    with pytest.raises(ValueError, match="needs"):
        TD.device_sample_epoch(sampler, torch.Generator(),
                               sampler.n_select // B + 1, B)
    with pytest.raises(ValueError, match="n_batches"):
        TT.make_epoch_fn(TT.TrainConfig(), None, sampler=sampler)


def _cfgs():
    j = JT.TrainConfig(model=JM.ModelConfig(
        **SMALL, encoder_impl="pallas", rnn_impl="pallas",
        dropout_impl="hash"), batch_size=B, seq_len=T, lr=1e-3,
        optimizer="AdamW", epochs=20, seed=3)
    t = TT.TrainConfig(model=TM.ModelConfig(**SMALL), batch_size=B,
                       seq_len=T, lr=1e-3, optimizer="AdamW", epochs=20,
                       seed=3)
    return j, t


def _jax_draws(rng_key, shape, n_layers):
    """tip_tpu's body's noise and dropout seeds from its state's rng."""
    _, sub = jax.random.split(rng_key)
    k_noise, k_model = jax.random.split(sub)
    noise = (jax.random.uniform(k_noise, shape, jnp.float64) - 0.5) * 0.3
    seed0 = int(jax.random.bits(k_model, dtype=jnp.uint32).astype(jnp.int32))
    keys = jax.random.split(k_model, 2 + 4 * n_layers)
    layer = [int(jax.random.bits(keys[2 + 4 * li], dtype=jnp.uint32)
                 .astype(jnp.int32)) for li in range(n_layers)]
    return np.array(noise), (seed0, layer)


def _ends(n=3, seed=4):
    idx = TD.sample_epoch_indices(INFOS["even"], T,
                                  np.random.default_rng(seed))
    return idx[:n * B].reshape(n, B)


def _data(poison_rows=()):
    imu, acc, s = _blobs(INFOS["even"])
    imu = imu.copy()
    imu[list(poison_rows)] = np.inf
    jdd = JD.DeviceDataset(imu=jnp.asarray(imu), acc_sum=jnp.asarray(acc),
                           s=jnp.asarray(s))
    tdd = TD.DeviceDataset(imu=torch.as_tensor(imu),
                           acc_sum=torch.as_tensor(acc), s=torch.as_tensor(s))
    return jdd, tdd


def _jax_epoch(jcfg, jdd, ends):
    """tip_tpu's epoch from its f64 initial state: (params before, params
    after, aux, each batch's draws)."""
    params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float64),
        JM.init_params(jax.random.PRNGKey(0), jcfg.model))
    opt = JT.make_optimizer(jcfg)
    state = JT.TrainState(params=params, opt_state=opt.init(params),
                          step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(7))
    draws, rng = [], state.rng
    for _ in range(len(ends)):
        draws.append(_jax_draws(rng, (B, T, 131), SMALL["tf_layers"]))
        rng, _ = jax.random.split(rng)
    new, aux = JT.make_epoch_fn(jcfg, jdd)(state, jnp.asarray(ends,
                                                               jnp.int32))
    tonp = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    return (tonp(params), tonp(new.params), int(new.step),
            {k: np.asarray(v) for k, v in aux.items()}, draws)


def _port_epoch(tcfg, tdd, params0, ends, draws, monkeypatch):
    """The port's epoch from tip_tpu's initial parameters, fed tip_tpu's
    draws in the order the epoch asks for them."""
    state = TT.init_state(tcfg, "cpu", torch.float64)
    state.model.load_state_dict(TM.params_from_jax(params0))
    seeds = iter([d[1] for d in draws])
    noise = iter([torch.as_tensor(d[0]) for d in draws])
    monkeypatch.setattr(TT, "draw_seeds", lambda st: next(seeds))
    monkeypatch.setattr(TT, "draw_noise", lambda st, x_s, cfg: next(noise))
    state, aux = TT.make_epoch_fn(tcfg, tdd)(state, torch.as_tensor(ends))
    return state, {k: v.numpy() for k, v in aux.items()}


def _assert_params(model, params, tol):
    for k, v in TM.params_from_jax(params).items():
        got = model.state_dict()[k]
        err = (got - v).abs().max().item()
        assert err <= tol * max(v.abs().max().item(), 1.0), (k, err)


@pytest.fixture(scope="module")
def jax_clean():
    jcfg, _ = _cfgs()
    jdd, _ = _data()
    return _jax_epoch(jcfg, jdd, _ends())


def test_epoch_over_given_ends_matches_tip_tpu(jax_clean, monkeypatch):
    """Three batches in float64 through the hash configuration: the
    parameters after the epoch and each batch's loss, grad_norm and lr
    equal tip_tpu's epoch to 1e-9; nothing skipped."""
    _, tcfg = _cfgs()
    _, tdd = _data()
    params0, params1, step, jaux, draws = jax_clean
    state, aux = _port_epoch(tcfg, tdd, params0, _ends(), draws,
                             monkeypatch)
    assert set(aux) == set(TT.AUX)
    assert all(v.shape == (3,) for v in aux.values())
    for k in ("loss", "loss_q", "loss_c", "loss_jerk", "grad_norm", "lr"):
        np.testing.assert_allclose(aux[k], jaux[k], rtol=TOL_F64, atol=0,
                                   err_msg=k)
    assert not aux["skipped"].any() and not jaux["skipped"].any()
    assert (jaux["grad_norm"] > tcfg.clip).all()
    assert int(state.step) == step == 3
    _assert_params(state.model, params1, TOL_F64)


def test_epoch_guard_skips_a_poisoned_batch_as_tip_tpu(monkeypatch):
    """A batch whose windows hold an inf: its update is dropped on the
    device (parameters, moments and step kept), the next batch trains, and
    the state and aux equal tip_tpu's epoch, whose kept state does the
    same."""
    jcfg, tcfg = _cfgs()
    ends = _ends()
    jdd, tdd = _data(poison_rows=[int(ends[1, 0]) - 3])
    params0, params1, step, jaux, draws = _jax_epoch(jcfg, jdd, ends)
    state, aux = _port_epoch(tcfg, tdd, params0, ends, draws, monkeypatch)
    np.testing.assert_array_equal(aux["skipped"], [0.0, 1.0, 0.0])
    np.testing.assert_array_equal(jaux["skipped"], [False, True, False])
    assert not np.isfinite(aux["loss"][1]) and not np.isfinite(
        jaux["loss"][1])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(aux[k][[0, 2]], jaux[k][[0, 2]],
                                   rtol=TOL_F64, atol=0)
    assert int(state.step) == step == 2
    _assert_params(state.model, params1, TOL_F64)

    # the state after the poisoned batch is the state before it, bit for
    # bit, and the generators moved on
    state = TT.init_state(tcfg, "cpu", torch.float64)
    state.model.load_state_dict(TM.params_from_jax(params0))
    epoch = TT.make_epoch_fn(tcfg, tdd)
    monkeypatch.undo()
    state, _ = epoch(state, torch.as_tensor(ends[:1]))
    before = ({k: p.clone() for k, p in state.model.state_dict().items()},
              {k: v.clone() for k, v in state.mu.items()},
              {k: v.clone() for k, v in state.nu.items()},
              state.step.clone(), state.gen.get_state(),
              state.noise_gen.get_state())
    state, aux = epoch(state, torch.as_tensor(ends[1:2]))
    assert aux["skipped"].tolist() == [1.0]
    after = (state.model.state_dict(), state.mu, state.nu)
    for x, y in zip(before[:3], after):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert torch.equal(before[3], state.step)
    assert not torch.equal(before[4], state.gen.get_state())
    assert not torch.equal(before[5], state.noise_gen.get_state())


def test_epoch_equals_train_steps_on_the_same_ends():
    """The epoch function and as many train_step calls on the same windows
    from the same state draw the same numbers and end bit-equal (the
    guard's select is exact)."""
    _, tcfg = _cfgs()
    _, tdd = _data()
    tdd = TD.DeviceDataset(imu=tdd.imu.float(), acc_sum=tdd.acc_sum.float(),
                           s=tdd.s.float())
    ends = torch.as_tensor(_ends())
    a = TT.init_state(tcfg, "cpu")
    b = TT.init_state(tcfg, "cpu")
    a, aux = TT.make_epoch_fn(tcfg, tdd)(a, ends)
    steps = [TT.train_step(b, TD.device_gather(tdd, e, T), tcfg)
             for e in ends]
    assert aux["loss"].tolist() == [s["loss"] for s in steps]
    assert aux["grad_norm"].tolist() == [s["grad_norm"] for s in steps]
    for k, p in a.model.state_dict().items():
        assert torch.equal(p, b.model.state_dict()[k]), k
        assert torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k])
    assert int(a.step) == int(b.step) == 3
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert torch.equal(a.noise_gen.get_state(), b.noise_gen.get_state())


@pytest.mark.parametrize("dropout_impl", ["hash", "rng"])
def test_resume_gives_the_same_schedule(dropout_impl, tmp_path):
    """With the device sampler, a state saved after epoch 1 and restored
    draws epoch 2's ends and ends epoch 2 exactly as the uninterrupted
    run does."""
    tcfg = TT.TrainConfig(model=TM.ModelConfig(
        **SMALL, encoder_impl="xla", dropout_impl=dropout_impl),
        batch_size=B, seq_len=T, lr=1e-3, optimizer="AdamW", epochs=20,
        seed=3)
    imu, acc, s = _blobs(INFOS["even"])
    ds = TD.PackedDataset(imu=imu.astype(np.float32),
                          acc_sum=acc.astype(np.float32),
                          s=s.astype(np.float32), info=INFOS["even"])
    sampler = TD.make_window_sampler(ds.info, T, "cpu")
    epoch = TT.make_epoch_fn(tcfg, TD.to_device(ds, "cpu"), sampler=sampler,
                             n_batches=2)
    live = TT.init_state(tcfg, "cpu")
    live, _ = epoch(live)
    TT.save_checkpoint(str(tmp_path), live, 2)
    back = TT.restore_checkpoint(str(tmp_path), tcfg, device="cpu")

    def ends_of(state):
        g = torch.Generator().manual_seed(0)
        g.set_state(state.noise_gen.get_state())
        return TD.device_sample_epoch(sampler, g, 2, B)
    assert torch.equal(ends_of(live), ends_of(back))
    live, aux_l = epoch(live)
    back, aux_b = epoch(back)
    for k in TT.AUX:
        assert torch.equal(aux_l[k], aux_b[k]), k
    for k, p in live.model.state_dict().items():
        assert torch.equal(p, back.model.state_dict()[k]), k
    assert int(live.step) == int(back.step) == 4
