"""The port's encoder_impl="xla" layer loop and its dropout_impl="rng"
masks, on the CPU.

The xla loop with hash masks (sites 200, 201 and 210-213 + 4 layer, all
from seed0) is held against tip_tpu's forward(train=True) and three of
tip_tpu's train steps in its xla configuration, in float64, to 1e-9; with
every rate 0 it is tip_tpu's deterministic forward. The rng masks come
from a torch.Generator, whose stream is not jax.random's, so they are held
by their statistics: each site's keep rate, the kept values' scale, the
sites' independence, and the stream's reproduction from a seed and across
a checkpoint.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.train import train as JT
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.train import data as TD
from tip_tpu_torch.train import train as TT

torch.set_num_threads(1)

SMALL = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
             rnn_hid_size=24)
B, T = 8, 10
TOL_F64 = 1e-9


def _jcfg(**kw):
    return JM.ModelConfig(**SMALL, encoder_impl="xla", rnn_impl="scan",
                          dropout_impl="hash", **kw)


def _tcfg(**kw):
    return TM.ModelConfig(**SMALL, encoder_impl="xla", rnn_impl="plain",
                          **kw)


def _inputs(seed=4, batch=B):
    rng = np.random.default_rng(seed)
    x_imu = rng.normal(size=(batch, T, 90))
    x_s = rng.normal(size=(batch, T, 131)) * 0.3
    x_s[0, 2, 110] = np.nan
    return x_imu, x_s


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float64),
        JM.init_params(jax.random.PRNGKey(0), _jcfg()))


def _model(cfg, params):
    model = TM.TIPModel(cfg, device="cpu", dtype=torch.float64)
    model.load_state_dict(TM.params_from_jax(params))
    return model


def _seed0(key):
    return int(jax.random.bits(key, dtype=jnp.uint32).astype(jnp.int32))


@pytest.mark.parametrize("key", [11, 12, 13])
def test_xla_loop_with_hash_masks_matches_tip_tpu(key, params):
    """The training forward through the per-op loop with hash masks at
    every site equals tip_tpu's xla forward(train=True, rng) to 1e-9."""
    rates = dict(in_dropout=0.1, past_dropout=0.8, layer_dropout=0.3)
    x_imu, x_s = _inputs()
    k = jax.random.PRNGKey(key)
    want = JM.forward(jax.tree_util.tree_map(jnp.asarray, params),
                      jnp.asarray(x_imu), jnp.asarray(x_s), _jcfg(**rates),
                      train=True, rng=k)
    model = _model(_tcfg(**rates), params)
    with torch.no_grad():
        got = model(torch.as_tensor(x_imu), torch.as_tensor(x_s),
                    train=True, seeds=(_seed0(k), [0, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL_F64, rtol=0)
    # the masks bite: another seed gives another output
    with torch.no_grad():
        other = model(torch.as_tensor(x_imu), torch.as_tensor(x_s),
                      train=True, seeds=(_seed0(k) + 1, [0, 0]))
    assert (other - got).abs().max() > 1e-3


@pytest.mark.parametrize("drop", ["hash", "rng"])
def test_xla_loop_with_rates_zero_is_tip_tpus_deterministic_forward(
        drop, params):
    """With every rate 0 the training forward drops nothing, whatever draws
    it is given, and equals tip_tpu's deterministic forward, as does the
    inference forward of the xla loop."""
    zero = dict(in_dropout=0.0, past_dropout=0.0, layer_dropout=0.0)
    x_imu, x_s = _inputs()
    want = np.asarray(JM.forward(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x_imu),
        jnp.asarray(x_s), _jcfg()))
    model = _model(_tcfg(dropout_impl=drop, **zero), params)
    seeds = ((5, [6, 7]) if drop == "hash"
             else torch.Generator().manual_seed(5))
    with torch.no_grad():
        train = model(torch.as_tensor(x_imu), torch.as_tensor(x_s),
                      train=True, seeds=seeds)
        infer = model(torch.as_tensor(x_imu), torch.as_tensor(x_s))
    np.testing.assert_allclose(train.numpy(), want, atol=TOL_F64, rtol=0)
    np.testing.assert_allclose(infer.numpy(), want, atol=TOL_F64, rtol=0)


def _jax_draws(rng_key, shape):
    _, sub = jax.random.split(rng_key)
    k_noise, k_model = jax.random.split(sub)
    noise = (jax.random.uniform(k_noise, shape, jnp.float64) - 0.5) * 0.3
    return np.array(noise), (_seed0(k_model), [0, 0])


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
def test_three_xla_train_steps_match_tip_tpu(optimizer, params):
    """Three f64 steps of the xla loop with hash masks: loss, grad_norm and
    the parameters after each equal tip_tpu's make_train_step to 1e-9."""
    jcfg = JT.TrainConfig(model=_jcfg(), batch_size=B, seq_len=T, lr=1e-3,
                          optimizer=optimizer, epochs=20, seed=3)
    tcfg = TT.TrainConfig(model=_tcfg(), batch_size=B, seq_len=T, lr=1e-3,
                          optimizer=optimizer, epochs=20, seed=3)
    p0 = jax.tree_util.tree_map(jnp.asarray, params)
    opt = JT.make_optimizer(jcfg)
    jstate = JT.TrainState(params=p0, opt_state=opt.init(p0),
                           step=jnp.zeros((), jnp.int32),
                           rng=jax.random.PRNGKey(7))
    jstep = JT.make_train_step(jcfg)
    state = TT.init_state(tcfg, "cpu", torch.float64)
    state.model.load_state_dict(TM.params_from_jax(params))
    rng = np.random.default_rng(0)
    for _ in range(3):
        x_imu, x_s = _inputs(int(rng.integers(1000)))
        y = rng.normal(size=(B, T, 131)) * 0.3
        noise, seeds = _jax_draws(jstate.rng, x_s.shape)
        jstate, jaux = jstep(jstate, jnp.asarray(x_imu), jnp.asarray(x_s),
                             jnp.asarray(y))
        aux = TT.train_step(state, tuple(torch.as_tensor(a)
                                         for a in (x_imu, x_s, y)), tcfg,
                            noise=torch.as_tensor(noise), seeds=seeds)
        assert not aux["skipped"]
        for k in ("loss", "grad_norm"):
            assert abs(aux[k] - float(jaux[k])) <= TOL_F64 * abs(
                float(jaux[k])), k
        for k, v in TM.params_from_jax(jax.tree_util.tree_map(
                np.asarray, jstate.params)).items():
            err = (state.model.state_dict()[k] - v).abs().max().item()
            assert err <= TOL_F64, (k, err)
    assert int(state.step) == 3


def test_rng_dropout_keeps_at_one_minus_rate_and_scales_by_one_over_keep():
    g = torch.Generator().manual_seed(1)
    x = torch.rand(400, 400, generator=g, dtype=torch.float64) + 0.5
    for rate in (0.1, 0.5, 0.8):
        out = TM.rng_dropout(x, rate, g)
        kept = out != 0
        keep = 1.0 - rate
        n = x.numel()
        share = kept.double().mean().item()
        assert abs(share - keep) <= 5 * math.sqrt(keep * rate / n), rate
        assert torch.equal(out[kept], x[kept] / keep)
    assert TM.rng_dropout(x, 0.0, g) is x


def _recorded_masks(monkeypatch, model, x_imu, x_s, gen):
    """The keep mask of each rng site of one training forward, in the order
    drawn: (rate, bool mask)."""
    sites = []
    orig = TM.rng_dropout

    def record(x, rate, generator):
        if rate == 0.0:
            return x
        m = orig(torch.ones_like(x), rate, generator)
        sites.append((rate, m != 0))
        return x * m
    monkeypatch.setattr(TM, "rng_dropout", record)
    with torch.no_grad():
        model(x_imu, x_s, train=True, seeds=gen)
    monkeypatch.undo()
    return sites


def test_rng_sites_keep_at_their_rates_and_are_independent(monkeypatch):
    """A forward of B 320 windows: the IMU and history sites and four a
    layer, each over at least 1e5 entries, keep within 5 sigma of 1 - rate;
    any two sites of one shape, and a site in two forwards, agree no more
    than independent draws would (correlation within 5 / sqrt(n))."""
    cfg = _tcfg(dropout_impl="rng", in_dropout=0.2, past_dropout=0.8,
                layer_dropout=0.1)
    model = TM.TIPModel(cfg, device="cpu")
    x_imu, x_s = (torch.as_tensor(a, dtype=torch.float32)
                  for a in _inputs(batch=320))
    gen = torch.Generator().manual_seed(3)
    first = _recorded_masks(monkeypatch, model, x_imu, x_s, gen)
    again = _recorded_masks(monkeypatch, model, x_imu, x_s, gen)
    assert len(first) == len(again) == 2 + 4 * cfg.tf_layers
    assert [r for r, _ in first] == [0.2, 0.8] + [0.1] * 4 * cfg.tf_layers
    for rate, m in first:
        n, keep = m.numel(), 1.0 - rate
        assert n >= 1e5
        share = m.double().mean().item()
        assert abs(share - keep) <= 5 * math.sqrt(keep * rate / n)

    def corr(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        a, b = a - a.mean(), b - b.mean()
        return (a @ b / (a.norm() * b.norm())).item()
    pairs = [(a, b) for i, (_, a) in enumerate(first)
             for _, b in first[i + 1:] if a.shape == b.shape]
    pairs += [(a, b) for (_, a), (_, b) in zip(first, again)]
    # within a forward: the four (B, T, d) sites of the two layers, their
    # two attention sites and two ReLU sites; and each site across the two
    assert len(pairs) == 6 + 1 + 1 + len(first)
    for a, b in pairs:
        assert abs(corr(a, b)) <= 5 / math.sqrt(a.numel())


@pytest.mark.parametrize("encoder_impl", ["xla", "auto"])
def test_rng_masks_reproduce_from_the_generator_seed(encoder_impl):
    """The same generator seed gives the same training forward (the xla
    loop's masks, or K11's layer seeds drawn from it), another seed
    another; without a generator no dropout is drawn."""
    cfg = _tcfg(dropout_impl="rng", in_dropout=0.1)
    cfg = TM.ModelConfig(**{**cfg.__dict__, "encoder_impl": encoder_impl})
    model = TM.TIPModel(cfg, device="cpu")
    x_imu, x_s = (torch.as_tensor(a, dtype=torch.float32) for a in _inputs())
    with torch.no_grad():
        a = model(x_imu, x_s, train=True,
                  seeds=torch.Generator().manual_seed(8))
        b = model(x_imu, x_s, train=True,
                  seeds=torch.Generator().manual_seed(8))
        c = model(x_imu, x_s, train=True,
                  seeds=torch.Generator().manual_seed(9))
        off = model(x_imu, x_s, train=True)
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 1e-3
    assert torch.equal(off, model(x_imu, x_s, train=True))


def test_rng_generator_state_survives_a_checkpoint(tmp_path):
    """Two rng steps, a checkpoint, and the restored state's next step
    draws the live state's masks and noise: equal aux and parameters."""
    cfg = TT.TrainConfig(model=_tcfg(dropout_impl="rng"), batch_size=B,
                         seq_len=T, lr=1e-3, optimizer="AdamW", epochs=5,
                         seed=2, dropout_rng_impl="rbg")
    state = TT.init_state(cfg, "cpu")
    rng = np.random.default_rng(1)

    def batch():
        x_imu, x_s = _inputs(int(rng.integers(1000)))
        y = rng.normal(size=(B, T, 131)) * 0.3
        return tuple(torch.as_tensor(a, dtype=torch.float32)
                     for a in (x_imu, x_s, y))
    for _ in range(2):
        TT.train_step(state, batch(), cfg)
    TT.save_checkpoint(str(tmp_path), state, 2)
    back = TT.restore_checkpoint(str(tmp_path), cfg, device="cpu")
    assert torch.equal(back.noise_gen.get_state(),
                       state.noise_gen.get_state())
    bt = batch()
    a, b = TT.train_step(state, bt, cfg), TT.train_step(back, bt, cfg)
    assert a == b
    for k, p in state.model.state_dict().items():
        assert torch.equal(p, back.model.state_dict()[k])
    with pytest.raises(ValueError, match="threefry"):
        TT.TrainConfig(dropout_rng_impl="philox")


def test_rng_training_epoch_on_the_cpu():
    """The recipe's dropout through the epoch function: masks from the
    device generator, a finite loss that the generator's seed fixes."""
    cfg = TT.TrainConfig(model=_tcfg(dropout_impl="rng"), batch_size=B,
                         seq_len=T, lr=1e-3, optimizer="AdamW", epochs=5,
                         seed=2)
    rng = np.random.default_rng(0)
    n = 400
    ds = TD.PackedDataset(
        imu=rng.normal(size=(n, 72)).astype(np.float32),
        acc_sum=rng.normal(size=(n, 18)).astype(np.float32),
        s=(rng.normal(size=(n, 131)) * 0.3).astype(np.float32),
        info=np.array([[0, 200, 1], [200, 400, 2]], np.int64))
    sampler = TD.make_window_sampler(ds.info, T, "cpu")
    epoch = TT.make_epoch_fn(cfg, TD.to_device(ds, "cpu"), sampler=sampler,
                             n_batches=3)
    runs = []
    for _ in range(2):
        state, aux = epoch(TT.init_state(cfg, "cpu"))
        assert torch.isfinite(aux["loss"]).all() and not aux["skipped"].any()
        runs.append(aux["loss"])
    assert torch.equal(*runs)
