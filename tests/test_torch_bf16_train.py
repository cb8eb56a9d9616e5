"""bf16 training on the port against tip_tpu's, on the CPU.

``ModelConfig(compute_dtype="bfloat16")`` trains as tip_tpu's does with its
kernel configuration (encoder_impl="pallas", rnn_impl="pallas",
dropout_impl="hash"): float32 parameters cast to bf16 inside the
differentiable forward, the encoder layers through K11/K12 and the RNN
head through K1/K10 in bf16, Adam and the clip in float32. On the CPU the
port's wrappers run the plain versions; tip_tpu's Pallas kernels run in
interpret mode, as its own tests run them. Inputs are made from a seed with
numpy.

Where the two packages round: K10 forms da in f32 from bf16 operands,
rounds it to bf16 once (dxin and the next step's operand) and sums dW in
f32, rounded at the end; K12 rounds both operands of each of its 12
backward products to bf16 and sums in f32, with LayerNorm, dReLU, masks and
column sums in f32. The plain versions equal the kernels bit for bit, or
within a flip of one bf16 step where two f32 sums taken in another order
round apart; the model adds bf16 products outside the kernels, which the
two frameworks sum in another order.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tip_tpu.models import tip_model as JM
from tip_tpu.ops import pallas_encoder as PE
from tip_tpu.ops import pallas_kernels as PK
from tip_tpu.train import train as JT
from tip_tpu_torch.cli import combine_data as TCC
from tip_tpu_torch.cli import train as TCT
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import encoder_train as ET
from tip_tpu_torch.ops import fused_rnn as FR
from tip_tpu_torch.train import data as TD
from tip_tpu_torch.train import train as TT

torch.set_num_threads(1)

BF, F32 = torch.bfloat16, torch.float32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "artifacts", "corpus_run_v3", "corpus_extra")
LAYER_TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
                  rnn_hid_size=24)
# the model and the train steps: tests/test_torch_train.py's tiny config
TINY = dict(tf_in_dim=64, tf_hid_size=128, n_heads=4, tf_layers=2,
            rnn_hid_size=32)
KERNELS = dict(encoder_impl="pallas", rnn_impl="pallas", dropout_impl="hash")
B, T = 16, 10
LR = 1e-3
# the training forward's output against tip_tpu's: bf16 products outside
# the kernels (in-projection, W_ih, out-projection) summed in another order
# move an output by a bf16 step (measured 7.8e-3 on outputs of order 1.4)
TOL_OUT = 1e-2
# its gradients with respect to the f32 parameters, relative to each
# parameter's largest entry: the bf16 cotangents are summed in another
# order and rounded at other places (a bias gradient sums 160 bf16 rows;
# measured worst 2.5e-2, in_linear.b); b_k's gradient is 0 in exact
# arithmetic (softmax ignores a constant per row) and here rounding noise:
# it is held within 1e-3 of the largest gradient entry of all (measured
# 8e-5)
TOL_GRAD = 5e-2
TOL_GRAD_B_K = 1e-3
# three bf16 train steps against tip_tpu's: loss and grad_norm relative
# (measured 2.4e-4 and 4.6e-4); parameters: an Adam update moves an entry
# by at most about lr, so two runs whose gradient entry near 0 has another
# sign part by 2 lr a step at most (measured 2.0, 4.0, 5.8 lr); 99% of the
# entries lie within lr / 2 after three steps (measured 99.6%)
TOL_STEP = 1e-3
TOL_STEP_PARAM_SHARE = 0.99


def _bf16_ulp(a):
    """The spacing of bf16 values at |a| (8 significant bits)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _np32(t):
    """A torch tensor or a JAX array as a float32 numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.array(jnp.asarray(t).astype(jnp.float32))


def _within_a_step(got, want):
    """Each entry within one bf16 step of the output's largest entry."""
    got, want = _np32(got), _np32(want)
    return (np.abs(got - want) <= _bf16_ulp(np.abs(want).max())).all()


def _params32(seed, cfg):
    return jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32),
                                  JM.init_params(jax.random.PRNGKey(seed),
                                                 cfg))


# K10 ------------------------------------------------------------------------

def _rnn_inputs(B, seed):
    rng = np.random.default_rng(seed)
    xin = rng.normal(size=(B, 8, 64)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(64, 64)) / 8).astype(np.float32)
    g = rng.normal(size=(B, 8, 64)).astype(np.float32)
    return xin, w, g


@pytest.mark.parametrize("B", [1, 3])
def test_fused_rnn_bwd_plain_bf16_equals_pallas_kernel(B):
    """Bit for bit (measured so): the same f32 arithmetic on the same bf16
    operands, da rounded once a step, dW rounded once at the end."""
    xin, w, g = _rnn_inputs(B, B)
    hs = PK.fused_rnn(jnp.asarray(xin, jnp.bfloat16),
                      jnp.asarray(w, jnp.bfloat16), interpret=True)
    jdx, jdw = PK._rnn_bwd(hs, jnp.asarray(w, jnp.bfloat16),
                           jnp.asarray(g, jnp.bfloat16), True)
    tdx, tdw = FR.fused_rnn_bwd(torch.as_tensor(_np32(hs)).to(BF),
                                torch.as_tensor(w).to(BF),
                                torch.as_tensor(g).to(BF))
    assert (tdx.dtype, tdw.dtype) == (BF, BF)
    assert (jdx.dtype, jdw.dtype) == (jnp.bfloat16, jnp.bfloat16)
    np.testing.assert_array_equal(_np32(tdx), _np32(jdx))
    np.testing.assert_array_equal(_np32(tdw), _np32(jdw))


def test_fused_rnn_train_bf16_gradients_match_jax_grad():
    """fused_rnn_train in bf16 under autograd against jax.grad of
    tip_tpu's fused_rnn_train in bf16 (interpret mode): the hidden states
    and both gradients bit for bit (measured so), in bf16."""
    xin, w, g = _rnn_inputs(4, 7)
    xj, wj, gj = (jnp.asarray(a, jnp.bfloat16) for a in (xin, w, g))

    def loss(x, w):
        return jnp.sum(PK.fused_rnn_train(x, w, True) * gj)

    gx_j, gw_j = jax.grad(loss, argnums=(0, 1))(xj, wj)
    x_t = torch.as_tensor(xin).to(BF).requires_grad_(True)
    w_t = torch.as_tensor(w).to(BF).requires_grad_(True)
    hs = FR.fused_rnn_train(x_t, w_t)
    np.testing.assert_array_equal(
        _np32(hs.detach()), _np32(PK.fused_rnn(xj, wj, interpret=True)))
    torch.sum(hs * torch.as_tensor(g).to(BF)).backward()
    assert (x_t.grad.dtype, w_t.grad.dtype) == (BF, BF)
    np.testing.assert_array_equal(_np32(x_t.grad), _np32(gx_j))
    np.testing.assert_array_equal(_np32(w_t.grad), _np32(gw_j))


@pytest.mark.parametrize("B,T,H", [(256, 40, 512), (1, 40, 512), (3, 7, 40),
                                   (17, 40, 512), (1000, 40, 512)])
def test_fused_rnn_bwd_plan_bf16_fits_and_covers_every_row(B, T, H):
    """The bf16 walk (on the tensor cores) splits W's columns as the f32
    one does and holds B in at most TC_CLUSTERS clusters of the fewest rows
    (up to TC_MAX_TILE), within a block's shared memory; dW is one product
    of csrc/bf16_gemm.cuh over the B T rows, its splits whole 64-deep
    slices that cover them, one cluster of at most 16 (64-row tiles
    only)."""
    f32, bf16 = FR.fused_rnn_bwd_plan(B, T, H), \
        FR.fused_rnn_bwd_plan(B, T, H, 2)
    walk = bf16.walk
    assert walk.smem_bytes <= FR.MAX_SMEM
    assert walk.smem_bytes == FR.tc_smem_bytes(walk.cols, walk.batch_tile,
                                               back=True)
    assert walk.cols == f32.walk.cols
    assert walk.batch_tile == min(-(-B // FR.TC_CLUSTERS), FR.TC_MAX_TILE)
    assert walk.clusters <= FR.TC_CLUSTERS or \
        walk.batch_tile == FR.TC_MAX_TILE
    assert walk.clusters * walk.batch_tile >= B > \
        (walk.clusters - 1) * walk.batch_tile
    assert walk.cols * walk.cluster >= H
    bm, bn = bf16.dw_tile
    assert (bm, bn) in ((64, 64), (64, 128), (128, 128))
    assert bf16.dw_rows % 64 == 0 and 1 <= bf16.dw_splits <= 16
    assert bm == 64 or bf16.dw_splits == 1
    assert bf16.dw_rows * bf16.dw_splits >= B * T > \
        bf16.dw_rows * (bf16.dw_splits - 1)


def test_fused_rnn_bwd_mixed_dtypes_raise():
    hs = torch.zeros(2, 5, 8, dtype=BF)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        FR.fused_rnn_bwd(hs, torch.zeros(8, 8), hs)


# K12 ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer_bf16():
    cfg = JM.ModelConfig(**LAYER_TINY)
    layer = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                   _params32(0, cfg)["layers"][0])
    ws = PE.pack_layer_weights(layer, jnp.bfloat16)
    wt = tuple(torch.as_tensor(_np32(w)).to(
        BF if w.dtype == jnp.bfloat16 else F32) for w in ws)
    return ws, wt


@pytest.mark.parametrize("B", [3, 9])
@pytest.mark.parametrize("p,train", [(0.0, False), (0.1, True)])
def test_encoder_layer_bwd_plain_bf16_matches_pallas_kernel(B, p, train,
                                                            layer_bf16):
    """dx and the 12 gradients within one bf16 step of each output's
    largest entry (measured: dx and the matmul-weight and bias gradients
    bit for bit, but for one entry of w_qkv and of b_qkv at B 9, p 0.1,
    7e-8 and 1e-6 of their largest entries apart), the LayerNorm gradients
    (f32, summed over the rows in another order) within 1e-5 of their
    largest entry (measured 3.6e-7). dtypes as tip_tpu's: bf16 dx and
    matmul-weight and bias gradients, f32 LayerNorm gradients. B 9 takes
    three batch tiles of 3."""
    ws, wt = layer_bf16
    rng = np.random.default_rng(B)
    x = rng.normal(size=(B, 10, 32)).astype(np.float32)
    dy = rng.normal(size=(B, 10, 32)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # B 9 takes tiles of 3
        jdx, jdws = PE._encoder_layer_bwd_call(
            jnp.asarray(x, jnp.bfloat16), ws, -7,
            jnp.asarray(dy, jnp.bfloat16), 4, p, train, 8, True)
        tdx, tdws = ET.encoder_layer_bwd(torch.as_tensor(x).to(BF), wt, -7,
                                         torch.as_tensor(dy).to(BF), 4, p,
                                         train, 8)
    assert tdx.dtype == BF and jdx.dtype == jnp.bfloat16
    assert _within_a_step(tdx, jdx)
    for i, (name, a, b) in enumerate(zip(ET.WEIGHT_NAMES, tdws, jdws)):
        assert a.dtype == (BF if i < 8 else F32), name
        assert b.dtype == (jnp.bfloat16 if i < 8 else jnp.float32), name
        assert _within_a_step(a, b), name
        if i >= 8:
            b = _np32(b)
            assert np.abs(_np32(a) - b).max() <= 1e-5 * np.abs(b).max(), \
                name


def test_encoder_layer_train_bf16_autograd_matches_jax_grad(layer_bf16):
    """encoder_layer_train in bf16 under autograd (K11's and K12's plain
    versions) against jax.grad of tip_tpu's encoder_layer_train in bf16,
    dropout on: y, dx and the 12 gradients within one bf16 step of each
    one's largest entry, the LayerNorm gradients within 1e-5."""
    ws, wt = layer_bf16
    rng = np.random.default_rng(21)
    x = rng.normal(size=(8, 10, 32)).astype(np.float32)
    r = rng.normal(size=(8, 10, 32)).astype(np.float32)
    xj, rj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(r, jnp.bfloat16)

    def loss(x, ws):
        return jnp.sum(PE.encoder_layer_train(x, ws, 99, 4, 0.1, True, 8,
                                              True) * rj)

    yj = PE.encoder_layer_train(xj, ws, 99, 4, 0.1, True, 8, True)
    gx_j, gws_j = jax.grad(loss, argnums=(0, 1))(xj, ws)
    x_t = torch.as_tensor(x).to(BF).requires_grad_(True)
    ws_t = tuple(w.clone().requires_grad_(True) for w in wt)
    y = ET.encoder_layer_train(x_t, ws_t, 99, 4, 0.1, True, 8)
    assert y.dtype == BF and _within_a_step(y.detach(), yj)
    torch.sum(y * torch.as_tensor(r).to(BF)).backward()
    assert x_t.grad.dtype == BF and _within_a_step(x_t.grad, gx_j)
    for i, (name, w, b) in enumerate(zip(ET.WEIGHT_NAMES, ws_t, gws_j)):
        assert w.grad.dtype == (BF if i < 8 else F32), name
        assert _within_a_step(w.grad, b), name
        if i >= 8:
            b = _np32(b)
            assert np.abs(_np32(w.grad) - b).max() <= \
                1e-5 * np.abs(b).max(), name


# the model ------------------------------------------------------------------

def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x_imu = rng.normal(size=(B, T, 90)).astype(np.float32)
        x_s = (rng.normal(size=(B, T, 131)) * 0.3).astype(np.float32)
        y = (rng.normal(size=(B, T, 131)) * 0.3).astype(np.float32)
        x_s[0, 2, 110] = np.nan            # a NaN history entry
        y[1, 3, 109] = np.nan              # a DIP-like root velocity row
        y[2, 4, 120] = np.nan              # an SBP label row
        out.append((x_imu, x_s, y))
    return out


def _cfgs():
    j = JT.TrainConfig(model=JM.ModelConfig(
        **TINY, compute_dtype="bfloat16", **KERNELS), batch_size=B,
        seq_len=T, lr=LR, optimizer="AdamW", epochs=20, seed=3)
    t = TT.TrainConfig(model=TM.ModelConfig(**TINY, compute_dtype="bfloat16"),
                       batch_size=B, seq_len=T, lr=LR, optimizer="AdamW",
                       epochs=20, seed=3)
    return j, t


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layer_seeds(key, n_layers):
    """tip_tpu's forward's dropout seeds from its rng, as host ints."""
    keys = jax.random.split(key, 2 + 4 * n_layers)
    return (int(jax.random.bits(key, dtype=jnp.uint32).astype(jnp.int32)),
            [int(jax.random.bits(keys[2 + 4 * li], dtype=jnp.uint32)
                 .astype(jnp.int32)) for li in range(n_layers)])


def test_train_forward_bf16_matches_tip_tpu():
    """The training forward with compute_dtype="bfloat16" on float32
    parameters against tip_tpu's forward(train=True, rng) with its Pallas
    layer and RNN in bf16, dropout on: the output within TOL_OUT, and the
    gradient of a scalar loss with respect to every f32 parameter within
    TOL_GRAD of its largest entry (b_k's within TOL_GRAD_B_K of the
    largest of all); the gradients are float32."""
    jcfg, tcfg = _cfgs()
    params = _params32(0, jcfg.model)
    x_imu, x_s, _ = _batches(1, seed=4)[0]
    r = np.random.default_rng(5).normal(size=(B, T, 131)).astype(np.float32)
    key = jax.random.PRNGKey(11)

    def loss(p):
        return jnp.sum(JM.forward(p, jnp.asarray(x_imu), jnp.asarray(x_s),
                                  jcfg.model, train=True, rng=key) * r)

    j_out = JM.forward(params, jnp.asarray(x_imu), jnp.asarray(x_s),
                       jcfg.model, train=True, rng=key)
    j_grads = TM.params_from_jax(_tree_np(jax.grad(loss)(params)))
    model = TM.TIPModel(tcfg.model, device="cpu").requires_grad_(True)
    model.load_state_dict(TM.params_from_jax(params))
    out = model(torch.as_tensor(x_imu), torch.as_tensor(x_s), train=True,
                seeds=_layer_seeds(key, 2))
    assert out.dtype == F32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=TOL_OUT, rtol=0)
    (out * torch.as_tensor(r)).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    top = max(v.abs().max().item() for v in j_grads.values())
    for k, want in j_grads.items():
        assert grads[k].dtype == F32, k
        err = (grads[k] - want).abs().max().item()
        if k.endswith("b_k"):
            assert err <= TOL_GRAD_B_K * top, (k, err)
        else:
            assert err <= TOL_GRAD * want.abs().max().item(), (k, err)


def _jax_draws(rng_key, shape, n_layers):
    """tip_tpu's step's noise and dropout seeds from its state's rng."""
    _, sub = jax.random.split(rng_key)
    k_noise, k_model = jax.random.split(sub)
    noise = (jax.random.uniform(k_noise, shape, jnp.float32) - 0.5) * 0.3
    return np.array(noise), _layer_seeds(k_model, n_layers)


def test_three_bf16_train_steps_match_tip_tpu():
    """Three bf16 train steps (AdamW, the clip active) against tip_tpu's
    make_train_step with compute_dtype="bfloat16", from the same float32
    start carried across by train_state_from_jax: loss and grad_norm
    within TOL_STEP relative; the parameters within 2 lr a step of
    tip_tpu's, and TOL_STEP_PARAM_SHARE of their entries within lr / 2;
    parameters and moments stay float32."""
    jcfg, tcfg = _cfgs()
    params = jax.tree_util.tree_map(jnp.asarray, _params32(0, jcfg.model))
    opt = JT.make_optimizer(jcfg)
    jstate = JT.TrainState(params=params, opt_state=opt.init(params),
                           step=jnp.zeros((), jnp.int32),
                           rng=jax.random.PRNGKey(7))
    step = JT.make_train_step(jcfg)
    zeros = jax.tree_util.tree_map(np.zeros_like, _tree_np(params))
    state = TT.train_state_from_jax(_tree_np(params), 0, zeros, zeros, tcfg,
                                    device="cpu")
    for k, batch in enumerate(_batches(3), start=1):
        noise, seeds = _jax_draws(jstate.rng, batch[1].shape, 2)
        jstate, jaux = step(jstate, *map(jnp.asarray, batch))
        aux = TT.train_step(state, tuple(torch.as_tensor(a) for a in batch),
                            tcfg, noise=torch.as_tensor(noise), seeds=seeds)
        assert not aux["skipped"]
        assert float(jaux["grad_norm"]) > tcfg.clip
        for key in ("loss", "grad_norm"):
            want = float(jaux[key])
            assert abs(aux[key] - want) <= TOL_STEP * abs(want), key
        want = TM.params_from_jax(_tree_np(jstate.params))
        got = state.model.state_dict()
        diff = torch.cat([(got[n] - v).abs().flatten()
                          for n, v in want.items()]) / LR
        assert diff.max().item() <= 2.0 * k, diff.max().item()
        assert (diff <= 0.5).float().mean().item() >= TOL_STEP_PARAM_SHARE
    assert all(v.dtype == F32 for v in state.model.state_dict().values())
    assert all(v.dtype == F32 for v in (*state.mu.values(),
                                        *state.nu.values()))
    assert state.step == 3


def test_cli_train_bf16_on_cpu_checkpoints_and_resumes(tmp_path):
    """cli/train --bf16 on the CPU: a tiny run writes checkpoints whose
    parameters and moments are float32 and whose compute dtype is bf16;
    the newest restores under the bf16 config and steps on, and refuses a
    float32 config."""
    TCC.main(["--data_root", os.path.dirname(CORPUS), "--datasets",
              "corpus_extra", "--rates", "60", "--name_contains",
              "freeform2_000[01]", "--out_prefix", str(tmp_path / "d")])
    args = ["--data_prefix", str(tmp_path / "d"), "--save_path",
            str(tmp_path / "run"), "--batch_size", "8", "--seq_len", "10",
            "--epochs", "2", "--with_acc_sum", "--cosine_lr", "--optim",
            "AdamW", "--tf_in_dim", "32", "--tf_nhid", "64", "--n_heads",
            "4", "--tf_layers", "2", "--rnn_nhid", "24", "--device", "cpu"]
    state = TCT.main(args + ["--bf16"])
    assert state.model.cfg.compute_dtype == "bfloat16" and state.step > 0
    lines = [json.loads(line)
             for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert all(np.isfinite(r["mean_loss"]) for r in lines
               if "mean_loss" in r)
    ck = torch.load(tmp_path / "run" / "ckpt_2.pt", weights_only=True)
    assert ck["compute_dtype"] == "bfloat16"
    assert all(v.dtype == F32 for part in ("params", "mu", "nu")
               for v in ck[part].values())
    cfg = TT.TrainConfig(model=state.model.cfg, batch_size=8, seq_len=10,
                         optimizer="AdamW", epochs=2, cosine_lr=True)
    back = TT.restore_checkpoint(str(tmp_path / "run"), cfg, device="cpu")
    assert back.step == state.step
    for k, p in state.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], p)
    ds = TD.PackedDataset.from_prefix(str(tmp_path / "d"))
    ends = TD.sample_epoch_indices(ds.info, 10, np.random.default_rng(0))
    batch = tuple(torch.as_tensor(a)
                  for a in TD.gather_batch(ds, ends[:8], 10))
    a, b = TT.train_step(state, batch, cfg), TT.train_step(back, batch, cfg)
    assert a == b and np.isfinite(a["loss"]) and back.step == state.step
    f32 = TT.TrainConfig(model=TM.ModelConfig(**{
        k: getattr(state.model.cfg, k) for k in (
            "tf_in_dim", "tf_hid_size", "n_heads", "tf_layers",
            "rnn_hid_size", "with_acc_sum")}), batch_size=8, seq_len=10)
    with pytest.raises(ValueError, match="compute_dtype"):
        TT.restore_checkpoint(str(tmp_path / "run"), f32, device="cpu")
    TT.restore_checkpoint(str(tmp_path / "run"), f32, params_only=True,
                          device="cpu")
