"""The bf16 serving route of the port against tip_tpu's bf16 kernels.

``ModelConfig(compute_dtype="bfloat16")`` on the port's default route runs
each encoder layer through K11 and the RNN head through K1 in bf16; on the
CPU their wrappers run the plain versions, ``encoder_layer_train_plain``
and ``fused_rnn_plain``. tip_tpu runs its Pallas kernels in bf16 whenever
``compute_dtype="bfloat16"`` meets ``encoder_impl="pallas"`` and
``rnn_impl="pallas"``; here they run in interpret mode, as tip_tpu's own
tests run them. Inputs are made from a seed with numpy.

Where the two packages round: K1 rounds the f32 sum of h_{t-1} W_hh, the
add of xin_t and the tanh to bf16, each step; K11 rounds both operands of
every product (q k^T and p v too) to bf16, sums in f32 and writes y in
bf16, with biases, LayerNorm, softmax and residuals in f32. The plain
versions equal the kernels bit for bit on these inputs; the whole model
and the runner add bf16 products outside the kernels (the in-projection,
W_ih, the out-projection), which the two frameworks sum in another order.
"""

import pickle
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from tip_tpu.models import tip_model as JM
from tip_tpu.ops import kinematics as jkin
from tip_tpu.ops import pallas_encoder as PE
from tip_tpu.ops import pallas_kernels as PK
from tip_tpu.runtime import runner as JR
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import encoder_train as ET
from tip_tpu_torch.ops import fused_rnn as FR
from tip_tpu_torch.ops import kinematics as tkin
from tip_tpu_torch.runtime import runner as TR

torch.set_num_threads(1)

TINY = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
            rnn_hid_size=24)
BF16 = dict(compute_dtype="bfloat16")
JAX_KERNELS = dict(encoder_impl="pallas", rnn_impl="pallas")
# the model and the runner against tip_tpu: bf16 products outside the
# kernels are summed in another order, so an activation at a bf16 rounding
# boundary rounds the other way and an output moves by a bf16 step or two
# (the measured worst: 3.9e-3 on outputs of order 1); tighter than the
# plain loop's 2e-2 (tests/test_torch_model.py), which rounds at other
# places than tip_tpu's kernels
TOL_MODEL = 1e-2
MOTION = (Path(__file__).resolve().parents[1] / "artifacts" / "corpus_run_v3"
          / "corpus_extra" / "freeform2_0000.pkl")
N_FRAMES = 60


def _bf16_ulp(a):
    """The spacing of bf16 values at |a| (8 significant bits)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _params(seed, cfg):
    return jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32),
                                  JM.init_params(jax.random.PRNGKey(seed),
                                                 cfg))


# (a) K1 ---------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 3])
def test_fused_rnn_plain_bf16_equals_pallas_kernel(B):
    """Bit for bit: the same three roundings a step."""
    rng = np.random.default_rng(B)
    xin = rng.normal(size=(B, 40, 64)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(64, 64)) / 8).astype(np.float32)
    j = PK.fused_rnn(jnp.asarray(xin, jnp.bfloat16),
                     jnp.asarray(w, jnp.bfloat16), interpret=True)
    t = FR.fused_rnn(torch.as_tensor(xin).bfloat16(),
                     torch.as_tensor(w).bfloat16())
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


def test_fused_rnn_plan_keeps_a_bf16_slice_in_half_the_bytes():
    """The bf16 walk splits W_hh's columns as the f32 one does, holds B in
    at most TC_CLUSTERS clusters of the fewest rows, and keeps its slice in
    registers (the mma's A fragments): half the bytes of the f32 slice in
    shared memory, which holds only the staging, the bf16 row buffers and
    the partial sums."""
    f32, bf16 = FR.fused_rnn_plan(64, 512), FR.fused_rnn_plan(64, 512, 2)
    assert f32.cols == bf16.cols
    assert (bf16.batch_tile, bf16.clusters) == (5, 13)
    assert bf16.clusters <= FR.TC_CLUSTERS < -(-64 // (bf16.batch_tile - 1))
    slice_f32 = 4 * 512 * 64
    w_registers = (bf16.cols // 16) * (64 // 16) * 4   # tc_walk_kernel's wa
    assert FR.RNN_THREADS * 4 * w_registers == slice_f32 // 2
    assert bf16.smem_bytes == FR.tc_smem_bytes(bf16.cols, bf16.batch_tile,
                                               back=False)


# (b) K11 --------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer_bf16():
    cfg = JM.ModelConfig(**TINY)
    layer = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16),
                                   _params(0, cfg)["layers"][0])
    ws = PE.pack_layer_weights(layer, jnp.bfloat16)
    wt = tuple(torch.as_tensor(np.array(w.astype(jnp.float32))).to(
        torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.float32)
        for w in ws)
    return ws, wt


@pytest.mark.parametrize("B", [3, 9])
@pytest.mark.parametrize("p,train", [(0.0, False), (0.1, True)])
def test_encoder_layer_plain_bf16_equals_pallas_kernel(B, p, train,
                                                       layer_bf16):
    """Bit for bit on these inputs (B 9: three batch tiles of 3, so the
    tile seed offset shows); the stated limit is one bf16 step of |y|,
    where a sum-order flip would show."""
    ws, wt = layer_bf16
    x = np.random.default_rng(B).normal(size=(B, 10, 32)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # B 9 takes tiles of 3
        j = PE._encoder_layer_fwd_call(jnp.asarray(x, jnp.bfloat16), ws, -7,
                                       4, p, train, 8, True)
        t = ET.encoder_layer_fwd(torch.as_tensor(x).bfloat16(), wt, -7, 4,
                                 p, train, 8)
    assert t.dtype == torch.bfloat16
    j = np.asarray(j.astype(jnp.float32))
    assert (np.abs(t.float().numpy() - j) <= _bf16_ulp(j)).all()


# (c), (d) the model and the runner ------------------------------------------

class _Seen:
    """Records the dtypes each K1 and K11 wrapper call is handed."""

    def __init__(self, monkeypatch):
        self.enc, self.rnn = [], []
        enc, rnn = TM.encoder_layer_fwd, TM.fused_rnn

        def seen_enc(x, ws, *a, **kw):
            self.enc.append((x.dtype, ws[0].dtype, ws[8].dtype))
            return enc(x, ws, *a, **kw)

        def seen_rnn(xin, w, *a, **kw):
            self.rnn.append((xin.dtype, w.dtype))
            return rnn(xin, w, *a, **kw)

        monkeypatch.setattr(TM, "encoder_layer_fwd", seen_enc)
        monkeypatch.setattr(TM, "fused_rnn", seen_rnn)


@pytest.mark.parametrize("B", [2, 16])
def test_model_bf16_default_route_matches_tip_tpu_kernels(B, monkeypatch):
    """TIPModel(compute_dtype="bfloat16") with every other setting at its
    default against tip_tpu's forward with its Pallas layer and RNN in
    bf16 (B 16: two batch tiles of 8). Measured: equal at B 2, 3.9e-3 at
    B 16."""
    cfg = JM.ModelConfig(**TINY, **BF16, **JAX_KERNELS)
    params = _params(6, cfg)
    rng = np.random.default_rng(6 + B)
    x_imu = rng.normal(size=(B, 12, cfg.input_dim - cfg.size_s))
    x_s = rng.normal(size=(B, 12, cfg.size_s))
    x_imu, x_s = x_imu.astype(np.float32), x_s.astype(np.float32)
    j = np.asarray(JM.forward(params, jnp.asarray(x_imu), jnp.asarray(x_s),
                              cfg))
    model = TM.TIPModel(TM.ModelConfig(**TINY, **BF16), device="cpu")
    model.load_state_dict(TM.params_from_jax(params))
    seen = _Seen(monkeypatch)
    with torch.no_grad():
        t = model(torch.as_tensor(x_imu), torch.as_tensor(x_s))
    bf, f32 = torch.bfloat16, torch.float32
    assert seen.enc == [(bf, bf, f32)] * TINY["tf_layers"]
    assert seen.rnn == [(bf, bf)]
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, atol=TOL_MODEL, rtol=0)


@pytest.fixture(scope="module")
def stream():
    with open(MOTION, "rb") as f:      # in-tree motion written by data gen
        d = pickle.load(f)
    return (np.asarray(d["imu"][:N_FRAMES], np.float32),
            np.asarray(d["nimble_qdq"][0], np.float32))


def test_run_offline_bf16_matches_tip_tpu(stream):
    """run_offline over 60 frames in bf16 on the default route against
    tip_tpu's runner with its bf16 kernels. A free-running bf16 trajectory
    of a random model drifts from any other run chaotically once a
    rounding flip feeds back through the state history (both packages'
    plain loops part by ~3 within 60 frames), so the runs are held at the
    first model frame, where both start from s_init, and then frame by
    frame teacher-forced: every window the port's runner built goes
    through tip_tpu's forward, and its row k-1 is held against the output
    the runner produced, within TOL_MODEL."""
    imu, s_init = stream
    jcfg = JR.RunnerConfig(model=JM.ModelConfig(**TINY, **BF16,
                                                **JAX_KERNELS))
    params = _params(0, jcfg.model)
    j_out = JR.run_offline(params, jcfg, jkin.amass_skeleton(
        dtype=np.float32), s_init, imu)
    tcfg = TR.RunnerConfig(model=TM.ModelConfig(**TINY, **BF16))
    model = TM.TIPModel(tcfg.model, device="cpu")
    model.load_state_dict(TM.params_from_jax(params))
    skel = tkin.amass_skeleton(dtype=torch.float32)
    t_out = TR.run_offline(model, tcfg, skel, s_init, imu, device="cpu")
    first = tcfg.imu_n_smooth + 1               # the first model frame
    for j, t in zip(j_out, t_out):
        assert t.shape == np.asarray(j).shape and torch.isfinite(t).all()
        np.testing.assert_array_equal(t[:first].numpy(),
                                      np.asarray(j)[:first])
        np.testing.assert_allclose(t[first].numpy(), np.asarray(j)[first],
                                   atol=TOL_MODEL, rtol=0)

    carry = TR.runner_init(tcfg, skel, s_init, device="cpu")
    xs, rows, ys = [], [], []
    with torch.no_grad():
        for t in range(N_FRAMES - 1):
            new, _ = TR.runner_step(model, carry, torch.as_tensor(imu[t]),
                                    tcfg, skel)
            if new.n_out > carry.n_out:           # the model ran
                x_imu, x_s = TR.model_window(tcfg, new.imu_win,
                                             new.accsum_win,
                                             carry.s_and_c_win)
                xs.append((x_imu.numpy(), x_s.numpy()))
                rows.append(min(new.k, tcfg.window) - 1)
                ys.append(new.out_buf[-1].numpy())
            carry = new
    assert len(ys) == N_FRAMES - 1 - tcfg.imu_n_smooth
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the batch is no multiple of 8
        y = np.asarray(JM.forward(params,
                                  jnp.asarray(np.stack([a for a, _ in xs])),
                                  jnp.asarray(np.stack([b for _, b in xs])),
                                  jcfg.model))
    y = y[np.arange(len(rows)), rows]
    np.testing.assert_allclose(np.stack(ys), y, atol=TOL_MODEL, rtol=0)


# (e) refusals ---------------------------------------------------------------

def test_mixed_dtypes_raise():
    x = torch.zeros(2, 40, 64)
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        FR.fused_rnn(x, torch.zeros(64, 64, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        FR.fused_rnn(x.bfloat16(), torch.zeros(64, 64))
    model = TM.TIPModel(TM.ModelConfig(**TINY), device="cpu")
    p = dict(model.named_parameters())
    ws32 = ET.pack_layer_weights(p, "layers.0.")
    ws16 = ET.pack_layer_weights(p, "layers.0.", torch.bfloat16)
    x = torch.zeros(2, 10, 32)
    for xx, ws in ((x, ws16), (x.bfloat16(), ws32)):
        with pytest.raises(TypeError, match="encoder_layer"):
            ET.encoder_layer_fwd(xx, ws, 0, 4, 0.0, False)


def test_bf16_head_width_not_a_multiple_of_8_raises():
    """K11's bf16 loads take 8 values at a time: d / n_heads 4 passes in
    float32 and raises in bfloat16 (the check the kernel route runs)."""
    model = TM.TIPModel(TM.ModelConfig(**dict(TINY, n_heads=8)),
                        device="cpu")
    p = dict(model.named_parameters())
    x = torch.zeros(2, 10, 32)
    ET._check(x, ET.pack_layer_weights(p, "layers.0."), 8, 8)
    with pytest.raises(ValueError, match="multiples of 8"):
        ET._check(x.bfloat16(),
                  ET.pack_layer_weights(p, "layers.0.", torch.bfloat16), 8, 8)


def test_bf16_backward_and_training_raise():
    """The bf16 backward (K10, K12) and the bf16 training forward run on a
    CPU tensor through the plain versions, in bf16 (gradients in the
    inputs' dtypes); impl="kernel" on a CPU tensor still raises. A bf16
    model with grad-enabled parameters runs its forward with grad on and
    its backward (float32 gradients), and gives the bits of the same
    forward under no_grad."""
    bf = torch.bfloat16
    rng = np.random.default_rng(3)
    hs = torch.tanh(torch.as_tensor(rng.normal(size=(2, 5, 8)),
                                    dtype=torch.float32)).to(bf)
    w = torch.as_tensor(rng.normal(size=(8, 8)) / 3,
                        dtype=torch.float32).to(bf)
    dx, dw = FR.fused_rnn_bwd(hs, w, hs)
    assert (dx.dtype, dw.dtype) == (bf, bf) and torch.isfinite(dw).all()
    with pytest.raises(ValueError, match="CUDA"):
        FR.fused_rnn_bwd(hs, w, hs, impl="kernel")
    x = hs.clone().requires_grad_(True)
    FR.fused_rnn_train(x, w).float().sum().backward()
    assert x.grad.dtype == bf and torch.isfinite(x.grad.float()).all()
    model = TM.TIPModel(TM.ModelConfig(**TINY), device="cpu")
    ws = ET.pack_layer_weights(dict(model.named_parameters()), "layers.0.",
                               bf)
    x = torch.as_tensor(rng.normal(size=(2, 10, 32)),
                        dtype=torch.float32).to(bf)
    dx, dws = ET.encoder_layer_bwd(x, ws, 0, x, 4, 0.0, False)
    assert dx.dtype == bf and [g.dtype for g in dws] == [w.dtype for w in ws]
    with pytest.raises(ValueError, match="CUDA"):
        ET.encoder_layer_bwd(x, ws, 0, x, 4, 0.0, False, impl="kernel")
    y = ET.encoder_layer_train(x.clone().requires_grad_(True), ws, 0, 4, 0.0,
                               False)
    assert y.dtype == bf
    bf16_model = TM.TIPModel(TM.ModelConfig(**TINY, **BF16),
                             device="cpu").requires_grad_(True)
    x_imu = torch.as_tensor(rng.normal(size=(1, 10, 90)), dtype=torch.float32)
    x_s = torch.as_tensor(rng.normal(size=(1, 10, 131)), dtype=torch.float32)
    out = bf16_model(x_imu, x_s)
    with torch.no_grad():                      # the runners' way
        assert torch.equal(out.detach(), bf16_model(x_imu, x_s))
    out.square().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               and torch.isfinite(p.grad).all()
               for p in bf16_model.parameters())
    out = bf16_model(x_imu, x_s, train=True, seeds=(5, [6, 7]))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


# (f) chip_smoke.py's rounding check of the bf16 kernels ---------------------

def test_rounding_check_steps_k1_from_its_own_states():
    """K1 step by step from the plain version's own states gives them back
    bit for bit (the check compares only the last step's sums); keeping
    the add in f32 moves more than the limit, as it does on the card."""
    rng = np.random.default_rng(5)
    xin = torch.as_tensor(rng.normal(size=(3, 40, 64)) * 0.5,
                          dtype=torch.float32).bfloat16()
    w = torch.as_tensor(rng.uniform(-1, 1, size=(64, 64)) / 8,
                        dtype=torch.float32).bfloat16()
    hs = FR.fused_rnn_plain(xin, w)
    assert torch.equal(CS.rnn_steps_plain(xin, w, hs), hs)
    plain, ctrl = CS.OffShare(), CS.OffShare()
    plain.add(hs, CS.rnn_steps_plain(xin, w, hs))
    hc = CS.rnn_add_unrounded(xin, w)
    ctrl.add(hc, CS.rnn_steps_plain(xin, w, hc))
    out = CS.check_rounding("fused_rnn_bf16", plain, {"add_unrounded": ctrl})
    assert out["kernel"] == 0.0


def test_rounding_check_steps_k10_from_its_own_output():
    """K10 bf16's plain version step by step from its own dx gives dx back
    bit for bit and dW within a flip of its entries (the plain version sums
    dW step by step, the check in one product); carrying da unrounded and
    rounding dW per split move more than the limit, as on the card."""
    bf = torch.bfloat16
    rng = np.random.default_rng(8)
    hs = torch.tanh(torch.as_tensor(rng.normal(size=(4, 40, 64)),
                                    dtype=torch.float32)).to(bf)
    w = torch.as_tensor(rng.uniform(-1, 1, size=(64, 64)) / 8,
                        dtype=torch.float32).to(bf)
    g = torch.as_tensor(rng.normal(size=(4, 40, 64)),
                        dtype=torch.float32).to(bf)
    dx, dw = FR.fused_rnn_bwd_plain(hs, w, g)
    steps, dw_steps = CS.rnn_bwd_steps_plain(hs, w, g, dx)
    assert torch.equal(steps, dx)
    plain, controls = CS.OffShare(), {}
    CS.hold_rnn_bwd_steps(plain, hs, w, g, dx, dw)
    plan = FR.RNNBwdPlan(FR.fused_rnn_bwd_plan(4, 40, 64).walk, 32, 5)
    for name, (cx, cw) in (
            ("da_unrounded", CS.rnn_bwd_da_unrounded(hs, w, g)),
            ("dw_split_rounded", (dx, CS.rnn_bwd_dw_split_rounded(
                hs, dx, plan)))):
        controls[name] = CS.OffShare()
        CS.hold_rnn_bwd_steps(controls[name], hs, w, g, cx, cw)
    out = CS.check_rounding("fused_rnn_bwd_bf16", plain, controls)
    assert out["kernel"] <= 1e-3


def test_rounding_check_tells_k11_controls_from_the_plain_version(
        layer_bf16):
    """At the small width too, K11's controls (the attention's operands
    unrounded, the f32 version on widened inputs) move more than the limit;
    the plain version against itself moves nothing."""
    _, wt = layer_bf16
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(3, 10, 32)),
                        dtype=torch.float32).bfloat16()
    yr = ET.encoder_layer_train_plain(x, wt, 0, 4, 0.0, False, 8)
    plain, controls = CS.OffShare(), {}
    plain.add(yr, ET.encoder_layer_train_plain(x, wt, 0, 4, 0.0, False, 8))
    for name, yc in (
            ("attention_unrounded",
             CS.encoder_attention_unrounded(x, wt, 4)),
            ("f32_widened", ET.encoder_layer_train_plain(
                x.float(), tuple(w.float() for w in wt), 0, 4, 0.0, False,
                8).bfloat16())):
        controls[name] = CS.OffShare()
        controls[name].add(yc, yr)
    out = CS.check_rounding("encoder_layer_fwd_bf16", plain, controls)
    assert out["kernel"] == 0.0


@pytest.mark.parametrize("name", sorted(CS.ROUND_SHARE))
def test_rounding_check_refuses(name):
    """A kernel share over the limit fails, and so does a control within
    it (the check would be blind); the library's reading is not held."""
    n = 1000
    k = int(np.ceil(2 * CS.ROUND_SHARE[name] * n))
    a = torch.zeros(n)
    b = a.clone()
    b[:k] = 1.0
    off, same = CS.OffShare(), CS.OffShare()
    off.add(b, a)
    same.add(a, a)
    with pytest.raises(AssertionError, match="rounds at other places"):
        CS.check_rounding(name, off, {"control": off})
    with pytest.raises(AssertionError, match="cannot tell"):
        CS.check_rounding(name, same, {"control": same})
    CS.check_rounding(name, same, {"control": off,
                                   CS.ROUND_READ_ONLY[0]: same})
