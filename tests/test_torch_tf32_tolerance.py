"""What grounds K12's tolerance on the card now that its products run on
the tensor cores in 3xTF32 (csrc/train_mma.cuh).

chip_smoke.py holds K12 against ``encoder_layer_bwd_plain`` within
``TOL_TRAIN_K["encoder_layer_bwd"]`` (1e-3 of each output's largest
entry). Here, on the CPU, the plain backward runs in float32 with its 2-D
products (the ones K12 takes to the tensor cores; attention's batched
products stay f32 on the CUDA cores) replaced by an emulation of TF32
products, summed in f32. Two 3xTF32 splits are emulated: the kernel's
(the high part is x with its 13 low mantissa bits cleared, the residual
x - hi is read by the tensor cores, which ignore its 13 low bits) and the
one with both parts rounded as ``cvt.rna.tf32.f32`` rounds (10 explicit
mantissa bits, to nearest, ties away from zero). Against the float64
plain version the kernel's split stays within 3x the plain f32 version's
error (1.0-1.7e-6 of the largest entry against 4-8e-7), the rounded one
within 2x (5-7e-7), both more than 300x inside the tolerance; one TF32
product (rounded as cvt.rna) does not: on chip_smoke.py's small case it
misses the tolerance by more than 5x (7.1e-3), and on a wider case it
lands within 2x of it (5-6e-4) with 300x the 3xTF32 error.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from chip_smoke import TOL_TRAIN_K
from tip_tpu_torch.models import tip_model as TM
from tip_tpu_torch.ops import encoder_train as ET

torch.set_num_threads(1)

TOL = TOL_TRAIN_K["encoder_layer_bwd"]
SEED = -5
# name: (d, ff, heads, B, T, p, ff1 bias shift); the shift of 2 centres the
# ff1 pre-activations away from the ReLU kink, as chip_smoke.py's
# full-width check does
CASES = {"small_2tiles": (32, 64, 4, 16, 10, 0.1, 0.0),
         "wide_shifted": (64, 256, 4, 8, 40, 0.1, 2.0)}


def tf32(x):
    """Round float32 to TF32 as cvt.rna.tf32.f32: add half of the 13
    dropped bits' unit to the magnitude and drop them (ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x):
    """The TF32 value the tensor cores read from a float32 register: the
    13 low mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def one_tf32(a, b):
    return tf32(a) @ tf32(b)


def three_tf32(a, b, rnd):
    a_hi, b_hi = rnd(a), rnd(b)
    a_lo, b_lo = rnd(a - a_hi), rnd(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


SPLITS = {"kernel": lambda a, b: three_tf32(a, b, tf32_cut),
          "rna": lambda a, b: three_tf32(a, b, tf32)}
# each split's error at most this many times the plain f32 version's
F32_FACTOR = {"kernel": 3.0, "rna": 2.0}


class Products(TorchFunctionMode):
    """Every product of two matrices through ``fn``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in (torch.matmul, torch.Tensor.matmul,
                     torch.Tensor.__matmul__)
                and args[0].dim() == 2 and args[1].dim() == 2):
            return self.fn(*args)
        return func(*args, **(kwargs or {}))


def _worst(name, fn):
    """The largest error, relative to each output's largest entry, of the
    f32 backward with products ``fn`` (None: plain f32) against f64."""
    d, ff, nh, B, T, p, shift = CASES[name]
    model = TM.TIPModel(TM.ModelConfig(tf_in_dim=d, tf_hid_size=ff,
                                       n_heads=nh, tf_layers=1,
                                       rnn_hid_size=32), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    ws = list(ET.pack_layer_weights(dict(model.named_parameters()),
                                    "layers.0."))
    ws[5] = ws[5] + shift
    ws = tuple(w.detach() for w in ws)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(B, T, d)), dtype=torch.float32)
    dy = torch.as_tensor(rng.normal(size=(B, T, d)), dtype=torch.float32)
    ref = ET.encoder_layer_bwd_plain(x.double(), tuple(w.double() for w in ws),
                                     SEED, dy.double(), nh, p, True)
    if fn is None:
        out = ET.encoder_layer_bwd_plain(x, ws, SEED, dy, nh, p, True)
    else:
        with Products(fn):
            out = ET.encoder_layer_bwd_plain(x, ws, SEED, dy, nh, p, True)
    pairs = [(out[0], ref[0])] + list(zip(out[1], ref[1]))
    return max(((a.double() - b).abs().max() / b.abs().max()).item()
               for a, b in pairs)


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -20],
                     dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    assert tf32(x).tolist() == want
    assert tf32_cut(x).tolist() == [1.0, 1.0 + 2.0 ** -10, -1.0, 1.0]


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_products_hold_k12_within_its_tolerance(name, split):
    err_3x = _worst(name, SPLITS[split])
    err_f32 = _worst(name, None)
    err_1x = _worst(name, one_tf32)
    assert err_3x <= TOL / 300, (err_3x, err_f32)
    assert err_3x <= F32_FACTOR[split] * err_f32, (err_3x, err_f32)
    # one TF32 product: at least 300x the error, and no headroom
    assert err_1x >= 300 * err_3x and err_1x >= TOL / 2, (err_1x, err_3x)


def test_one_tf32_product_misses_k12s_tolerance():
    err_1x = _worst("small_2tiles", one_tf32)
    assert err_1x > 5 * TOL, err_1x


# K9 (csrc/fused_recompute_batch.cu) with f32 packing takes its seven
# kinds of weight products to the tensor cores in 3xTF32 (K = 221, 256,
# 1024, 512: the in-projection, qkv / out / ff1 / w_ih, ff2, the
# out-projection); attention and the RNN's steps stay f32 on the CUDA
# cores. chip_smoke.py holds K9 against fused_recompute_batch_plain within
# TOL_FF["float32"].
class WeightProducts(TorchFunctionMode):
    """Every product whose right operand is one of ``weights`` (a matrix
    times a stack of rows) through ``fn``; every other product as it is."""

    def __init__(self, fn, weights):
        super().__init__()
        self.fn, self.ids = fn, {id(w) for w in weights}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in (torch.matmul, torch.Tensor.matmul,
                     torch.Tensor.__matmul__) and id(args[1]) in self.ids):
            a = args[0]
            out = self.fn(a.reshape(-1, a.shape[-1]), args[1])
            return out.reshape(a.shape[:-1] + (args[1].shape[1],))
        return func(*args, **(kwargs or {}))


def test_3xtf32_products_hold_k9_within_its_tolerance():
    """The kernel's 3xTF32 split through the plain recompute of a (4, 40)
    batch at full width (mixed k_last, NaN history entries): within 1e-5
    of the f32 plain version, 5x inside (1.0e-6, the size of the 1.3e-6
    that K4's f32 sums in another order show on the card); one TF32 product
    is not (4.7e-4)."""
    from chip_smoke import TOL_FF
    from tip_tpu_torch.ops import fused_forward as FF
    model = TM.TIPModel(TM.ModelConfig(), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    ws = model.packed_weights(torch.float32)
    L = model.cfg.tf_layers
    w_hh = ws[2 + 12 * L + 2]
    mats = [w for w in ws if w.dim() == 2 and w is not w_hh]
    assert sorted({w.shape[0] for w in mats}) == [221, 256, 512, 1024]
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(4, 40, model.cfg.input_dim)),
                        dtype=torch.float32)
    x[:, ::3, 100] = float("nan")
    ks = [0, 3, 17, 39]
    ref = FF.fused_recompute_batch_plain(ws, x, ks, model.cfg)
    errs = {}
    for name, fn in (("3xtf32", SPLITS["kernel"]), ("1xtf32", one_tf32)):
        with WeightProducts(fn, mats):
            y = FF.fused_recompute_batch_plain(ws, x, ks, model.cfg)
        errs[name] = (y - ref).abs().max().item()
    assert errs["3xtf32"] <= TOL_FF["float32"] / 5, errs
    assert errs["1xtf32"] > TOL_FF["float32"], errs


# K10 (csrc/fused_rnn_bwd.cu) computes dW = sum over b, t of h_{t-1}^T da_t
# as one (H x B T) (B T x H) product on the tensor cores in 3xTF32, after
# its walk has formed da in f32 on the CUDA cores. chip_smoke.py holds it
# against fused_rnn_bwd_plain within TOL_TRAIN_K["fused_rnn_bwd"], 1e-4 of
# the largest entry.
def _rnn_dw_errors(B, T, H):
    """dW's error, relative to its largest entry, against the float64
    plain backward: as one f32 product of the f32 walk's da, and through
    the kernel's 3xTF32 split and one TF32 product."""
    from tip_tpu_torch.ops import fused_rnn as FR
    rng = np.random.default_rng(0)
    xin = torch.as_tensor(rng.normal(size=(B, T, H)) * 0.7)
    w = torch.as_tensor(rng.normal(size=(H, H)) / np.sqrt(H))
    g = torch.as_tensor(rng.normal(size=(B, T, H)))
    hs = FR.fused_rnn_plain(xin, w)
    _, ref = FR.fused_rnn_bwd_plain(hs, w, g)
    da, _ = FR.fused_rnn_bwd_plain(hs.float(), w.float(), g.float())
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1)
    a = h_prev.float().reshape(-1, H).T.contiguous()
    b = da.reshape(-1, H)
    return {name: ((fn(a, b).double() - ref).abs().max()
                   / ref.abs().max()).item()
            for name, fn in (("f32", torch.matmul),
                             ("3xtf32", SPLITS["kernel"]),
                             ("1xtf32", one_tf32))}


def test_3xtf32_dw_holds_k10_within_its_tolerance():
    """At (8, 40, 128): the kernel's split within 2x of one f32 product's
    error and over 100x inside the tolerance (7.6e-7 against 5.4e-7); one
    TF32 product misses it (2.5e-4)."""
    from chip_smoke import TOL_TRAIN_K
    tol = TOL_TRAIN_K["fused_rnn_bwd"]
    errs = _rnn_dw_errors(8, 40, 128)
    assert errs["3xtf32"] <= tol / 100, errs
    assert errs["3xtf32"] <= 2 * errs["f32"], errs
    assert errs["1xtf32"] > 2 * tol, errs


# K8 (csrc/fused_cached_batch.cu) with f32 packing takes its weight
# products to the tensor cores in 3xTF32 too: the in-projection, the
# layers' four, the RNN inputs of the ring rows and of the token, a
# carry's product of the carried hidden with W_hh, and the out-projection;
# attention and a replay's RNN steps stay f32 on the CUDA cores.
# chip_smoke.py holds K8 against fused_cached_batch_plain within
# TOL_FF["float32"].
@pytest.mark.parametrize("rnn_carry", [False, True], ids=["replay", "carry"])
def test_3xtf32_products_hold_k8_within_its_tolerance(rnn_carry):
    """The kernel's 3xTF32 split through K8's plain version at full width:
    4 streams over rings of 40 random rows (a few slots invalid), one
    stream uncommitted, NaN history entries; the committed streams' y
    within 1e-5 of the f32 plain version, over 10x inside (7.2e-7 in
    both variants); one TF32 product is not (3.6e-4 replay, 4.2e-4
    carry)."""
    from chip_smoke import TOL_FF
    from tip_tpu_torch.runtime import streaming_cache as SC
    model = TM.TIPModel(TM.ModelConfig(), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    cfg = model.cfg
    ws = model.packed_weights(torch.float32)
    w_hh = ws[2 + 12 * cfg.tf_layers + 2]
    mats = [w for w in ws if w.dim() == 2 and (rnn_carry or w is not w_hh)]
    rng = np.random.default_rng(5)
    B, W = 4, 40
    cache = SC.cache_init(cfg, W, device="cpu", batch=B)
    for n in ("k", "v", "enc", "h"):
        t = getattr(cache, n)
        t.copy_(torch.as_tensor(rng.normal(size=t.shape), dtype=t.dtype))
    cache.valid.copy_(torch.as_tensor(rng.random((B, W)) > 0.1))
    x = torch.as_tensor(rng.normal(size=(B, cfg.input_dim)),
                        dtype=torch.float32)
    x[:, 100] = float("nan")
    commit = torch.tensor([True, True, False, True])

    def y_of():
        _, y = SC.fused_cached_batch_plain(ws, cache.clone(), x, 7, commit,
                                           cfg, rnn_carry=rnn_carry)
        return y[commit]

    ref = y_of()
    errs = {}
    for name, fn in (("3xtf32", SPLITS["kernel"]), ("1xtf32", one_tf32)):
        with WeightProducts(fn, mats):
            errs[name] = (y_of() - ref).abs().max().item()
    assert errs["3xtf32"] <= TOL_FF["float32"] / 5, errs
    assert errs["1xtf32"] > TOL_FF["float32"], errs
