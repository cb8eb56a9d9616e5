"""One post-norm transformer encoder layer for training, forward and backward
(twin of tip_tpu/ops/pallas_encoder.py).

    qkv = x Wqkv + bqkv; per sample and head: P = softmax(q k^T * scale,
    causal), att = (P * mask_h) v; y1 = LN1(x + (att Wo + bo) * mask_100);
    f1 = relu(y1 W1 + b1); y = LN2(y1 + ((f1 * mask_101) W2 + b2) * mask_102)

Kernel K11 (``csrc/encoder_train.cu``, ``encoder_layer_fwd``) computes the
forward, K12 (``encoder_layer_bwd``) the backward, both with 3xTF32
products on the tensor cores (about f32's accuracy): K12 recomputes the
forward from x (K11's launches), as tip_tpu's kernel does, and
regenerates the four dropout sites' masks from the seed, so nothing but x
is saved between them. Both also take bf16 x (and dy) and matmul weights
(f32 LayerNorm vectors), as tip_tpu's kernels do: every product rounds
both operands to bf16 (q k^T and p v, and the attention backward's four,
too) and sums in f32; biases, LayerNorm and its backward, softmax, dReLU,
masks, residuals and column sums stay f32; y and dx are written in bf16,
the matmul-weight and bias gradients rounded to bf16 once from f32, the
LayerNorm gradients in f32. The plain versions round at the same places.
The bf16 variants run their products on csrc/bf16_gemm.cuh (wgmma on bf16
tiles that TMA stages) by a launch plan that is a pure function of the
shapes (``encoder_bf16_plan``), in a scratch whose layout is computed here
(``bf16_scratch_layout``) and passed to the launch.
``encoder_layer_train`` is the differentiable layer (a
``torch.autograd.Function``): K11 and K12 on CUDA tensors, the plain
versions on CPU tensors.

Masks follow tip_tpu's batch tiles: the batch is cut into tiles of ``bt``
samples (``pick_tile``), tile i has the seed ``seed + i * 104729`` (int32
wraparound); within a tile, head h's attention mask (site h) is indexed
over the tile's (bt*T, bt*T) score matrix, row s*T + i and column s*T + j
for sample s of the tile, and the sites 100, 101, 102 over the tile's rows.
Attention runs per sample here: tip_tpu's block-diagonal matrix over the
tile gives the same values, since its off-sample entries are exactly 0.
"""

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops.hashmask import keep_mask_at
from tip_tpu_torch.ops.tiling import pick_tile

SITE_ATTN_HEAD0 = 0           # heads use sites 0 .. n_heads - 1
SITE_POST_ATTN = 100
SITE_FF_MID = 101
SITE_POST_FF = 102
TILE_SEED_STRIDE = 104729
WEIGHT_NAMES = ("w_qkv", "b_qkv", "w_o", "b_o", "w_f1", "b_f1", "w_f2",
                "b_f2", "ln1_s", "ln1_b", "ln2_s", "ln2_b")

_TAIL_ARGS = ([ctypes.c_int] * 7
              + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p])
_FWD_ARGS = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
             ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)] + _TAIL_ARGS
_FWD_BF16_ARGS = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                  ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                  ctypes.POINTER(ctypes.c_int)] + _TAIL_ARGS
_BWD_HEAD = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
             ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
_BWD_ARGS = _BWD_HEAD + [ctypes.POINTER(ctypes.c_void_p)] + _TAIL_ARGS
_BWD_BF16_ARGS = _BWD_HEAD + [ctypes.POINTER(ctypes.c_void_p),
                              ctypes.POINTER(ctypes.c_int)] + _TAIL_ARGS
_SIG = {
    "encoder_layer_part_floats": [ctypes.c_int] * 3
                                 + [ctypes.POINTER(ctypes.c_longlong)],
    "encoder_layer_fwd_launch": _FWD_ARGS,
    "encoder_layer_fwd_bf16_launch": _FWD_BF16_ARGS,
    "encoder_layer_bwd_launch": _BWD_ARGS,
    "encoder_layer_bwd_bf16_launch": _BWD_BF16_ARGS,
}


def pack_layer_weights(p, pre: str, dtype=None):
    """Layer parameters ``p[pre + name]`` (the model's state-dict names) ->
    the kernels' 12-tuple (q, k, v packed into one (d, 3d) matrix). The
    LayerNorm vectors stay float32, float64 when ``dtype`` is float64."""
    dtype = p[pre + "w_q"].dtype if dtype is None else dtype
    ln = torch.float64 if dtype == torch.float64 else torch.float32
    w_qkv = torch.cat([p[pre + "w_q"], p[pre + "w_k"], p[pre + "w_v"]], 1)
    b_qkv = torch.cat([p[pre + "b_q"], p[pre + "b_k"], p[pre + "b_v"]])
    return (w_qkv.to(dtype), b_qkv.to(dtype), p[pre + "out_proj.w"].to(dtype),
            p[pre + "out_proj.b"].to(dtype), p[pre + "ff1.w"].to(dtype),
            p[pre + "ff1.b"].to(dtype), p[pre + "ff2.w"].to(dtype),
            p[pre + "ff2.b"].to(dtype), p[pre + "ln1_s"].to(ln),
            p[pre + "ln1_b"].to(ln), p[pre + "ln2_s"].to(ln),
            p[pre + "ln2_b"].to(ln))


def _int32(v: int) -> int:
    return (int(v) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _compute_dtype(ws):
    return torch.float64 if ws[0].dtype == torch.float64 else torch.float32


def _operand(ws):
    """How a product's operands are read: with bf16 matmul weights both are
    rounded to bf16 (their f32 image) and the product sums in f32, as
    tip_tpu's ``dot`` casts them; else as they are."""
    if ws[0].dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    return lambda t: t


class _Masks:
    """The keep values of one layer call's four sites (None: no dropout)."""

    def __init__(self, seed, B, T, bt, p, on, dtype, device):
        self.on = on
        if not on:
            return
        self.T, self.bt, self.pk, self.dtype = T, bt, 1.0 - p, dtype
        b = torch.arange(B, device=device)
        self.seed = (_int32(seed)
                     + (b // bt).to(torch.int64) * TILE_SEED_STRIDE)  # (B,)
        self.row0 = (b % bt).to(torch.int64) * T                  # (B,)

    def rows(self, site, ncols):
        """(B, T, ncols): row s*T + t of the tile, column c."""
        if not self.on:
            return None
        dev = self.seed.device
        r = self.row0[:, None] + torch.arange(self.T, device=dev)[None, :]
        idx = r[:, :, None] * ncols + torch.arange(ncols, device=dev)
        return keep_mask_at(self.seed[:, None, None], site, idx, self.pk,
                            self.dtype)

    def attention(self, n_heads):
        """(B, n_heads, T, T): head h's site over the tile's score matrix."""
        if not self.on:
            return None
        dev = self.seed.device
        t = torch.arange(self.T, device=dev)
        r = self.row0[:, None] + t                                # (B, T)
        idx = r[:, :, None] * (self.bt * self.T) + r[:, None, :]
        return torch.stack([keep_mask_at(self.seed[:, None, None],
                                         SITE_ATTN_HEAD0 + h, idx, self.pk,
                                         self.dtype)
                            for h in range(n_heads)], dim=1)


def _ln_fwd(x, s, b, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    rs = torch.rsqrt(var + eps)
    xhat = (x - mu) * rs
    return xhat * s + b, xhat, rs


def _ln_bwd(dy, xhat, rs, s):
    dxh = dy * s
    m1 = torch.mean(dxh, dim=-1, keepdim=True)
    m2 = torch.mean(dxh * xhat, dim=-1, keepdim=True)
    dr = rs * (dxh - m1 - xhat * m2)
    return dr, torch.sum(dy * xhat, dim=0), torch.sum(dy, dim=0)


def _fwd_math(x, ws, masks, n_heads):
    """The forward over x (B, T, d) in the compute dtype; returns y (B*T,
    d) and what the backward reuses."""
    op = _operand(ws)
    f = x.dtype
    (w_qkv, b_qkv, w_o, b_o, w_f1, b_f1, w_f2, b_f2, g1, be1, g2, be2) = (
        w.to(f) for w in ws)
    B, T, d = x.shape
    hd = d // n_heads
    scale = 1.0 / math.sqrt(hd)          # rounded to x's dtype where used
    xf = x.reshape(B * T, d)
    qkv = op(xf) @ w_qkv + b_qkv

    def heads(t):
        return t.reshape(B, T, n_heads, hd).transpose(1, 2)   # (B, h, T, hd)

    q, k, v = heads(qkv[:, :d]), heads(qkv[:, d:2 * d]), heads(qkv[:, 2 * d:])
    causal = torch.triu(torch.full((T, T), -1e30, dtype=f, device=x.device),
                        diagonal=1)
    p_h = torch.softmax((op(q) @ op(k).transpose(-1, -2)) * scale + causal,
                        dim=-1)
    m_att = masks.attention(n_heads)
    pd = p_h * m_att if masks.on else p_h
    att = (op(pd) @ op(v)).transpose(1, 2).reshape(B * T, d)
    a = op(att) @ w_o + b_o
    if masks.on:
        a = a * masks.rows(SITE_POST_ATTN, d).reshape(B * T, d)
    y1, xhat1, rs1 = _ln_fwd(xf + a, g1, be1)
    f1 = torch.clamp_min(op(y1) @ w_f1 + b_f1, 0.0)
    f1d = f1
    if masks.on:
        f1d = f1 * masks.rows(SITE_FF_MID, w_f1.shape[1]).reshape(B * T, -1)
    f2 = op(f1d) @ w_f2 + b_f2
    if masks.on:
        f2 = f2 * masks.rows(SITE_POST_FF, d).reshape(B * T, d)
    y2, xhat2, rs2 = _ln_fwd(y1 + f2, g2, be2)
    stash = dict(q=q, k=k, v=v, p=p_h, m_att=m_att, att=att, y1=y1,
                 xhat1=xhat1, rs1=rs1, f1=f1, f1d=f1d, xhat2=xhat2, rs2=rs2,
                 scale=scale)
    return y2, stash


def attention_bwd(p_h, m_att, q, k, v, do, scale, op):
    """The attention backward of each (sample, head), (B, h, T, ·): the
    probabilities p_h, the keep values m_att (None: no dropout), q, k, v
    and the output gradient do. Each of the four products' operands go
    through op (``_operand``). Returns (dq, dk, dv)."""
    pd = p_h if m_att is None else p_h * m_att
    dv = op(pd).transpose(-1, -2) @ op(do)
    dpd = op(do) @ op(v).transpose(-1, -2)
    dp = dpd if m_att is None else dpd * m_att
    ds = p_h * (dp - torch.sum(dp * p_h, dim=-1, keepdim=True))
    dq = (op(ds) @ op(k)) * scale
    dk = (op(ds).transpose(-1, -2) @ op(q)) * scale
    return dq, dk, dv


def _prepare(x, ws, seed, p, train, bt):
    B, T, d = x.shape
    bt = pick_tile(B, bt, "encoder_layer_train")
    f = _compute_dtype(ws)
    masks = _Masks(seed, B, T, bt, p, bool(train) and p > 0.0, f, x.device)
    return x.to(f), masks


def encoder_layer_train_plain(x, ws, seed, n_heads: int, p: float,
                              train: bool, bt: int = 8):
    """Plain PyTorch version of K11 (tip_tpu's ``encoder_layer_reference``):
    x (B, T, d), ws the 12-tuple of ``pack_layer_weights``, seed an int32.
    Returns y (B, T, d) in x's dtype."""
    xf, masks = _prepare(x, ws, seed, p, train, bt)
    y, _ = _fwd_math(xf, ws, masks, n_heads)
    return y.reshape(x.shape).to(x.dtype)


def encoder_layer_bwd_plain(x, ws, seed, dy, n_heads: int, p: float,
                            train: bool, bt: int = 8):
    """Plain PyTorch version of K12 (tip_tpu's ``_bwd_kernel``): recompute
    the forward, then walk it backwards with the same masks. Returns (dx in
    x's dtype, the 12 weight gradients in the weights' dtypes). With bf16
    weights both operands of each of the 12 backward products are rounded
    to bf16 and the sums are f32, as tip_tpu's ``dot`` casts them."""
    B, T, d = x.shape
    xf, masks = _prepare(x, ws, seed, p, train, bt)
    f = xf.dtype
    op = _operand(ws)
    (w_qkv, b_qkv, w_o, b_o, w_f1, b_f1, w_f2, b_f2, g1, be1, g2, be2) = (
        w.to(f) for w in ws)
    _, st = _fwd_math(xf, ws, masks, n_heads)
    dy = dy.to(f).reshape(B * T, d)
    dr2, dg2, dbe2 = _ln_bwd(dy, st["xhat2"], st["rs2"], g2)
    df2 = dr2
    if masks.on:
        df2 = df2 * masks.rows(SITE_POST_FF, d).reshape(B * T, d)
    dwf2 = op(st["f1d"]).T @ op(df2)
    dbf2 = torch.sum(df2, dim=0)
    df1d = op(df2) @ w_f2.T
    if masks.on:
        df1d = df1d * masks.rows(SITE_FF_MID, w_f1.shape[1]).reshape(
            B * T, -1)
    dh1 = df1d * (st["f1"] > 0).to(f)
    dwf1 = op(st["y1"]).T @ op(dh1)
    dbf1 = torch.sum(dh1, dim=0)
    dy1 = dr2 + op(dh1) @ w_f1.T
    dr1, dg1, dbe1 = _ln_bwd(dy1, st["xhat1"], st["rs1"], g1)
    da = dr1
    if masks.on:
        da = da * masks.rows(SITE_POST_ATTN, d).reshape(B * T, d)
    dwo = op(st["att"]).T @ op(da)
    dbo = torch.sum(da, dim=0)
    datt = op(da) @ w_o.T
    hd = d // n_heads
    do = datt.reshape(B, T, n_heads, hd).transpose(1, 2)         # (B,h,T,hd)
    dq, dk, dv = attention_bwd(st["p"], st["m_att"], st["q"], st["k"],
                               st["v"], do, st["scale"], op)

    def flat(t):
        return t.transpose(1, 2).reshape(B * T, d)

    dqkv = torch.cat([flat(dq), flat(dk), flat(dv)], dim=1)
    xr = xf.reshape(B * T, d)
    dwqkv = op(xr).T @ op(dqkv)
    dbqkv = torch.sum(dqkv, dim=0)
    dx = dr1 + op(dqkv) @ w_qkv.T
    grads = (dwqkv, dbqkv, dwo, dbo, dwf1, dbf1, dwf2, dbf2, dg1, dbe1, dg2,
             dbe2)
    return (dx.reshape(B, T, d).to(x.dtype),
            tuple(g.to(w.dtype) for g, w in zip(grads, ws)))


def _check_dtypes(x, ws):
    """x and the eight matmul weights and biases in one dtype, the four
    LayerNorm vectors in float32 (float64 with a float64 x), as
    ``pack_layer_weights`` packs them: a mixed call raises on either
    route."""
    ln = torch.float64 if x.dtype == torch.float64 else torch.float32
    for i, (w, name) in enumerate(zip(ws, WEIGHT_NAMES)):
        want = x.dtype if i < 8 else ln
        if w.dtype != want:
            raise TypeError(f"encoder_layer: {name} is {w.dtype} where x is "
                            f"{x.dtype}; expected {want}")


def _check(x, ws, n_heads, bt, extra=()):
    """Check the layer's inputs: x and the matmul weights float32 or
    bfloat16, the LayerNorm vectors float32. K11's and K12's tensor-core
    products and K12's attention backward read 16 bytes at a time: d, ff
    and the head width multiples of 4 (8 in bf16), aligned data."""
    B, T, d = x.shape
    ff = ws[4].shape[1]
    shapes = ((d, 3 * d), (3 * d,), (d, d), (d,), (d, ff), (ff,), (ff, d),
              (d,), (d,), (d,), (d,), (d,))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: dtype {x.dtype}, expected float32 or bfloat16")
    K.check_input(x, "x", (B, T, d), x.dtype, x.device)
    for i, (w, name, shape) in enumerate(zip(ws, WEIGHT_NAMES, shapes)):
        K.check_input(w, name, shape, x.dtype if i < 8 else torch.float32,
                      x.device)
    if d % n_heads or d > 1024:
        raise ValueError(f"encoder_layer: d={d} must be a multiple of "
                         f"n_heads={n_heads} and at most 1024")
    m = 16 // x.element_size()
    if (d % m or ff % m or (d // n_heads) % m or any(
            t.data_ptr() % 16 for t in (x, *ws, *extra))):
        raise ValueError(f"encoder_layer: the tensor-core kernels take d, "
                         f"ff and d / n_heads multiples of {m} in "
                         f"{x.dtype} (d={d}, ff={ff}, n_heads={n_heads}) "
                         f"and 16-byte aligned tensors")
    return B, T, d, ff, pick_tile(B, bt, "encoder_layer_train")


def _drop_args(p, train):
    on = bool(train) and p > 0.0
    pk = 1.0 - p if on else 1.0
    return (ctypes.c_float(np.float32(pk)),
            ctypes.c_float(np.float32(1.0 / pk)), int(on))


_part_floats = {}             # (N, d, ff) -> floats, asked once


def part_floats(N, d, ff):
    """Floats of the weight and bias gradients' partial sums that the f32
    K12 takes for N = B*T rows (its scratch's last array; asked of the
    library once: they follow csrc/train_mma.cuh's split of each sum)."""
    key = (N, d, ff)
    if key not in _part_floats:
        n = ctypes.c_longlong()
        so = K.lib("encoder_train", _SIG)
        K.check(so.encoder_layer_part_floats(N, d, ff, ctypes.byref(n)),
                "encoder_layer_part_floats")
        _part_floats[key] = n.value
    return _part_floats[key]


# ---------------------------------------------------------------------------
# The bf16 variants' launch plan and scratch layout (pure functions of the
# shapes; csrc/encoder_train.cu takes both as the wrapper passes them)
# ---------------------------------------------------------------------------

SM_COUNT = 132               # an H100's SMs: the blocks a launch should fill
GEMM_BM = 64                 # csrc/bf16_gemm.cuh's rows of a warpgroup;
#                              a bias gradient's partial sums come by them
GEMM_BK = 64                 # and its depth of a staged slice
MAX_SPLITS = 16              # a tile's splits are one cluster of blocks
LN_ROWS = 16                 # rows of a LayerNorm backward block
# The layer's products in csrc/encoder_train.cu's order (kPQkv ..): name,
# layout (NN: A (M, K) B (K, N); NT: B stored (N, K); TN: A stored (K, M))
# and (M, N, K) from (rows R = B*T, d, ff)
PRODUCTS = (
    ("qkv", "NN", lambda R, d, ff: (R, 3 * d, d)),
    ("out", "NN", lambda R, d, ff: (R, d, d)),
    ("ff1", "NN", lambda R, d, ff: (R, ff, d)),
    ("ff2", "NN", lambda R, d, ff: (R, d, ff)),
    ("dh1", "NT", lambda R, d, ff: (R, ff, d)),
    ("dw_f2", "TN", lambda R, d, ff: (ff, d, R)),
    ("dy1", "NT", lambda R, d, ff: (R, d, ff)),
    ("dw_f1", "TN", lambda R, d, ff: (d, ff, R)),
    ("datt", "NT", lambda R, d, ff: (R, d, d)),
    ("dw_o", "TN", lambda R, d, ff: (d, d, R)),
    ("dx", "NT", lambda R, d, ff: (R, d, 3 * d)),
    ("dw_qkv", "TN", lambda R, d, ff: (d, 3 * d, R)),
)


def _cdiv(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ProductPlan:
    """One product's launch (csrc/bf16_gemm.cuh): tiles of ``bm`` x ``bn``
    outputs, K cut into ``splits`` chunks of ``kchunk`` rows (whole 64-deep
    slices); a tile's splits are one cluster whose blocks add their f32
    sums in rank order s = 0, 1, ... ``reason`` says why it launches fewer
    than SM_COUNT blocks, where it does."""
    name: str
    layout: str
    M: int
    N: int
    K: int
    bm: int
    bn: int
    kchunk: int
    splits: int
    reason: str

    @property
    def tiles(self):
        return _cdiv(self.M, self.bm) * _cdiv(self.N, self.bn)

    @property
    def ctas(self):
        return self.tiles * self.splits


def product_plan(name, layout, M, N, K) -> ProductPlan:
    """The launch of an (M, N, K) product: the first of these that gives
    SM_COUNT blocks: 128 x 128 tiles (where they give two blocks an SM:
    half the bytes from L2 of 64-row tiles), 64 x 128, 64 x 64, then 64 x
    128 and 64 x 64 with K split into the fewest chunks that reach
    SM_COUNT blocks (at most MAX_SPLITS, at least one slice each); else 64
    x 64 tiles split into as many chunks as K allows."""
    kb = _cdiv(K, GEMM_BK)                     # 64-deep slices
    most = min(kb, MAX_SPLITS)

    def tiles(bm, bn):
        return _cdiv(M, bm) * _cdiv(N, bn)

    if tiles(128, 128) >= 2 * SM_COUNT:
        choice = (128, 128, 1)
    elif tiles(64, 128) >= SM_COUNT:
        choice = (64, 128, 1)
    elif tiles(64, 64) >= SM_COUNT:
        choice = (64, 64, 1)
    else:
        choice = None
        for bn in (128, 64):
            need = _cdiv(SM_COUNT, tiles(64, bn))
            if need <= most:
                choice = (64, bn, need)
                break
        if choice is None:
            choice = (64, 64, most)
    bm, bn, want = choice
    per = _cdiv(kb, want)                      # slices a split
    splits = _cdiv(kb, per)
    if tiles(bm, bn) * splits < SM_COUNT and want > splits:
        # even chunks fell short of the blocks: one slice fewer a split
        fewer = max(1, kb // want)
        if _cdiv(kb, fewer) <= most:
            per, splits = fewer, _cdiv(kb, fewer)
    reason = ""
    if tiles(bm, bn) * splits < SM_COUNT:
        reason = (f"{M} x {N} outputs make {tiles(bm, bn)} tiles of {bm} x "
                  f"{bn} and K {K} {kb} slices of {GEMM_BK}, at most "
                  f"{splits} splits: {tiles(bm, bn) * splits} blocks")
    return ProductPlan(name, layout, M, N, K, bm, bn, per * GEMM_BK, splits,
                       reason)


@functools.lru_cache(maxsize=64)
def encoder_bf16_plan(B, T, d, ff):
    """The launches of the bf16 variants' twelve products (PRODUCTS) for
    x (B, T, d): K11 bf16 runs the first four, K12 bf16 all."""
    R = B * T
    return tuple(product_plan(name, lay, *mnk(R, d, ff))
                 for name, lay, mnk in PRODUCTS)


def plan_ints(plans):
    """The plan as the C entry points read it: (bm, bn, kchunk, splits) of
    each product."""
    return [v for p in plans for v in (p.bm, p.bn, p.kchunk, p.splits)]


ALIGN = 256                  # every scratch array starts at a multiple
# The bf16 variants' scratch arrays in csrc/encoder_train.cu's order (kQkv
# ..): name, dtype and shape from (N = B*T rows, d, ff, B, nl = the
# LayerNorm backward's blocks of LN_ROWS rows, nm = the products' 64-row
# tiles). K11 bf16 takes the first seven. bf16 where a product reads the
# values, f32 where f32 is read (residuals, LayerNorm inputs and
# statistics, the bias gradients' partial sums), the ReLU's signs a byte
# each
BF16_ARRAYS = (
    ("qkv", torch.bfloat16, lambda N, d, ff, B, nl, nm: (N, 3 * d)),
    ("att", torch.bfloat16, lambda N, d, ff, B, nl, nm: (N, d)),
    ("pre", torch.float32, lambda N, d, ff, B, nl, nm: (N, d)),
    ("y1", torch.float32, lambda N, d, ff, B, nl, nm: (N, d)),
    ("y1b", torch.bfloat16, lambda N, d, ff, B, nl, nm: (N, d)),
    ("f1d", torch.bfloat16, lambda N, d, ff, B, nl, nm: (N, ff)),
    ("pre2", torch.float32, lambda N, d, ff, B, nl, nm: (N, d)),
    ("y", torch.bfloat16, lambda N, d, ff, B, nl, nm: (N, d)),
    ("xhat1", torch.float32, lambda N, d, ff, B, nl, nm: (N, d)),
    ("rs1", torch.float32, lambda N, d, ff, B, nl, nm: (N,)),
    ("xhat2", torch.float32, lambda N, d, ff, B, nl, nm: (N, d)),
    ("rs2", torch.float32, lambda N, d, ff, B, nl, nm: (N,)),
    ("pos", torch.uint8, lambda N, d, ff, B, nl, nm: (N, ff)),
    ("dr2", torch.float32, lambda N, d, ff, B, nl, nm: (N, d)),
    ("df2", torch.bfloat16, lambda N, d, ff, B, nl, nm: (N, d)),
    ("dh1", torch.bfloat16, lambda N, d, ff, B, nl, nm: (N, ff)),
    ("dy1", torch.float32, lambda N, d, ff, B, nl, nm: (N, d)),
    ("dr1", torch.float32, lambda N, d, ff, B, nl, nm: (N, d)),
    ("da", torch.bfloat16, lambda N, d, ff, B, nl, nm: (N, d)),
    ("datt", torch.bfloat16, lambda N, d, ff, B, nl, nm: (N, d)),
    ("dqkv", torch.bfloat16, lambda N, d, ff, B, nl, nm: (N, 3 * d)),
    ("cp_ln2", torch.float32, lambda N, d, ff, B, nl, nm: (3, nl, d)),
    ("cp_dh1", torch.float32, lambda N, d, ff, B, nl, nm: (nm, ff)),
    ("cp_ln1", torch.float32, lambda N, d, ff, B, nl, nm: (3, nl, d)),
    ("cp_dqkv", torch.float32, lambda N, d, ff, B, nl, nm: (B, 3 * d)),
)
BF16_FWD_ARRAYS = 7


_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.uint8: 1}


class ScratchLayout:
    """Arrays (name -> (byte offset, dtype, shape)) laid one after another
    in one buffer of ``end`` bytes."""

    def __init__(self, specs, align):
        self.arrays, at = {}, 0
        for name, dtype, shape in specs:
            at = _cdiv(at, align) * align
            self.arrays[name] = (at, dtype, tuple(shape))
            at += math.prod(shape) * _ITEMSIZE[dtype]
        self.end = at
        self._offsets = [off for off, _, _ in self.arrays.values()]

    def views(self, buf):
        """The arrays as views of ``buf`` (any contiguous tensor of at least
        ``end`` bytes)."""
        raw = buf.view(torch.uint8)
        out = {}
        for name, (off, dtype, shape) in self.arrays.items():
            n = math.prod(shape) * _ITEMSIZE[dtype]
            out[name] = raw[off:off + n].view(dtype).view(shape)
        return out

    def pointers(self, buf):
        base = buf.data_ptr()
        return (ctypes.c_void_p * len(self._offsets))(
            *[base + off for off in self._offsets])


@functools.lru_cache(maxsize=64)
def bf16_scratch_layout(B, T, d, ff, backward):
    """The scratch of K11 bf16 (``backward`` False) or K12 bf16 for x (B, T,
    d): BF16_ARRAYS, in the order the C entry points read their
    addresses."""
    N = B * T
    nl, nm = _cdiv(N, LN_ROWS), _cdiv(N, GEMM_BM)
    specs = BF16_ARRAYS if backward else BF16_ARRAYS[:BF16_FWD_ARRAYS]
    return ScratchLayout([(name, dt, shape(N, d, ff, B, nl, nm))
                          for name, dt, shape in specs], ALIGN)


# The f32 entry points' scratch arrays in csrc/encoder_train.cu's order
# (kFQkv ..): name and shape from (N = B*T rows, d, ff); K11 takes the
# first F32_FWD_ARRAYS, K12 all and then "part", the weight and bias
# gradients' partial sums (part_floats)
F32_ARRAYS = (
    ("qkv", lambda N, d, ff: (N, 3 * d)),
    ("att", lambda N, d, ff: (N, d)),
    ("pre", lambda N, d, ff: (N, d)),
    ("y1", lambda N, d, ff: (N, d)),
    ("xhat1", lambda N, d, ff: (N, d)),
    ("f1", lambda N, d, ff: (N, ff)),
    ("f1d", lambda N, d, ff: (N, ff)),
    ("pre2", lambda N, d, ff: (N, d)),
    ("xhat2", lambda N, d, ff: (N, d)),
    ("rs1", lambda N, d, ff: (N,)),
    ("rs2", lambda N, d, ff: (N,)),
    ("y", lambda N, d, ff: (N, d)),
    ("dr2", lambda N, d, ff: (N, d)),
    ("df2", lambda N, d, ff: (N, d)),
    ("dh1", lambda N, d, ff: (N, ff)),
    ("dy1", lambda N, d, ff: (N, d)),
    ("dr1", lambda N, d, ff: (N, d)),
    ("da", lambda N, d, ff: (N, d)),
    ("datt", lambda N, d, ff: (N, d)),
    ("dqkv", lambda N, d, ff: (N, 3 * d)),
)
F32_FWD_ARRAYS = 11
F32_ALIGN = 16               # csrc/train_mma.cuh copies 16 bytes at a time


@functools.lru_cache(maxsize=64)
def f32_scratch_layout(B, T, d, ff, part=None):
    """The scratch of the f32 K11 (``part`` None) or K12 (``part``: its
    part_floats) for x (B, T, d): F32_ARRAYS, in the order the C entry
    points read their addresses."""
    N = B * T
    specs = F32_ARRAYS if part is not None else F32_ARRAYS[:F32_FWD_ARRAYS]
    specs = [(name, torch.float32, shape(N, d, ff)) for name, shape in specs]
    if part is not None:
        specs.append(("part", torch.float32, (part,)))
    return ScratchLayout(specs, F32_ALIGN)


def alloc_scratch(layout, device):
    """The buffer a bf16 entry point runs in: ``layout.end`` bytes."""
    return torch.empty(layout.end, dtype=torch.uint8, device=device)


@functools.lru_cache(maxsize=64)
def _plan_arg(B, T, d, ff):
    """The plan's ints as the ctypes array the entry points take."""
    ints = plan_ints(encoder_bf16_plan(B, T, d, ff))
    return (ctypes.c_int * len(ints))(*ints)


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _launch_fwd(x, ws, seed, n_heads, p, train, bt):
    B, T, d, ff, bt = _check(x, ws, n_heads, bt)
    bf16 = x.dtype == torch.bfloat16
    name = "encoder_layer_fwd_bf16" if bf16 else "encoder_layer_fwd"
    so = K.lib("encoder_train", _SIG)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (B, T, d, ff, n_heads, bt, _int32(seed), *_drop_args(p, train),
            stream)
    if bf16:
        layout = bf16_scratch_layout(B, T, d, ff, backward=False)
        scratch = alloc_scratch(layout, x.device)
        err = so.encoder_layer_fwd_bf16_launch(
            x.data_ptr(), _ptrs(ws), y.data_ptr(), layout.pointers(scratch),
            _plan_arg(B, T, d, ff), *args)
    else:
        layout = f32_scratch_layout(B, T, d, ff)
        scratch = alloc_scratch(layout, x.device)
        err = so.encoder_layer_fwd_launch(x.data_ptr(), _ptrs(ws),
                                          y.data_ptr(),
                                          layout.pointers(scratch), *args)
    K.check(err, name)
    K.launch_counts[name] += 1
    return y


def _k12_layout(dtype, B, T, d, ff):
    if dtype == torch.bfloat16:
        return bf16_scratch_layout(B, T, d, ff, backward=True)
    return f32_scratch_layout(B, T, d, ff, part_floats(B * T, d, ff))


def k12_scratch(x, ws, n_heads):
    """(layout, buffer) of K12 in x's dtype for these inputs: the bf16
    variant's bf16_scratch_layout or the f32 one's f32_scratch_layout;
    ``_launch_bwd(..., scratch=buffer)`` runs in it, and
    ``layout.views(buffer)`` reads its activations and gradients after."""
    B, T, d = x.shape
    layout = _k12_layout(x.dtype, B, T, d, ws[4].shape[1])
    return layout, alloc_scratch(layout, x.device)


def _launch_bwd(x, ws, seed, dy, n_heads, p, train, bt, scratch=None):
    """K12 in x's dtype. ``scratch``: a buffer of ``k12_scratch`` to run in,
    so that a check can read the layer's activations and gradients there
    afterwards (None: a new one)."""
    B, T, d, ff, bt = _check(x, ws, n_heads, bt, extra=(dy,))
    K.check_input(dy, "dy", (B, T, d), x.dtype, x.device)
    bf16 = x.dtype == torch.bfloat16
    name = "encoder_layer_bwd_bf16" if bf16 else "encoder_layer_bwd"
    so = K.lib("encoder_train", _SIG)
    layout = _k12_layout(x.dtype, B, T, d, ff)
    if scratch is None:
        scratch = alloc_scratch(layout, x.device)
    K.check_input(scratch, "scratch", (layout.end,), torch.uint8, x.device)
    dx = torch.empty_like(x)
    grads = [torch.empty_like(w) for w in ws]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (B, T, d, ff, n_heads, bt, _int32(seed), *_drop_args(p, train),
            stream)
    if bf16:
        err = so.encoder_layer_bwd_bf16_launch(
            x.data_ptr(), dy.data_ptr(), _ptrs(ws), dx.data_ptr(),
            _ptrs(grads), layout.pointers(scratch), _plan_arg(B, T, d, ff),
            *args)
    else:
        err = so.encoder_layer_bwd_launch(
            x.data_ptr(), dy.data_ptr(), _ptrs(ws), dx.data_ptr(),
            _ptrs(grads), layout.pointers(scratch), *args)
    K.check(err, name)
    K.launch_counts[name] += 1
    return dx, tuple(grads)


def encoder_layer_fwd(x, ws, seed, n_heads, p, train, bt=8, impl="auto"):
    """The layer's forward by ``impl``: "kernel" launches K11 (CUDA tensors
    only), "plain" runs ``encoder_layer_train_plain``, "auto" K11 for a CUDA
    tensor and the plain version for a CPU one. K11 takes x and the matmul
    weights in float32 or bfloat16 (counted as ``encoder_layer_fwd`` and
    ``encoder_layer_fwd_bf16``)."""
    _check_dtypes(x, ws)
    if K.use_kernel(impl, x, "encoder_impl", "kernel"):
        return _launch_fwd(x, ws, seed, n_heads, p, train, bt)
    return encoder_layer_train_plain(x, ws, seed, n_heads, p, train, bt)


def encoder_layer_bwd(x, ws, seed, dy, n_heads, p, train, bt=8,
                      impl="auto"):
    """The layer's backward by ``impl`` (K12 or ``encoder_layer_bwd_plain``,
    chosen as ``encoder_layer_fwd`` chooses). K12 takes x, dy and the
    matmul weights in float32 or bfloat16 (counted as ``encoder_layer_bwd``
    and ``encoder_layer_bwd_bf16``)."""
    _check_dtypes(x, ws)
    if K.use_kernel(impl, x, "encoder_impl", "kernel"):
        return _launch_bwd(x, ws, seed, dy, n_heads, p, train, bt)
    return encoder_layer_bwd_plain(x, ws, seed, dy, n_heads, p, train, bt)


class _EncoderLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, n_heads, p, train, bt, impl, *ws):
        x = x.detach().contiguous()
        ws = tuple(w.detach().contiguous() for w in ws)
        ctx.save_for_backward(x, *ws)
        ctx.args = (seed, n_heads, p, train, bt, impl)
        return encoder_layer_fwd(x, ws, seed, n_heads, p, train, bt, impl)

    @staticmethod
    def backward(ctx, dy):
        x, *ws = ctx.saved_tensors
        seed, n_heads, p, train, bt, impl = ctx.args
        dx, dws = encoder_layer_bwd(x, tuple(ws), seed, dy.contiguous(),
                                    n_heads, p, train, bt, impl)
        return (dx, None, None, None, None, None, None, *dws)


def encoder_layer_train(x, ws, seed, n_heads: int, p: float, train: bool,
                        bt: int = 8, impl: str = "auto"):
    """One differentiable encoder layer (twin of tip_tpu's
    ``encoder_layer_train``): x (B, T, d), ws the 12-tuple of
    ``pack_layer_weights``, seed the int32 dropout seed of this layer call
    (ignored when ``train`` is False or p is 0). The seed gets no
    gradient. float32 or bfloat16 (float64 plain), as ``encoder_layer_fwd``;
    the gradients come back in the dtypes of x and the weights."""
    return _EncoderLayerTrain.apply(x, seed, n_heads, p, train, bt, impl,
                                    *ws)
