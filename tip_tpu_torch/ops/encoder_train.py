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

_FWD_ARGS = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
              ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p, ctypes.c_void_p,
              ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
              ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
             + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float,
                                     ctypes.c_int, ctypes.c_void_p])
_SIG = {
    "encoder_layer_scratch": [ctypes.c_int] * 4
                             + [ctypes.POINTER(ctypes.c_longlong)],
    "encoder_layer_fwd_launch": _FWD_ARGS,
    "encoder_layer_fwd_bf16_launch": _FWD_ARGS,
    "encoder_layer_bwd_launch": _BWD_ARGS,
    "encoder_layer_bwd_bf16_launch": _BWD_ARGS,
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


# the scratch of each entry point (encoder_layer_scratch's kind)
SCRATCH_FWD, SCRATCH_BWD, SCRATCH_FWD_BF16, SCRATCH_BWD_BF16 = 0, 1, 2, 3
_scratch_floats = {}          # (N, d, ff, kind) -> floats, asked once


def scratch_floats(N, d, ff, kind):
    """Floats of the scratch that the entry point of ``kind`` (SCRATCH_*)
    takes for N = B*T rows (asked of the library once)."""
    key = (N, d, ff, kind)
    if key not in _scratch_floats:
        n = ctypes.c_longlong()
        so = K.lib("encoder_train", _SIG)
        K.check(so.encoder_layer_scratch(N, d, ff, kind, ctypes.byref(n)),
                "encoder_layer_scratch")
        _scratch_floats[key] = n.value
    return _scratch_floats[key]


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _launch_fwd(x, ws, seed, n_heads, p, train, bt):
    B, T, d, ff, bt = _check(x, ws, n_heads, bt)
    bf16 = x.dtype == torch.bfloat16
    name = "encoder_layer_fwd_bf16" if bf16 else "encoder_layer_fwd"
    so = K.lib("encoder_train", _SIG)
    scratch = torch.empty(scratch_floats(
        B * T, d, ff, SCRATCH_FWD_BF16 if bf16 else SCRATCH_FWD),
        dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(so, f"{name}_launch")(
        x.data_ptr(), _ptrs(ws), y.data_ptr(), scratch.data_ptr(), B, T, d,
        ff, n_heads, bt, _int32(seed), *_drop_args(p, train), stream)
    K.check(err, name)
    K.launch_counts[name] += 1
    return y


def _launch_bwd(x, ws, seed, dy, n_heads, p, train, bt, scratch=None):
    """K12 in x's dtype. ``scratch``: a float32 tensor of
    ``scratch_floats`` floats to run in, so that a check can read the
    layer's activations and gradients there afterwards (None: a new
    one)."""
    B, T, d, ff, bt = _check(x, ws, n_heads, bt, extra=(dy,))
    K.check_input(dy, "dy", (B, T, d), x.dtype, x.device)
    bf16 = x.dtype == torch.bfloat16
    name = "encoder_layer_bwd_bf16" if bf16 else "encoder_layer_bwd"
    kind = SCRATCH_BWD_BF16 if bf16 else SCRATCH_BWD
    so = K.lib("encoder_train", _SIG)
    n = scratch_floats(B * T, d, ff, kind)
    if scratch is None:
        scratch = torch.empty(n, dtype=torch.float32, device=x.device)
    K.check_input(scratch, "scratch", (n,), torch.float32, x.device)
    dx = torch.empty_like(x)
    grads = [torch.empty_like(w) for w in ws]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(so, f"{name}_launch")(
        x.data_ptr(), dy.data_ptr(), _ptrs(ws), dx.data_ptr(), _ptrs(grads),
        scratch.data_ptr(), B, T, d, ff, n_heads, bt, _int32(seed),
        *_drop_args(p, train), stream)
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
