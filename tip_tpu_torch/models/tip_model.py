"""The TIP state predictor: causal transformer encoder + uni-directional RNN
head (twin of tip_tpu/models/tip_model.py), as an ``nn.Module``.

Parameters keep tip_tpu's layout — weights stored (in, out), q/k/v apart —
so the state dict's keys follow the JAX param tree (``in_linear.w``,
``layers.0.w_q``, ``rnn.w_hh``, ``out.b``, ...) and ``params_from_jax``
is a rename.

Reproduced forward quirks (they affect checkpoint compatibility):
  * NaN past-state inputs are zeroed;
  * root-velocity channels 108:111 of the history are zeroed;
  * a fixed feature interleave between in_linear and the encoder (reshape
    (heads, hd) and swap: ``head_interleave_perm``);
  * post-norm transformer layers with ReLU feed-forward;
  * the RNN hidden state is re-zeroed on every call;
  * inference is deterministic (no dropout); its encoder layers run
    through K11 as tip_tpu's run its Pallas layer (``encoder_impl``, no
    custom mask), or through the per-op layer loop of this module under
    ``encoder_impl="xla"`` or "plain". ``train=True`` runs the training
    forward: dropout on the IMU input and the past-state history, the
    encoder layers and the differentiable RNN of ``ops/fused_rnn.py``
    (K1/K10). Its layers are the differentiable layers of
    ``ops/encoder_train.py`` (K11/K12), as tip_tpu's
    ``encoder_impl="pallas"``, or, under ``encoder_impl="xla"``, the per-op
    layer loop with four dropout sites a layer, as tip_tpu's "xla". Its
    masks are tip_tpu's ``dropout_impl="hash"`` (counter-based, from int32
    seeds) or ``dropout_impl="rng"`` (Bernoulli draws from a
    ``torch.Generator`` on the device; the stream differs from
    ``jax.random``'s, the distribution is the same).

The layers are written out from matmuls, softmax and LayerNorm: torch's
``nn.TransformerEncoderLayer``/``nn.MultiheadAttention`` switch to fused
library kernels in eval mode.
"""

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from tip_tpu_torch import resolve_device
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops.encoder_train import (encoder_layer_fwd,
                                             encoder_layer_train,
                                             pack_layer_weights)
from tip_tpu_torch.ops.fused_rnn import fused_rnn, fused_rnn_train
from tip_tpu_torch.ops.hashmask import hash_keep_mask

# dropout sites of the model's inputs (tip_tpu/models/tip_model.py)
SITE_IMU = 200
SITE_PAST = 201
# the xla loop's dropout sites: layer li's site k is SITE_LAYER0 + 4 li + k
SITE_LAYER0 = 210
# the batch tile of the encoder layers' dropout masks, as tip_tpu's model
# passes it
ENCODER_TILE = 8
# the xla loop's sites whose tensor splits over a mesh's model axis, and
# the dim it splits: the attention probabilities' heads (B, h, T, T) and
# the ReLU's FF1 columns (B, T, ff)
MODEL_SPLIT_SITES = {0: 1, 2: 2}


@dataclass(frozen=True)
class ModelConfig:
    input_size_imu: int = 72          # 6*(9+3)
    size_s: int = 131                 # 18*6 + 3 + 5*4
    with_acc_sum: bool = True         # +18 input features
    tf_in_dim: int = 256
    tf_hid_size: int = 1024
    n_heads: int = 16
    tf_layers: int = 4
    rnn_hid_size: int = 512
    with_rnn: bool = True
    # "auto" (kernel K1 on a CUDA tensor, plain on a CPU tensor) |
    # "kernel" | "plain" (ops/fused_rnn.py)
    rnn_impl: str = "auto"
    # the encoder layers, as tip_tpu's encoder_impl: "auto" (K11, and with
    # grad on K12, for a CUDA tensor; their plain versions for a CPU
    # tensor; tip_tpu's "pallas") | "kernel" | "plain" (the inference
    # forward takes the layer loop of this module, the training forward
    # ops/encoder_train.py's plain versions of K11/K12) | "xla" (the layer
    # loop of this module in every forward, training included, with its
    # dropout sites: tip_tpu's "xla", no kernel). The inference forward
    # takes the layer loop also with a custom mask, as tip_tpu does
    encoder_impl: str = "auto"
    # dropout of the training forward (train=True with seeds)
    in_dropout: float = 0.0
    past_dropout: float = 0.8
    layer_dropout: float = 0.1        # torch TransformerEncoderLayer default
    # "hash": counter-based masks (ops/hashmask.py) from int32 seeds,
    # tip_tpu's dropout_impl="hash" bit for bit | "rng": Bernoulli masks
    # drawn from a torch.Generator on the device, tip_tpu's "rng" (its
    # jax.random stream, threefry or rbg, is not reproduced: the
    # distribution is the same)
    dropout_impl: str = "hash"
    # "plain" (this module's forward) | "fused" (the whole-model kernel K4,
    # ops/fused_forward.py — inference only, taken by the streaming runner
    # for its one output row; bf16 weights by default). "fused" launches
    # the kernel for CUDA tensors and runs its plain version on the CPU
    forward_impl: str = "plain"
    # "float32" or "bfloat16". The plain forward and the plain cached step
    # cast the parameters and their input to it and compute there; the
    # fused paths pack their weights in it, and the KV-cache rings are
    # stored in it. None: the parameters' own dtype for the plain paths and
    # the rings, bfloat16 for the packing of the windowed fused forward
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        if self.forward_impl not in ("plain", "fused"):
            raise ValueError(f"forward_impl must be plain|fused, got "
                             f"{self.forward_impl!r}")
        if self.compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32|bfloat16, got "
                             f"{self.compute_dtype!r}")
        K.check_impl(self.rnn_impl, "rnn_impl", "kernel")
        if self.encoder_impl not in ("auto", "kernel", "plain", "xla"):
            raise ValueError(f"encoder_impl must be auto|kernel|plain|xla, "
                             f"got {self.encoder_impl!r}")
        if self.dropout_impl not in ("hash", "rng"):
            raise ValueError(f"dropout_impl must be hash|rng, got "
                             f"{self.dropout_impl!r}")

    @property
    def input_dim(self) -> int:
        extra = 18 if self.with_acc_sum else 0
        return self.input_size_imu + self.size_s + extra

    @property
    def head_dim(self) -> int:
        return self.tf_in_dim // self.n_heads


def head_interleave_perm(cfg: ModelConfig) -> np.ndarray:
    """Static permutation equal to reshape(heads, hd).T flattening."""
    d, h = cfg.tf_in_dim, cfg.n_heads
    return np.arange(d).reshape(h, d // h).T.reshape(-1)


def causal_mask(T, dtype=torch.float32, device=None):
    """Additive upper-triangular -inf mask."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(j > i, torch.full((), -math.inf, dtype=dtype,
                                         device=device), zero)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A state dict drawn with torch-equivalent distributions (Linear:
    kaiming-uniform == U(±1/√fan_in); MHA in_proj: xavier-uniform; LN:
    ones/zeros), on the CPU from ``generator``."""
    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return ((2.0 * u - 1.0) * bound).to(dtype)

    sd = {}

    def linear(name, in_d, out_d):
        b = 1.0 / math.sqrt(in_d)
        sd[f"{name}.w"] = uniform((in_d, out_d), b)
        sd[f"{name}.b"] = uniform((out_d,), b)

    d = cfg.tf_in_dim
    linear("in_linear", cfg.input_dim, d)
    xb = math.sqrt(6.0 / (2 * d))
    for i in range(cfg.tf_layers):
        p = f"layers.{i}"
        for n in ("q", "k", "v"):
            sd[f"{p}.w_{n}"] = uniform((d, d), xb)
        for n in ("q", "k", "v"):
            sd[f"{p}.b_{n}"] = torch.zeros(d, dtype=dtype)
        linear(f"{p}.out_proj", d, d)
        linear(f"{p}.ff1", d, cfg.tf_hid_size)
        linear(f"{p}.ff2", cfg.tf_hid_size, d)
        for n in ("ln1", "ln2"):
            sd[f"{p}.{n}_s"] = torch.ones(d, dtype=dtype)
            sd[f"{p}.{n}_b"] = torch.zeros(d, dtype=dtype)
    linear("out", cfg.rnn_hid_size if cfg.with_rnn else d, cfg.size_s)
    if cfg.with_rnn:
        rb = 1.0 / math.sqrt(cfg.rnn_hid_size)
        H = cfg.rnn_hid_size
        sd["rnn.w_ih"] = uniform((d, H), rb)
        sd["rnn.w_hh"] = uniform((H, H), rb)
        sd["rnn.b_ih"] = uniform((H,), rb)
        sd["rnn.b_hh"] = uniform((H,), rb)
    return sd


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """tip_tpu's param pytree (nested dicts/lists of numpy arrays) -> this
    module's state dict. Both store weights (in, out), so it is a rename."""
    sd = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        else:
            sd[prefix] = torch.as_tensor(np.array(node))

    walk("", tree)
    return sd


def params_from_torch_state_dict(sd, cfg: ModelConfig,
                                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A reference ``TF_RNN_Past_State.state_dict()`` -> this module's state
    dict. torch Linear stores (out, in), transposed here; MHA packs q/k/v
    row-wise into in_proj_weight (3d, d). Keys saved from a
    ``torch.nn.DataParallel``-wrapped model (all prefixed ``module.``) are
    accepted."""
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}

    def t(name):
        return torch.as_tensor(np.asarray(
            sd[name].detach().cpu().numpy() if hasattr(sd[name], "detach")
            else sd[name])).to(dtype)

    out = {"in_linear.w": t("in_linear.weight").T,
           "in_linear.b": t("in_linear.bias"),
           "out.w": t("linear.weight").T, "out.b": t("linear.bias")}
    d = cfg.tf_in_dim
    for i in range(cfg.tf_layers):
        p = f"tf_encode.layers.{i}."
        q = f"layers.{i}."
        w_in = t(p + "self_attn.in_proj_weight")     # (3d, d) rows [q;k;v]
        b_in = t(p + "self_attn.in_proj_bias")
        for j, n in enumerate(("q", "k", "v")):
            out[q + f"w_{n}"] = w_in[j * d:(j + 1) * d].T
            out[q + f"b_{n}"] = b_in[j * d:(j + 1) * d]
        out[q + "out_proj.w"] = t(p + "self_attn.out_proj.weight").T
        out[q + "out_proj.b"] = t(p + "self_attn.out_proj.bias")
        out[q + "ff1.w"] = t(p + "linear1.weight").T
        out[q + "ff1.b"] = t(p + "linear1.bias")
        out[q + "ff2.w"] = t(p + "linear2.weight").T
        out[q + "ff2.b"] = t(p + "linear2.bias")
        out[q + "ln1_s"] = t(p + "norm1.weight")
        out[q + "ln1_b"] = t(p + "norm1.bias")
        out[q + "ln2_s"] = t(p + "norm2.weight")
        out[q + "ln2_b"] = t(p + "norm2.bias")
    if cfg.with_rnn:
        out["rnn.w_ih"] = t("rnn.weight_ih_l0").T
        out["rnn.w_hh"] = t("rnn.weight_hh_l0").T
        out["rnn.b_ih"] = t("rnn.bias_ih_l0")
        out["rnn.b_hh"] = t("rnn.bias_hh_l0")
    return {k: v.contiguous() for k, v in out.items()}


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------

def _param(*shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class _Linear(nn.Module):
    def __init__(self, in_d, out_d, device, dtype):
        super().__init__()
        self.w = _param(in_d, out_d, device=device, dtype=dtype)
        self.b = _param(out_d, device=device, dtype=dtype)


def _layer_norm(x, scale, bias, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def hash_dropout(x, rate: float, seed, site: int, at=None):
    """tip_tpu's hash-mask dropout: x times the keep mask of (seed, site)
    in {0, 1/keep}, keep = 1 - rate; x itself when rate is 0. ``at``:
    (offsets, full shape) when x is one rank's part of a larger tensor
    under a mesh, whose mask it then takes (``hash_keep_mask``)."""
    if rate == 0.0:
        return x
    offsets, full = (None, None) if at is None else at
    return x * hash_keep_mask(seed, site, x.shape, 1.0 - rate,
                              torch.float32, x.device, offsets,
                              full).to(x.dtype)


def rng_dropout(x, rate: float, generator: torch.Generator, at=None):
    """tip_tpu's ``_dropout``: each entry kept with probability keep = 1 -
    rate (a float32 uniform draw from ``generator`` below keep) and divided
    by keep, the others 0; x itself when rate is 0. ``at``: (offsets, full
    shape) when x is one rank's part of a larger tensor under a mesh: the
    draw is the whole tensor's, and x takes its part."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape if at is None else at[1]
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=x.device)
    if at is not None:
        u = u[tuple(slice(o, o + n) for o, n in zip(at[0], x.shape))]
    return torch.where(u < keep, x / keep, x.new_zeros(()))


def _encoder_layer(p, pre: str, x, mask, n_heads: int, drop=None, tp=None):
    """One post-norm layer over the parameters ``p[pre + name]``:
    x = LN1(x + MHA(x)); x = LN2(x + FF(x)). ``drop(t, k)``: the dropout
    of site k of the layer (0 the attention probabilities, 1 the attention
    output, 2 the ReLU, 3 FF2's output), as tip_tpu's xla loop places it;
    None: no dropout.

    ``tp`` (``parallel.mesh.TensorParallel``): this rank's part of a
    tensor-parallel layer, whose q/k/v and FF1 parameters are its columns
    (whole heads) and whose out-projection and FF2 weights are its rows.
    The column-parallel products take x through ``tp.enter``, and the
    row-parallel products' partial sums meet in ``tp.reduce`` before their
    biases. None: the whole layer."""
    B, T, d = x.shape
    hd = d // n_heads
    xin = x if tp is None else tp.enter(x)
    q = xin @ p[pre + "w_q"] + p[pre + "b_q"]
    h = q.shape[-1] // hd                                 # this rank's heads

    def split_heads(t):
        return t.reshape(B, T, h, hd).transpose(1, 2)   # (B,h,T,hd)

    q = split_heads(q)
    k = split_heads(xin @ p[pre + "w_k"] + p[pre + "b_k"])
    v = split_heads(xin @ p[pre + "w_v"] + p[pre + "b_v"])
    if drop is None:
        def drop(t, k):
            return t
    logits = q @ k.transpose(-1, -2) / math.sqrt(hd) + mask
    o = drop(torch.softmax(logits, dim=-1), 0) @ v
    a = o.transpose(1, 2).reshape(B, T, h * hd) @ p[pre + "out_proj.w"]
    if tp is not None:
        a = tp.reduce(a)
    a = a + p[pre + "out_proj.b"]
    x = _layer_norm(x + drop(a, 1), p[pre + "ln1_s"], p[pre + "ln1_b"])
    xin = x if tp is None else tp.enter(x)
    f = drop(torch.relu(xin @ p[pre + "ff1.w"] + p[pre + "ff1.b"]), 2)
    f = f @ p[pre + "ff2.w"]
    if tp is not None:
        f = tp.reduce(f)
    f = f + p[pre + "ff2.b"]
    return _layer_norm(x + drop(f, 3), p[pre + "ln2_s"], p[pre + "ln2_b"])


class _EncoderLayer(nn.Module):
    """The parameters of one encoder layer (``_encoder_layer``)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d = cfg.tf_in_dim
        for n in ("q", "k", "v"):
            setattr(self, f"w_{n}", _param(d, d, device=device, dtype=dtype))
        for n in ("q", "k", "v"):
            setattr(self, f"b_{n}", _param(d, device=device, dtype=dtype))
        self.out_proj = _Linear(d, d, device, dtype)
        self.ff1 = _Linear(d, cfg.tf_hid_size, device, dtype)
        self.ff2 = _Linear(cfg.tf_hid_size, d, device, dtype)
        for n in ("ln1_s", "ln1_b", "ln2_s", "ln2_b"):
            setattr(self, n, _param(d, device=device, dtype=dtype))


class _RNN(nn.Module):
    def __init__(self, d, H, device, dtype):
        super().__init__()
        self.w_ih = _param(d, H, device=device, dtype=dtype)
        self.w_hh = _param(H, H, device=device, dtype=dtype)
        self.b_ih = _param(H, device=device, dtype=dtype)
        self.b_hh = _param(H, device=device, dtype=dtype)


class TIPModel(nn.Module):
    """The predictor. Built on ``cuda`` unless ``device`` says otherwise;
    weights from ``init_params(cfg, generator)`` (a generator seeded 0 when
    none is given), replaceable with ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        # what is derived from the parameters, made again when they change:
        # ("packed" | "cast", dtype) -> (parameter stamp, value)
        self._derived = {}
        d = cfg.tf_in_dim
        self.in_linear = _Linear(cfg.input_dim, d, device, dtype)
        self.layers = nn.ModuleList(
            [_EncoderLayer(cfg, device, dtype) for _ in range(cfg.tf_layers)])
        if cfg.with_rnn:
            self.rnn = _RNN(d, cfg.rnn_hid_size, device, dtype)
        self.out = _Linear(cfg.rnn_hid_size if cfg.with_rnn else d,
                           cfg.size_s, device, dtype)
        self.register_buffer("perm", torch.as_tensor(
            head_interleave_perm(cfg), device=device), persistent=False)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.load_state_dict(init_params(cfg, generator, dtype))

    def _derive(self, key, make):
        """``make()`` once per key, and again after the parameters change
        (``load_state_dict``, ``.to``, an in-place write that the
        parameter's version counter sees; a write through ``.data`` is not
        seen)."""
        stamp = tuple((p.data_ptr(), p._version) for p in self.parameters())
        hit = self._derived.get(key)
        if hit is None or hit[0] != stamp:
            hit = (stamp, make())
            self._derived[key] = hit
        return hit[1]

    def packed_weights(self, dtype=torch.bfloat16):
        """The fused kernels' weight list (ops/fused_forward.pack_weights)
        packed from this module's parameters, made once per dtype and made
        again after the parameters change (``_derive``)."""
        from tip_tpu_torch.ops import fused_forward as FF
        return self._derive(("packed", dtype), lambda: FF.pack_weights(
            self.state_dict(), self.cfg, dtype))

    def params_as(self, dtype=None):
        """The parameters by state-dict name, cast to ``dtype`` (None: to
        ``cfg.compute_dtype``, and as they are when that is None too). The
        cast copy is detached and made once per dtype (``_derive``): for
        the forwards that record no gradient (``_params``)."""
        if dtype is None and self.cfg.compute_dtype is not None:
            dtype = getattr(torch, self.cfg.compute_dtype)
        own = dict(self.named_parameters())
        if dtype is None or all(p.dtype == dtype for p in own.values()):
            return own
        return self._derive(("cast", dtype), lambda: {
            k: p.detach().to(dtype) for k, p in own.items()})

    def _params(self):
        """The parameters the forwards compute with, by state-dict name, in
        ``cfg.compute_dtype`` (their own dtype when it is None). With grad
        on and parameters that require it, each is cast anew on every call
        with a differentiable cast, so that the gradients reach the
        parameters (rounded to the compute dtype on the way, as JAX's
        ``astype`` transposes); else ``params_as``'s cached copy."""
        own = dict(self.named_parameters())
        if not (torch.is_grad_enabled()
                and any(p.requires_grad for p in own.values())):
            return self.params_as()
        cd = self.cfg.compute_dtype
        if cd is None:
            return own
        return {k: p.to(getattr(torch, cd)) for k, p in own.items()}

    def forward(self, x_imu, x_s, mask=None, train: bool = False,
                seeds=None):
        """Run the predictor (this module's forward, whatever
        ``cfg.forward_impl`` says: the fused kernels take one stream's
        window and packed weights, see ops/fused_forward.py). Its encoder
        layers go through K11 (``_encoder_layers``) unless
        ``cfg.encoder_impl`` is "plain" or a custom mask is given. With
        ``cfg.compute_dtype`` set, the parameters and both inputs are cast
        to it, the forward runs there (in bf16: K11's and K1's bf16
        variants, and with grad on K12's and K10's in the backward) and the
        result comes back in the inputs' dtype; else it runs in the
        parameters' dtype.

        Args:
          x_imu: (B, T, 72 or 90) IMU features (acc-sum appended if enabled).
          x_s:   (B, T, size_s) past-state history.
          mask:  optional additive attention mask (T, T); defaults to causal.
          train: run the training forward (``train_forward``) instead.
          seeds: with ``train``, what draws the dropout masks
                 (``train_forward``).
        Returns:
          (B, T, size_s) next-state predictions at every window position.
        """
        if train:
            if mask is not None:
                raise ValueError("the training forward takes the causal "
                                 "mask only")
            return self.train_forward(x_imu, x_s, seeds)
        B, T, _ = x_imu.shape
        out_dtype = x_imu.dtype
        p = self._params()
        if self.cfg.compute_dtype is not None:
            cd = getattr(torch, self.cfg.compute_dtype)
            x_imu, x_s = x_imu.to(cd), x_s.to(cd)
        x_s = torch.nan_to_num(x_s, nan=0.0)
        x_s = torch.cat([x_s[..., :108], torch.zeros_like(x_s[..., 108:111]),
                         x_s[..., 111:]], dim=-1)
        x = torch.cat([x_imu, x_s], dim=-1) @ p["in_linear.w"] \
            + p["in_linear.b"]
        x = x[..., self.perm]
        if mask is None and self.cfg.encoder_impl not in ("plain", "xla"):
            x = self._encoder_layers(x, p)
        else:
            if mask is None:
                mask = causal_mask(T, x.dtype, x.device)
            for li in range(self.cfg.tf_layers):
                x = _encoder_layer(p, f"layers.{li}.", x, mask,
                                   self.cfg.n_heads)
        if self.cfg.with_rnn:
            # input matmul hoisted; both biases folded into the pre-activation
            xin = x @ p["rnn.w_ih"] + p["rnn.b_ih"] + p["rnn.b_hh"]
            # with grad on and weights that require it, the differentiable
            # head (K1 forward, K10 backward), as tip_tpu's forward always
            # takes fused_rnn_train; else K1 alone, whose wrapper takes
            # detached tensors (no gradient is lost: none is recorded)
            w_hh = p["rnn.w_hh"]
            if torch.is_grad_enabled() and (xin.requires_grad
                                            or w_hh.requires_grad):
                x = fused_rnn_train(xin.contiguous(), w_hh,
                                    impl=self.cfg.rnn_impl)
            else:
                x = fused_rnn(xin.contiguous(), w_hh.detach(),
                              impl=self.cfg.rnn_impl)
        return (x @ p["out.w"] + p["out.b"]).to(out_dtype)

    def _encoder_layers(self, x, p):
        """The encoder as tip_tpu's inference forward runs it with
        ``encoder_impl="pallas"``: each layer through K11
        (``ops/encoder_train.py``) with dropout off and seed 0, batch tiles
        of 8, in x's dtype (bf16 under ``compute_dtype="bfloat16"``, with
        f32 LayerNorm vectors). With grad on and weights (or x) that
        require it, the differentiable layer (K11 forward, K12 backward, in
        x's dtype), as tip_tpu's ``custom_vjp``; else K11 on detached
        weights packed once per dtype."""
        cfg = self.cfg
        grad = torch.is_grad_enabled() and (
            x.requires_grad or any(w.requires_grad for w in p.values()))
        if grad:
            packs = [pack_layer_weights(p, f"layers.{li}.", x.dtype)
                     for li in range(cfg.tf_layers)]
        else:
            packs = self._derive(("layers", x.dtype), lambda: [
                tuple(w.detach().contiguous() for w in pack_layer_weights(
                    p, f"layers.{li}.", x.dtype))
                for li in range(cfg.tf_layers)])
        for ws in packs:
            if grad:
                x = encoder_layer_train(x.contiguous(), ws, 0, cfg.n_heads,
                                        cfg.layer_dropout, False,
                                        ENCODER_TILE, impl=cfg.encoder_impl)
            else:
                x = encoder_layer_fwd(x.detach().contiguous(), ws, 0,
                                      cfg.n_heads, cfg.layer_dropout, False,
                                      ENCODER_TILE, impl=cfg.encoder_impl)
        return x

    def train_forward(self, x_imu, x_s, seeds=None, mesh=None):
        """The differentiable training forward, tip_tpu's ``forward(...,
        train=True, rng)``, in ``cfg.compute_dtype`` (the parameters' dtype
        when it is None). Its encoder layers are those of
        ``ops/encoder_train.py`` (K11/K12 or their plain versions, tip_tpu's
        ``encoder_impl="pallas"``), or the per-op layer loop under
        ``encoder_impl="xla"``; its RNN is ``fused_rnn_train`` (K1/K10 or
        the plain version, by ``rnn_impl``). In bf16 the parameters stay
        float32: each is cast to bf16 on every call with a differentiable
        cast (``_params``; the LayerNorm vectors too, which
        ``pack_layer_weights`` widens back to f32, as tip_tpu casts its
        whole tree), both inputs are cast to bf16, and the output comes
        back in the inputs' dtype.

        seeds: what draws the dropout masks; None: dropout off, as tip_tpu
        without an rng.
          * ``dropout_impl="hash"``: (seed0, layer_seeds), int32 values.
            seed0 seeds the IMU (site 200) and past-state (site 201) masks
            and, in the xla loop, layer li's four sites 210-213 + 4 li;
            ``layer_seeds[li]`` the masks of K11/K12's layer li. tip_tpu
            draws them from its rng as ``bits(rng)`` and ``bits(split(rng,
            2 + 4L)[2 + 4 li])``.
          * ``dropout_impl="rng"``: a ``torch.Generator`` on the inputs'
            device. It draws the IMU and past-state masks, then, in the
            xla loop, each layer's four masks in the order of the layer;
            with K11/K12 layers, the layers' int32 seeds (read back to the
            host: one sync a call), as tip_tpu draws them from the layer
            keys.

        mesh: a ``torch.distributed`` DeviceMesh (``parallel/mesh.py``) of
        which this process is one rank. x_imu and x_s are then its rows of
        the global batch, every mask is the global batch's at those rows
        (and at its heads and FF1 columns), and with a model axis the
        encoder layers are tensor-parallel over parameters that
        ``train.shard_state`` split. Under a mesh the encoder takes the xla
        loop (``encoder_impl="xla"``, as ``train.shard_state`` sets it):
        K11/K12's per-layer masks are not the loop's, and tensor
        parallelism splits the layer that K11 fuses.
        """
        cfg = self.cfg
        out_dtype = x_imu.dtype
        p = self._params()
        coords = tp = None
        if mesh is not None:
            from tip_tpu_torch.parallel import mesh as mesh_lib
            if cfg.encoder_impl != "xla":
                raise ValueError("under a mesh the encoder trains in the xla "
                                 "loop (train.shard_state sets "
                                 "encoder_impl='xla')")
            coords = mesh_lib.coords(mesh)
            tp = mesh_lib.tensor_parallel(mesh)
            cols = cfg.tf_in_dim // coords.n_model
            if cfg.tf_layers and p["layers.0.w_q"].shape[1] != cols:
                raise ValueError(f"the model's q columns are "
                                 f"{p['layers.0.w_q'].shape[1]}, a rank of "
                                 f"a {coords.n_model}-way model axis holds "
                                 f"{cols} (train.shard_state)")
        if cfg.compute_dtype is not None:
            cd = getattr(torch, cfg.compute_dtype)
            x_imu, x_s = x_imu.to(cd), x_s.to(cd)
        drop_in, drop_layer, layer_seeds = self._dropout(seeds, x_imu.device,
                                                         coords)
        x_s = torch.nan_to_num(x_s, nan=0.0)
        x_imu = drop_in(x_imu, cfg.in_dropout, SITE_IMU)
        x_s = torch.cat([x_s[..., :108], torch.zeros_like(x_s[..., 108:111]),
                         x_s[..., 111:]], dim=-1)
        x_s = drop_in(x_s, cfg.past_dropout, SITE_PAST)
        x = torch.cat([x_imu, x_s], dim=-1) @ p["in_linear.w"] \
            + p["in_linear.b"]
        x = x[..., self.perm]
        if cfg.encoder_impl == "xla":
            mask = causal_mask(x.shape[1], x.dtype, x.device)
            for li in range(cfg.tf_layers):
                x = _encoder_layer(p, f"layers.{li}.", x, mask, cfg.n_heads,
                                   drop_layer(li), tp)
        else:
            seeds_l = layer_seeds()
            for li in range(cfg.tf_layers):
                ws = pack_layer_weights(p, f"layers.{li}.", x.dtype)
                x = encoder_layer_train(
                    x.contiguous(), ws, seeds_l[li], cfg.n_heads,
                    cfg.layer_dropout, seeds is not None, ENCODER_TILE,
                    impl=cfg.encoder_impl)
        if cfg.with_rnn:
            xin = x @ p["rnn.w_ih"] + p["rnn.b_ih"] + p["rnn.b_hh"]
            x = fused_rnn_train(xin.contiguous(), p["rnn.w_hh"],
                                impl=cfg.rnn_impl)
        return (x @ p["out.w"] + p["out.b"]).to(out_dtype)

    def _dropout(self, seeds, device, coords=None):
        """What ``train_forward`` drops with: drop_in(x, rate, site) for the
        inputs, drop_layer(li) the xla loop's ``drop`` of layer li, and
        layer_seeds() the K11/K12 layers' int32 seeds (drawn when called).
        ``coords`` (``parallel.mesh.Coords``): the masks are taken at this
        rank's place in the global tensors; None: the tensors are whole."""
        cfg = self.cfg
        L = cfg.tf_layers

        def placed(drop, t, *args, model_dim=None):
            """drop(t, *args), with ``at=`` this rank's place in the
            global tensor under a mesh: its rows, and its part of dim
            ``model_dim`` on the model axis."""
            if coords is None:
                return drop(t, *args)
            offsets, full = [0] * t.dim(), list(t.shape)
            offsets[0], full[0] = coords.data * t.shape[0], \
                t.shape[0] * coords.n_data
            if model_dim is not None:
                offsets[model_dim] = coords.model * t.shape[model_dim]
                full[model_dim] *= coords.n_model
            return drop(t, *args, at=(offsets, full))

        if seeds is None:
            return ((lambda x, rate, site: x), (lambda li: None),
                    (lambda: [0] * L))
        if cfg.dropout_impl == "rng":
            gen = seeds
            if not isinstance(gen, torch.Generator):
                raise TypeError("dropout_impl='rng' draws its masks from a "
                                "torch.Generator, not from seeds")
            if gen.device.type != device.type:
                raise ValueError(f"the dropout generator is on "
                                 f"{gen.device}, the inputs on {device}")
            return ((lambda x, rate, site: placed(rng_dropout, x, rate,
                                                  gen)),
                    (lambda li: lambda t, k: placed(
                        rng_dropout, t, cfg.layer_dropout, gen,
                        model_dim=MODEL_SPLIT_SITES.get(k))),
                    (lambda: torch.randint(
                        -2 ** 31, 2 ** 31, (L,), generator=gen,
                        device=gen.device).tolist()))
        if isinstance(seeds, torch.Generator):
            raise TypeError("dropout_impl='hash' takes (seed0, layer_seeds), "
                            "not a generator")
        seed0, layer_seeds = seeds
        if len(layer_seeds) != L:
            raise ValueError(f"{len(layer_seeds)} layer seeds for {L} "
                             f"layers")
        return ((lambda x, rate, site: placed(hash_dropout, x, rate, seed0,
                                              site)),
                (lambda li: lambda t, k: placed(
                    hash_dropout, t, cfg.layer_dropout, seed0,
                    SITE_LAYER0 + 4 * li + k,
                    model_dim=MODEL_SPLIT_SITES.get(k))),
                (lambda: list(layer_seeds)))
