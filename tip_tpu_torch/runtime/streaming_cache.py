"""KV-cached streaming forward: the opt-in per-frame fast path (twin of
tip_tpu/runtime/streaming_cache.py), for one stream and for a pool of B
streams that tick together.

The windowed runner recomputes the transformer over all <= 40 window
positions every frame. History tokens' inputs never change once pushed, so
each layer's K/V projections of past tokens are cacheable: per frame only
the NEWEST token runs through the encoder, attending to cached K/V rings.

Semantics: while the window is still growing (the first 40 model frames)
this is EXACTLY the windowed forward — past tokens' context never changes,
so their cached representations equal a full recompute. Once the window
slides, a past token's recomputed representation would see a shifted
window; the cache freezes it with its original context: a documented
divergence, not an error.

Two RNN-head policies (``RunnerConfig.serving_mode``):
  * "kv_cache": replay the tanh RNN from zero over the cached encoder
    outputs each frame — the windowed path's head math;
  * "kv_cache_rnn_carry": carry the hidden state across frames and run ONE
    RNN step per frame — a further approximation (the windowed forward
    re-zeros the hidden per call) that removes the 40-step chain.

Three forms of the step:
  ``cached_forward_step``: plain tensor ops over the model's parameters;
  ``fused_cached_forward_step`` / ``fused_cached_step_slot``: the whole step
    as kernel K7 (``csrc/fused_cached.cu``, one cooperative launch) over
    packed weights, for CUDA tensors;
  ``fused_cached_forward_step_plain``: K7's arithmetic cast by cast in
    plain PyTorch, what the wrappers run for CPU tensors.

The same three for a pool, over a ``KVCache`` whose leaves carry a leading
stream axis B, one GLOBAL ring cursor shared by every stream and a (B,)
``commit`` flag tensor (a stream that is still warming up does not count):
  ``cached_forward_step_batch``: what tip_tpu's ``vmap`` of the plain step
    computes;
  ``fused_cached_batch``: kernel K8 (``csrc/fused_cached_batch.cu``, one
    cooperative launch for the whole pool);
  ``fused_cached_batch_plain``: K8's arithmetic cast by cast.
tip_tpu reaches its batched kernel through a ``custom_vmap`` rule; here the
pool's frame step (runtime/runner.py::pool_step) calls ``fused_cached_batch``
directly. tip_tpu's ``b_tile`` (a VMEM tile size) has no counterpart: K8
takes any B.

**The rings are updated in place.** Every step writes its row into the
``KVCache`` it was given and returns that same object (tip_tpu returns a
new pytree). A caller that wants the state before a step clones it first
(``KVCache.clone``).

Inference only: no dropout, no gradient.
"""

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from tip_tpu_torch import device_const, resolve_device
from tip_tpu_torch.models import tip_model as M
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import fused_forward as FF

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"fused_cached_launch": [_P, _P] + [_I] * 14 + [_P] * 6
        + [_I, _P, _P, _I, _P],
        "fused_cached_scratch_floats": [_I] * 4,
        "fused_cached_smem_bytes": [_I] * 10}
_SIG_BATCH = {
    "fused_cached_batch_launch": [_P, _P] + [_I] * 14 + [_P] * 7
    + [ctypes.c_longlong, _P, _P, _I, _P],
    "fused_cached_batch_scratch_floats": [_I] * 6,
    "fused_cached_batch_smem_bytes": [_I] * 7}


_LEAVES = ("k", "v", "enc", "h", "valid")


@dataclass
class KVCache:
    """One stream's cache, or a pool's: every leaf then carries a leading
    stream axis B."""
    k: torch.Tensor       # (L, W, d) per-layer key rings
    v: torch.Tensor       # (L, W, d) per-layer value rings
    enc: torch.Tensor     # (W, d) encoder-output ring (RNN replay input)
    h: torch.Tensor       # (H,) carried RNN hidden (rnn_carry mode only)
    valid: torch.Tensor   # (W,) bool — the slot holds a live token

    def clone(self) -> "KVCache":
        return KVCache(*(getattr(self, f).clone() for f in _LEAVES))

    def streams(self, lo: int, hi: int) -> "KVCache":
        """Streams lo..hi-1 of a pool's cache, as views: a step on them
        updates this cache."""
        return KVCache(*(getattr(self, f)[lo:hi] for f in _LEAVES))


def cache_init(cfg: M.ModelConfig, window: int, dtype=torch.float32,
               device=None, batch=None) -> KVCache:
    """An empty cache on ``device`` (``cuda`` unless the caller asks for
    another), of one stream or, with ``batch=B``, of a pool of B. The rings
    are stored in the model's compute dtype when it is set (bf16 rings halve
    what a step reads), else in ``dtype``."""
    device = resolve_device(device)
    if cfg.compute_dtype is not None:
        dtype = getattr(torch, cfg.compute_dtype)
    L, d, H = cfg.tf_layers, cfg.tf_in_dim, cfg.rnn_hid_size
    lead = () if batch is None else (int(batch),)

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return KVCache(k=zeros(L, window, d), v=zeros(L, window, d),
                   enc=zeros(window, d), h=zeros(H),
                   valid=zeros(window, dt=torch.bool))


def cache_from_jax(k, v, enc, h, valid, device="cpu") -> KVCache:
    """The five leaves of a tip_tpu ``KVCache`` (numpy arrays; one stream's,
    or a pool's with a leading stream axis) as a cache of this module.
    bfloat16 leaves arrive as float32 arrays: cast the result with ``.to``
    where the rings are bf16."""
    return KVCache(*(torch.as_tensor(np.array(a)).to(device)
                     for a in (k, v, enc, h, valid)))


# Ring discipline: circular slot-writes. The cache rings only need a
# validity mask — attention is permutation-invariant over its keys — so one
# slot-write per frame replaces an O(window) shift. Only the RNN replay
# needs chronological order, recovered by walking the ring from the cursor.


def _token_fix(x_token, cfg: M.ModelConfig):
    """The input quirks on one token (or a batch of tokens): NaN -> 0, the
    root-velocity history channels zeroed."""
    zc = FF._imu_dim(cfg) + 108
    x = torch.nan_to_num(x_token, nan=0.0)
    return torch.cat([x[..., :zc], torch.zeros_like(x[..., zc:zc + 3]),
                      x[..., zc + 3:]], dim=-1)


def _params(model_or_params, cfg: M.ModelConfig):
    """Parameters by state-dict name, in the compute dtype when it is set."""
    if isinstance(model_or_params, nn.Module):
        return model_or_params.params_as()
    if cfg.compute_dtype is None:
        return model_or_params
    cd = getattr(torch, cfg.compute_dtype)
    return {k: p.to(cd) for k, p in model_or_params.items()}


def _walk(slot: int, W: int):
    """Ring indices oldest to newest: from the slot after the cursor."""
    return [(slot + 1 + t) % W for t in range(W)]


def cached_forward_step(model_or_params, cache: KVCache, x_token, k_prev,
                        cfg: M.ModelConfig, *, rnn_carry: bool = False,
                        slot_override=None, commit=None):
    """One streaming token through the encoder with cached K/V, as plain
    tensor ops.

    Args:
      model_or_params: a ``TIPModel`` or its state dict.
      x_token: (input_dim,) the newest window token [imu ++ acc_sum ++
        history] — the channels ``forward`` sees at the last position.
      k_prev: host int — window entries before this frame (ring push index).
      slot_override: optional host int, a GLOBAL ring cursor (a pool's tick):
        every stream of a pool then writes the same slot. Per-slot validity
        then comes from the cache's ``valid`` ring, which marks exactly the
        stream's last <= W tokens; without it the ring fills from slot 0 and
        validity is ``arange(W) < min(k_prev + 1, W)``.
      commit: optional host bool — False (a frame that must not count) leaves
        every ring, ``h`` and ``valid`` as they were; the returned y_t is
        then unspecified (the runner never consumes it).
    Returns (cache, y_t (size_s,)): the SAME cache object, updated in place;
    y_t in the rings' dtype.
    """
    W = cache.enc.shape[0]
    d, nh, hd = cfg.tf_in_dim, cfg.n_heads, cfg.head_dim
    dtype = cache.enc.dtype
    dev = cache.enc.device
    p = _params(model_or_params, cfg)
    if cfg.compute_dtype is not None:
        x_token = x_token.to(getattr(torch, cfg.compute_dtype))
    k_prev = int(k_prev)
    commit = True if commit is None else bool(commit)

    x = _token_fix(x_token, cfg) @ p["in_linear.w"] + p["in_linear.b"]
    x = x[device_const(tuple(M.head_interleave_perm(cfg).tolist()),
                       torch.int64, dev)]

    # ``live``: the validity as host bools where the host knows it
    if slot_override is None:
        slot = k_prev % W
        live = tuple(i < min(k_prev + 1, W) for i in range(W))
        valid = device_const(live, torch.bool, dev)
    else:
        slot = int(slot_override) % W
        live = None
        valid = cache.valid.clone()
        valid[slot].fill_(True)
    if commit:
        cache.valid[slot].fill_(True)   # a fill: nothing crosses from the host

    for li in range(cfg.tf_layers):
        pre = f"layers.{li}."
        q = x @ p[pre + "w_q"] + p[pre + "b_q"]
        kt = x @ p[pre + "w_k"] + p[pre + "b_k"]
        vt = x @ p[pre + "w_v"] + p[pre + "b_v"]
        # an uncommitted step attends to the ring as it is: the old row
        # stays at the cursor
        if commit:
            cache.k[li, slot] = kt.to(dtype)
            cache.v[li, slot] = vt.to(dtype)
        k_ring = cache.k[li].to(kt.dtype)
        v_ring = cache.v[li].to(vt.dtype)
        if commit and kt.dtype != dtype:
            # the token's own row as computed, not as the ring rounds it
            k_ring = torch.cat([k_ring[:slot], kt[None], k_ring[slot + 1:]])
            v_ring = torch.cat([v_ring[:slot], vt[None], v_ring[slot + 1:]])

        qh = q.reshape(nh, hd)
        kh = k_ring.reshape(W, nh, hd)
        vh = v_ring.reshape(W, nh, hd)
        logits = torch.einsum("hd,whd->hw", qh, kh) / math.sqrt(hd)
        logits = torch.where(valid[None, :], logits,
                             torch.finfo(logits.dtype).min)
        w_att = torch.softmax(logits, dim=-1).to(vh.dtype)
        o = torch.einsum("hw,whd->hd", w_att, vh).reshape(d)
        a = o @ p[pre + "out_proj.w"] + p[pre + "out_proj.b"]
        x = M._layer_norm(x + a, p[pre + "ln1_s"], p[pre + "ln1_b"])
        f = torch.relu(x @ p[pre + "ff1.w"] + p[pre + "ff1.b"])
        f = f @ p[pre + "ff2.w"] + p[pre + "ff2.b"]
        x = M._layer_norm(x + f, p[pre + "ln2_s"], p[pre + "ln2_b"])

    # the encoder ring is kept in both RNN modes, so a stream can switch
    if commit:
        cache.enc[slot] = x.to(dtype)
    enc_ring = cache.enc.to(x.dtype)
    if commit and x.dtype != dtype:
        enc_ring = torch.cat([enc_ring[:slot], x[None], enc_ring[slot + 1:]])

    if rnn_carry:
        # one step from the carried hidden (an approximation: the windowed
        # forward re-zeros the hidden every call)
        pre_act = x @ p["rnn.w_ih"] + p["rnn.b_ih"] + p["rnn.b_hh"]
        h_t = torch.tanh(pre_act + cache.h.to(pre_act.dtype) @ p["rnn.w_hh"])
        if commit:
            cache.h.copy_(h_t)
    else:
        # replay from zero over the valid window in CHRONOLOGICAL order: the
        # ring is circular, so the walk starts at the slot after the cursor
        # and the hidden passes over invalid slots unchanged (holes before
        # the ring has filled): skipped where the host knows the validity,
        # selected on the device where it is the cache's ring (no read
        # back). ``cache.h`` is left alone
        xin = enc_ring @ p["rnn.w_ih"] + p["rnn.b_ih"] + p["rnn.b_hh"]
        h_t = torch.zeros(cfg.rnn_hid_size, dtype=xin.dtype, device=dev)
        for idx in _walk(slot, W):
            if live is not None and not live[idx]:
                continue
            h_next = torch.tanh(xin[idx] + h_t @ p["rnn.w_hh"])
            h_t = h_next if live is not None else \
                torch.where(valid[idx], h_next, h_t)

    y = h_t @ p["out.w"] + p["out.b"]
    return cache, y.to(dtype)


# ---------------------------------------------------------------------------
# the whole cached step as one op over packed weights: plain version
# ---------------------------------------------------------------------------

def _check_cache(cache: KVCache, packed_ws, cfg: M.ModelConfig, dev):
    """Raise unless the cache fits the model and the packing: every ring
    and ``h`` contiguous on ``dev`` in the packing dtype."""
    cd = packed_ws[0].dtype
    if cache.k.dtype != cd:
        raise TypeError(
            f"the cache rings are {cache.k.dtype} and the packed weights "
            f"{cd}: pack the weights in the rings' dtype "
            f"(runner.pack_fused_weights does)")
    W = cache.enc.shape[0]
    L, d, H = cfg.tf_layers, cfg.tf_in_dim, cfg.rnn_hid_size
    K.check_input(cache.k, "cache.k", (L, W, d), cd, dev)
    K.check_input(cache.v, "cache.v", (L, W, d), cd, dev)
    K.check_input(cache.enc, "cache.enc", (W, d), cd, dev)
    K.check_input(cache.h, "cache.h", (H,), cd, dev)
    K.check_input(cache.valid, "cache.valid", (W,), torch.bool, dev)
    return W


def fused_cached_forward_step_plain(packed_ws, cache: KVCache, x_token,
                                    slot: int, commit: bool,
                                    cfg: M.ModelConfig, *,
                                    rnn_carry: bool = False):
    """Plain version of K7 at ring cursor ``slot``: the kernel's arithmetic
    with its casts. Every product is taken between values rounded to the
    packing dtype and summed in float32 (the token included), the attention
    mask is an additive -1e30 over the ``valid`` ring (this token's slot
    included when committed), softmax and LayerNorm run in float32, the
    rings and ``h`` hold the packing dtype. Updates ``cache`` in place and
    returns (cache, y_t (size_s,) float32)."""
    if len(packed_ws) != FF.n_packed(cfg):
        raise ValueError(f"{len(packed_ws)} packed weights, expected "
                         f"{FF.n_packed(cfg)}")
    ws = packed_ws
    dev = x_token.device
    W = _check_cache(cache, ws, cfg, dev)
    d, nh, hd = cfg.tf_in_dim, cfg.n_heads, cfg.head_dim
    cd = ws[0].dtype
    f32 = torch.float32
    slot = int(slot) % W
    commit = bool(commit)

    def r(a):
        return FF._round(a, cd)

    def w(i):
        return ws[i].to(f32)

    if commit:
        cache.valid[slot].fill_(True)
    mask = torch.where(cache.valid,
                       torch.zeros((), dtype=f32, device=dev),
                       torch.full((), -1e30, dtype=f32, device=dev))
    scale = 1.0 / math.sqrt(hd)

    x = r(_token_fix(x_token.to(f32), cfg)) @ w(0) + w(1)
    for li in range(cfg.tf_layers):
        o = 2 + 12 * li
        qkv = r(x) @ w(o) + w(o + 1)
        if commit:        # before the ring is read: the token sees itself
            cache.k[li, slot] = qkv[d:2 * d].to(cd)
            cache.v[li, slot] = qkv[2 * d:].to(cd)
        q = r(qkv[:d]).reshape(nh, hd)
        kh = cache.k[li].to(f32).reshape(W, nh, hd)
        vh = cache.v[li].to(f32).reshape(W, nh, hd)
        logits = torch.einsum("hd,whd->hw", q, kh) * scale + mask[None, :]
        att = torch.einsum("hw,whd->hd", r(torch.softmax(logits, dim=-1)),
                           vh).reshape(d)
        a = r(att) @ w(o + 2) + w(o + 3)
        x = FF._ln(x + a, ws[o + 8], ws[o + 9])
        f = torch.relu(r(x) @ w(o + 4) + w(o + 5))
        f = r(f) @ w(o + 6) + w(o + 7)
        x = FF._ln(x + f, ws[o + 10], ws[o + 11])

    if commit:
        cache.enc[slot] = x.to(cd)
    o = 2 + 12 * cfg.tf_layers
    if rnn_carry:
        pre_act = r(x) @ w(o) + w(o + 1)
        h_t = torch.tanh(pre_act + cache.h.to(f32) @ w(o + 2))
        if commit:
            cache.h.copy_(h_t)
    else:
        # the kernel skips an invalid slot; here the hidden passes over it
        # by a select on the device, so nothing is read back
        xin = cache.enc.to(f32) @ w(o) + w(o + 1)
        w_hh = w(o + 2)
        h_t = torch.zeros(cfg.rnn_hid_size, dtype=f32, device=dev)
        for idx in _walk(slot, W):
            h_t = torch.where(cache.valid[idx],
                              torch.tanh(xin[idx] + r(h_t) @ w_hh), h_t)
    return cache, r(h_t) @ w(o + 3) + w(o + 4)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def _launch(packed_ws, cache: KVCache, x_token, slot: int, commit: bool,
            cfg: M.ModelConfig, rnn_carry: bool, clock=None):
    """One cooperative launch of csrc/fused_cached.cu; ``clock``: None, or
    a per-phase clock (``cached_step_phases``)."""
    name = "fused_cached_forward_step"
    dev = x_token.device
    cd = packed_ws[0].dtype
    d, ff, H = cfg.tf_in_dim, cfg.tf_hid_size, cfg.rnn_hid_size
    ptrs = FF.check_packed(packed_ws, cfg, dev, name)
    W = _check_cache(cache, packed_ws, cfg, dev)
    K.check_input(x_token, "x_token", (cfg.input_dim,), torch.float32, dev)
    so = K.lib("fused_cached", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape = (W, d, ff, H)
    scratch = FF.scratch_buffer(
        "fused_cached", lambda: so.fused_cached_scratch_floats(*shape), dev,
        stream, shape)
    y = torch.empty(cfg.size_s, dtype=torch.float32, device=dev)
    err = so.fused_cached_launch(
        x_token.data_ptr(), ptrs, len(packed_ws), int(cd == torch.bfloat16),
        W, cfg.input_dim, d, cfg.n_heads, ff, cfg.tf_layers, H, cfg.size_s,
        FF._imu_dim(cfg) + 108, slot, int(commit), int(rnn_carry),
        cache.k.data_ptr(), cache.v.data_ptr(), cache.enc.data_ptr(),
        cache.h.data_ptr(), cache.valid.data_ptr(), scratch.data_ptr(),
        scratch.numel(), y.data_ptr(),
        None if clock is None else clock.data_ptr(),
        0 if clock is None else clock.shape[0], stream)
    is_bf16 = int(cd == torch.bfloat16)
    FF.check_launch(err, name, cfg, f"W={W}, ", lambda: FF.smem_bytes(
        so, "fused_cached_smem_bytes", is_bf16, W, cfg.input_dim, d,
        cfg.n_heads, ff, cfg.tf_layers, H, cfg.size_s, int(rnn_carry)), dev)
    K.launch_counts[name] += 1
    return cache, y


def fused_cached_step_slot(packed_ws, cache: KVCache, x_token, slot,
                           commit, cfg: M.ModelConfig, *,
                           rnn_carry: bool = False, impl: str = "auto"):
    """The whole cached step as one op at an explicit ring cursor ``slot``
    (a host int, taken mod W): kernel K7 for a CUDA token, its plain version
    for a CPU token or ``impl="plain"``; ``impl="fused"`` on a CPU token
    raises.

    packed_ws: ``ops.fused_forward.pack_weights`` output, in the dtype of
    the cache rings (raises otherwise). x_token (input_dim,) float32; the
    input quirks are applied inside. commit: host bool — write the token
    into the rings (False leaves every ring, ``h`` and ``valid`` bit for
    bit as they were; y_t is then unspecified).
    Returns (cache, y_t (size_s,) float32): the SAME cache, updated in
    place.
    """
    slot = int(slot) % cache.enc.shape[0]
    if not K.use_kernel(impl, x_token, "forward_impl", "fused"):
        return fused_cached_forward_step_plain(
            packed_ws, cache, x_token, slot, commit, cfg, rnn_carry=rnn_carry)
    return _launch(packed_ws, cache, x_token, slot, bool(commit), cfg,
                   rnn_carry)


# the kinds of K7's phases, as csrc/fused_cached.cu numbers them
K7_PHASES = ("start", "in_proj", "qkv", "attn_out", "ff1", "ff2", "rnn_in",
             "rnn", "out_proj")


def cached_step_phases(packed_ws, cache: KVCache, x_token, slot, commit,
                       cfg: M.ModelConfig, *, rnn_carry: bool = False):
    """One launch of K7 (CUDA tensors) with its per-phase clock on, as
    ``fused_forward.recompute_batch_phases`` runs K9's: updates ``cache``
    in place as ``fused_cached_step_slot`` does and returns (y, {kind:
    ms}, phases), the kinds those of ``K7_PHASES``."""
    clock = FF.new_clock(x_token.device)
    _, y = _launch(packed_ws, cache, x_token, int(slot) % cache.enc.shape[0],
                   bool(commit), cfg, rnn_carry, clock)
    split, n = FF.phase_split(clock.cpu().tolist(), K7_PHASES)
    return y, split, n


def fused_cached_forward_step(packed_ws, cache: KVCache, x_token, k_prev,
                              commit, cfg: M.ModelConfig, *,
                              rnn_carry: bool = False, impl: str = "auto"):
    """Fused equivalent of ``cached_forward_step`` without a global cursor:
    the ring cursor is ``k_prev % W`` (``fused_cached_step_slot``)."""
    return fused_cached_step_slot(packed_ws, cache, x_token, int(k_prev),
                                  commit, cfg, rnn_carry=rnn_carry, impl=impl)


# ---------------------------------------------------------------------------
# a pool of B streams at one global cursor: the plain step
# ---------------------------------------------------------------------------

def _replace_row(ring, slot: int, row):
    """A copy of ring (B, W, n) with ``row`` (B, n) at ring slot ``slot``."""
    return torch.cat([ring[:, :slot], row[:, None], ring[:, slot + 1:]],
                     dim=1)


def cached_forward_step_batch(model_or_params, cache: KVCache, x_tokens,
                              slot, commit, cfg: M.ModelConfig, *,
                              rnn_carry: bool = False):
    """``cached_forward_step`` for B streams at one global ring cursor, as
    plain tensor ops: what tip_tpu's ``vmap`` of its step with a shared
    ``slot_override`` and a batched ``commit`` computes.

    Args:
      cache: a pool's ``KVCache`` (k, v: (B, L, W, d); enc: (B, W, d); h:
        (B, H); valid: (B, W)), updated in place.
      x_tokens: (B, input_dim) the newest token of every stream.
      slot: host int, the global cursor (a pool's tick), taken mod W.
      commit: (B,) bool tensor on the cache's device — a stream whose flag
        is False keeps its rings, ``h`` and ``valid`` as they were (its row
        of y is unspecified); nothing is read back to select.
    Returns (cache, y (B, size_s)) in the rings' dtype.

    An uncommitted stream keeps the validity bit under the cursor and goes
    on attending the old row there, as tip_tpu's plain step does.
    ``fused_cached_batch`` and its plain version clear that bit instead (the
    row is evicted), as tip_tpu's batched kernel does: after such a step the
    two caches differ in ``valid[:, slot]`` for that stream and in nothing
    else. A pool passes ``commit`` False only for a freshly joined slot,
    whose validity ring is all False, so there the two agree.
    """
    B, W = cache.enc.shape[:2]
    d, nh, hd = cfg.tf_in_dim, cfg.n_heads, cfg.head_dim
    dtype = cache.enc.dtype
    dev = cache.enc.device
    p = _params(model_or_params, cfg)
    if cfg.compute_dtype is not None:
        x_tokens = x_tokens.to(getattr(torch, cfg.compute_dtype))
    slot = int(slot) % W
    cm = commit[:, None]

    x = _token_fix(x_tokens, cfg) @ p["in_linear.w"] + p["in_linear.b"]
    x = x[:, device_const(tuple(M.head_interleave_perm(cfg).tolist()),
                          torch.int64, dev)]

    # every stream attends to its own validity ring plus the cursor slot
    # (its own token, or for an uncommitted stream the old row there)
    valid = cache.valid.clone()
    valid[:, slot] = True
    cache.valid[:, slot] = cache.valid[:, slot] | commit

    def push(ring, row):
        """Write ``row`` at the cursor for the committed streams; return the
        ring as the step reads it, in ``row``'s dtype, the cursor row as
        computed (not as the ring rounds it)."""
        row = torch.where(cm, row, ring[:, slot].to(row.dtype))
        ring[:, slot] = row.to(dtype)
        return _replace_row(ring.to(row.dtype), slot, row) \
            if row.dtype != dtype else ring

    for li in range(cfg.tf_layers):
        pre = f"layers.{li}."
        q = x @ p[pre + "w_q"] + p[pre + "b_q"]
        k_ring = push(cache.k[:, li], x @ p[pre + "w_k"] + p[pre + "b_k"])
        v_ring = push(cache.v[:, li], x @ p[pre + "w_v"] + p[pre + "b_v"])
        qh = q.reshape(B, nh, hd)
        kh = k_ring.reshape(B, W, nh, hd)
        vh = v_ring.reshape(B, W, nh, hd)
        logits = torch.einsum("bhd,bwhd->bhw", qh, kh) / math.sqrt(hd)
        logits = torch.where(valid[:, None, :], logits,
                             torch.finfo(logits.dtype).min)
        w_att = torch.softmax(logits, dim=-1).to(vh.dtype)
        o = torch.einsum("bhw,bwhd->bhd", w_att, vh).reshape(B, d)
        a = o @ p[pre + "out_proj.w"] + p[pre + "out_proj.b"]
        x = M._layer_norm(x + a, p[pre + "ln1_s"], p[pre + "ln1_b"])
        f = torch.relu(x @ p[pre + "ff1.w"] + p[pre + "ff1.b"])
        f = f @ p[pre + "ff2.w"] + p[pre + "ff2.b"]
        x = M._layer_norm(x + f, p[pre + "ln2_s"], p[pre + "ln2_b"])

    enc_ring = push(cache.enc, x)
    if rnn_carry:
        pre_act = x @ p["rnn.w_ih"] + p["rnn.b_ih"] + p["rnn.b_hh"]
        h_t = torch.tanh(pre_act + cache.h.to(pre_act.dtype) @ p["rnn.w_hh"])
        cache.h.copy_(torch.where(cm, h_t, cache.h.to(h_t.dtype)))
    else:
        # replay from zero, oldest slot first; the hidden of a stream passes
        # over its invalid slots unchanged
        xin = enc_ring @ p["rnn.w_ih"] + p["rnn.b_ih"] + p["rnn.b_hh"]
        h_t = torch.zeros((B, cfg.rnn_hid_size), dtype=xin.dtype, device=dev)
        for idx in _walk(slot, W):
            h_next = torch.tanh(xin[:, idx] + h_t @ p["rnn.w_hh"])
            h_t = torch.where(valid[:, idx, None], h_next, h_t)
    y = h_t @ p["out.w"] + p["out.b"]
    return cache, y.to(dtype)


# ---------------------------------------------------------------------------
# K8: the whole cached step of a pool as one op over packed weights
# ---------------------------------------------------------------------------

def _check_cache_batch(cache: KVCache, packed_ws, cfg: M.ModelConfig, dev):
    """Raise unless the pool's cache fits the model and the packing; returns
    (B, W)."""
    cd = packed_ws[0].dtype
    if cache.k.dtype != cd:
        raise TypeError(
            f"the cache rings are {cache.k.dtype} and the packed weights "
            f"{cd}: pack the weights in the rings' dtype "
            f"(runner.pack_fused_weights does)")
    if cache.enc.dim() != 3:
        raise ValueError(f"a pool's cache has a leading stream axis: enc "
                         f"(B, W, d), got {tuple(cache.enc.shape)}")
    B, W = cache.enc.shape[:2]
    L, d, H = cfg.tf_layers, cfg.tf_in_dim, cfg.rnn_hid_size
    K.check_input(cache.k, "cache.k", (B, L, W, d), cd, dev)
    K.check_input(cache.v, "cache.v", (B, L, W, d), cd, dev)
    K.check_input(cache.enc, "cache.enc", (B, W, d), cd, dev)
    K.check_input(cache.h, "cache.h", (B, H), cd, dev)
    K.check_input(cache.valid, "cache.valid", (B, W), torch.bool, dev)
    return B, W


def fused_cached_batch_plain(packed_ws, cache: KVCache, x_tokens, slot: int,
                             commit, cfg: M.ModelConfig, *,
                             rnn_carry: bool = False):
    """Plain version of K8 at the global ring cursor ``slot``: the kernel's
    arithmetic with its casts (``fused_cached_forward_step_plain``'s, per
    stream). The token at the cursor is evicted for every stream: a
    committed stream's own token takes its place in the joint softmax, an
    uncommitted stream's cursor slot and self term get the additive -1e30.
    An uncommitted stream's ring rows and ``h`` stay as they were and
    ``valid[:, slot]`` becomes ``commit``; its row of y is unspecified.
    (``cached_forward_step_batch`` keeps that bit for such a stream: the two
    differ there after an uncommitted step on a slot that was valid, which a
    pool never makes. See its docstring.)
    Updates ``cache`` in place; returns (cache, y (B, size_s) float32)."""
    if len(packed_ws) != FF.n_packed(cfg):
        raise ValueError(f"{len(packed_ws)} packed weights, expected "
                         f"{FF.n_packed(cfg)}")
    ws = packed_ws
    dev = x_tokens.device
    B, W = _check_cache_batch(cache, ws, cfg, dev)
    d, nh, hd = cfg.tf_in_dim, cfg.n_heads, cfg.head_dim
    cd = ws[0].dtype
    f32 = torch.float32
    slot = int(slot) % W
    cm = commit[:, None]

    def r(a):
        return FF._round(a, cd)

    def w(i):
        return ws[i].to(f32)

    def push(ring, row):
        ring[:, slot] = torch.where(cm, row.to(cd), ring[:, slot])

    cache.valid[:, slot] = commit        # device to device: no host copy
    mask = torch.where(cache.valid,
                       torch.zeros((), dtype=f32, device=dev),
                       torch.full((), -1e30, dtype=f32, device=dev))
    scale = 1.0 / math.sqrt(hd)

    x = r(_token_fix(x_tokens.to(f32), cfg)) @ w(0) + w(1)
    for li in range(cfg.tf_layers):
        o = 2 + 12 * li
        qkv = r(x) @ w(o) + w(o + 1)
        push(cache.k[:, li], qkv[:, d:2 * d])
        push(cache.v[:, li], qkv[:, 2 * d:])
        q = r(qkv[:, :d]).reshape(B, nh, hd)
        kh = cache.k[:, li].to(f32).reshape(B, W, nh, hd)
        vh = cache.v[:, li].to(f32).reshape(B, W, nh, hd)
        logits = torch.einsum("bhd,bwhd->bhw", q, kh) * scale \
            + mask[:, None, :]
        att = torch.einsum("bhw,bwhd->bhd", r(torch.softmax(logits, dim=-1)),
                           vh).reshape(B, d)
        a = r(att) @ w(o + 2) + w(o + 3)
        x = FF._ln(x + a, ws[o + 8], ws[o + 9])
        f = torch.relu(r(x) @ w(o + 4) + w(o + 5))
        f = r(f) @ w(o + 6) + w(o + 7)
        x = FF._ln(x + f, ws[o + 10], ws[o + 11])

    push(cache.enc, x)
    o = 2 + 12 * cfg.tf_layers
    if rnn_carry:
        pre_act = r(x) @ w(o) + w(o + 1)
        h_t = torch.tanh(pre_act + cache.h.to(f32) @ w(o + 2))
        cache.h.copy_(torch.where(cm, h_t.to(cd), cache.h))
    else:
        xin = cache.enc.to(f32) @ w(o) + w(o + 1)
        w_hh = w(o + 2)
        h_t = torch.zeros((B, cfg.rnn_hid_size), dtype=f32, device=dev)
        for idx in _walk(slot, W):
            h_t = torch.where(cache.valid[:, idx, None],
                              torch.tanh(xin[:, idx] + r(h_t) @ w_hh), h_t)
    return cache, r(h_t) @ w(o + 3) + w(o + 4)


def _launch_batch(packed_ws, cache: KVCache, x_tokens, slot: int, commit,
                  cfg: M.ModelConfig, rnn_carry: bool, clock=None):
    """One cooperative launch of csrc/fused_cached_batch.cu; ``clock``:
    None, or a per-phase clock (``cached_batch_phases``)."""
    name = "fused_cached_batch"
    dev = x_tokens.device
    cd = packed_ws[0].dtype
    d, ff, H = cfg.tf_in_dim, cfg.tf_hid_size, cfg.rnn_hid_size
    B, W = cache.enc.shape[:2]
    so = K.lib("fused_cached_batch", _SIG_BATCH)
    n_scratch = so.fused_cached_batch_scratch_floats(B, W, d, ff, H,
                                                     int(rnn_carry))
    if n_scratch < 0:
        raise ValueError(
            f"{name}: B={B} streams need more scratch than one launch "
            f"addresses (31-bit offsets: fewer than "
            f"{(2 ** 31 - 1) // (W * max(H, d))} streams of {W} slots)")
    y = torch.empty((B, cfg.size_s), dtype=torch.float32, device=dev)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    ptrs = FF.check_packed(packed_ws, cfg, dev, name)
    err = so.fused_cached_batch_launch(
        x_tokens.data_ptr(), ptrs, len(packed_ws), int(cd == torch.bfloat16),
        B, W, cfg.input_dim, d, cfg.n_heads, ff, cfg.tf_layers, H,
        cfg.size_s, FF._imu_dim(cfg) + 108, slot, int(rnn_carry),
        commit.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(),
        cache.enc.data_ptr(), cache.h.data_ptr(), cache.valid.data_ptr(),
        scratch.data_ptr(), n_scratch, y.data_ptr(),
        None if clock is None else clock.data_ptr(),
        0 if clock is None else clock.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    FF.check_launch(err, name, cfg, f"B={B}, W={W}, ", lambda: FF.smem_bytes(
        so, "fused_cached_batch_smem_bytes", int(cd == torch.bfloat16), B,
        W, d, cfg.n_heads, H, int(rnn_carry)), dev)
    K.launch_counts[name] += 1
    return y


# the kinds of K8's phases, as csrc/fused_cached_batch.cu numbers them:
# "in_proj" holds the old ring rows' RNN inputs (a replay) or the carried
# hidden state's product with W_hh (a carry), "rnn_in" the token's RNN
# input (a carry's whole step), "rnn" a replay's walk
K8_PHASES = ("start", "in_proj", "qkv", "attention", "attn_out", "ln1",
             "ff1", "ff2", "ln2", "rnn_in", "rnn", "out_proj")


def cached_batch_phases(packed_ws, cache: KVCache, x_tokens, slot: int,
                        commit, cfg: M.ModelConfig, *,
                        rnn_carry: bool = False):
    """One launch of K8 (CUDA tensors) with its per-phase clock on, as
    ``fused_forward.recompute_batch_phases`` runs K9's: updates ``cache``
    in place as ``fused_cached_batch`` does and returns (y, {kind: ms},
    phases), the kinds those of ``K8_PHASES``."""
    dev = x_tokens.device
    FF.check_packed(packed_ws, cfg, dev, "fused_cached_batch")
    B, W = _check_cache_batch(cache, packed_ws, cfg, dev)
    K.check_input(x_tokens, "x_tokens", (B, cfg.input_dim), torch.float32,
                  dev)
    K.check_input(commit, "commit", (B,), torch.bool, dev)
    clock = FF.new_clock(dev)
    y = _launch_batch(packed_ws, cache, x_tokens, int(slot) % W, commit, cfg,
                      rnn_carry, clock)
    split, n = FF.phase_split(clock.cpu().tolist(), K8_PHASES)
    return y, split, n


def fused_cached_batch(packed_ws, cache: KVCache, x_tokens, slot, commit,
                       cfg: M.ModelConfig, *, rnn_carry: bool = False,
                       impl: str = "auto"):
    """The whole cached step of a pool as one op (twin of tip_tpu's
    ``fused_cached_batch``): kernel K8 for CUDA tokens, its plain version
    for CPU tokens or ``impl="plain"``; ``impl="fused"`` on CPU tokens
    raises.

    Args:
      packed_ws: ``ops.fused_forward.pack_weights`` output, in the dtype of
        the cache rings (raises otherwise).
      cache: a pool's ``KVCache`` (leading stream axis B), updated in place.
      x_tokens: (B, input_dim) float32; the input quirks are applied inside.
      slot: host int, the global ring cursor (the pool's tick), taken mod W.
      commit: (B,) bool tensor on the tokens' device, False for a stream
        that must not count (``fused_cached_batch_plain`` says what such a
        stream keeps).
    Returns (cache, y (B, size_s) float32): the SAME cache. One launch
    serves the whole pool; a pool beyond the kernel's 31-bit scratch offsets
    (B * W * H elements, about 10^5 streams at the serving widths) raises.
    """
    slot = int(slot) % cache.enc.shape[-2]
    if not K.use_kernel(impl, x_tokens, "forward_impl", "fused"):
        return fused_cached_batch_plain(packed_ws, cache, x_tokens, slot,
                                        commit, cfg, rnn_carry=rnn_carry)
    name = "fused_cached_batch"
    dev = x_tokens.device
    FF.check_packed(packed_ws, cfg, dev, name)
    B, W = _check_cache_batch(cache, packed_ws, cfg, dev)
    K.check_input(x_tokens, "x_tokens", (B, cfg.input_dim), torch.float32,
                  dev)
    K.check_input(commit, "commit", (B,), torch.bool, dev)
    return cache, _launch_batch(packed_ws, cache, x_tokens, slot, commit, cfg,
                                rnn_carry)
