"""Whole-model fused forward for inference (twin of
tip_tpu/ops/fused_forward.py).

The whole windowed forward — in-projection with the head-interleave
permutation folded in, the post-norm encoder layers, the tanh-RNN head and
the out-projection — as one op over pre-packed weights:

  K4 ``fused_forward_last``: the (size_s,) prediction at one window index,
     the only row the streaming runner consumes;
  K5 ``fused_forward``: the (T, size_s) predictions at every index;
  K9 ``fused_recompute_batch``: K4 for a pool of B streams, each at its own
     window index, as one launch.

K4 and K5 are one cooperative launch of ``csrc/fused_forward.cu`` (their
phases live in ``csrc/fused_phases.cuh``, shared with the cached steps'
kernels K7 and K8, runtime/streaming_cache.py), K9 one of
``csrc/fused_recompute_batch.cu`` (its products on the tensor cores, its
per-phase clock read by ``recompute_batch_phases``). tip_tpu reaches its
batched kernels through a ``custom_vmap`` rule; here the pool's frame step
calls ``fused_recompute_batch`` directly, and tip_tpu's tile sizes (``bt``,
``bt_rnn``: VMEM tiles) have no counterpart: K9 takes any B. Beside them
the plain PyTorch versions (``fused_forward_last_plain``,
``fused_forward_plain``, ``fused_recompute_batch_plain``), which repeat
the kernel's arithmetic cast by
cast: every product is taken between values rounded to the packing dtype
and summed in float32, the model input stays float32 into the
in-projection, biases are the packed values widened to float32, LayerNorm
and softmax run in float32. ``impl`` is "fused" (the kernel, CUDA tensors
only), "plain", or "auto" (the kernel for a CUDA tensor, the plain version
for a CPU tensor).

Inference only: no dropout, no gradient.
"""

import collections
import ctypes
import math

import torch

from tip_tpu_torch.models import tip_model as M
from tip_tpu_torch.ops import _kernels as K

PACK_DTYPES = (torch.float32, torch.bfloat16)
# the layer limit of csrc/fused_phases.cuh (kMaxLayers, tip_tpu's own);
# rows and head widths have none but a block's shared memory, which the
# launch checks (the kernels' *_smem_bytes give the bytes)
MAX_LAYERS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {"fused_forward_launch": [_P, _P, _P, _I, _I] + [_I] * 10
        + [_P, _P, _P, _I, _P],
        "fused_forward_tiles_bytes": [_I] * 8,
        "fused_forward_smem_bytes": [_I] * 9,
        "fused_forward_tiles": [_P, _I, _I] + [_I] * 7
        + [_P, ctypes.c_longlong, _P]}
_SIG_BATCH = {
    "fused_recompute_batch_launch": [_P, _P, _P] + [_I] * 12
    + [_P, ctypes.c_longlong, _P, _P, _I, _P],
    "fused_recompute_batch_scratch_floats": [_I] * 5,
    "fused_recompute_batch_smem_bytes": [_I] * 5}
# launcher's own return codes (CUDA's are positive)
_ERR_SHAPE = -1
_ERR_SMEM = -2


def n_packed(cfg: M.ModelConfig) -> int:
    return 2 + 12 * cfg.tf_layers + 5


def pack_weights(params, cfg: M.ModelConfig, dtype=torch.bfloat16):
    """Flatten a state dict of ``TIPModel`` (``in_linear.w``,
    ``layers.0.w_q``, ...) into the kernels' input list: the head-interleave
    permutation folded into the in-projection's columns, q/k/v packed as
    one (d, 3d) matrix, both RNN biases summed before the cast. Matrices
    and biases are cast to ``dtype``; LayerNorm scales and biases stay
    float32. Same order and values as tip_tpu's ``pack_weights``."""
    if dtype not in PACK_DTYPES:
        raise TypeError(f"packing dtype {dtype}: float32 or bfloat16")
    if not cfg.with_rnn:
        raise ValueError("the fused forward needs the RNN head (with_rnn)")
    perm = torch.as_tensor(M.head_interleave_perm(cfg),
                           device=params["in_linear.w"].device)
    f32 = torch.float32

    def c(t, dt=dtype):
        return t.detach().to(dt).contiguous()

    ws = [c(params["in_linear.w"][:, perm]), c(params["in_linear.b"][perm])]
    for i in range(cfg.tf_layers):
        p = f"layers.{i}."
        ws += [c(torch.cat([params[p + "w_q"], params[p + "w_k"],
                            params[p + "w_v"]], dim=1)),
               c(torch.cat([params[p + "b_q"], params[p + "b_k"],
                            params[p + "b_v"]])),
               c(params[p + "out_proj.w"]), c(params[p + "out_proj.b"]),
               c(params[p + "ff1.w"]), c(params[p + "ff1.b"]),
               c(params[p + "ff2.w"]), c(params[p + "ff2.b"]),
               c(params[p + "ln1_s"], f32), c(params[p + "ln1_b"], f32),
               c(params[p + "ln2_s"], f32), c(params[p + "ln2_b"], f32)]
    ws += [c(params["rnn.w_ih"]),
           c(params["rnn.b_ih"] + params["rnn.b_hh"]),
           c(params["rnn.w_hh"]),
           c(params["out.w"]), c(params["out.b"])]
    return ws


def _imu_dim(cfg: M.ModelConfig) -> int:
    return cfg.input_size_imu + (18 if cfg.with_acc_sum else 0)


def _check_k_last(k_last, T: int) -> int:
    """``k_last`` as a host int in [0, T). A 0-d integer tensor is read
    back (on a CUDA tensor that waits for the device). An index outside the
    window raises: it is never clamped and never answered with the bare
    output bias."""
    k_last = int(k_last)
    if not 0 <= k_last < T:
        raise IndexError(f"k_last={k_last} is outside the {T}-row window")
    return k_last


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _round(a, cd):
    """Round to the packing dtype and widen back to float32."""
    return a.to(cd).to(torch.float32)


def _ln(x, s, b, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * s + b


def _hiddens_plain(ws, x, cfg: M.ModelConfig):
    """The forward up to the RNN: x (T, input_dim), or (B, T, input_dim) for
    B windows that never see each other -> hidden states (T, H) or (B, T,
    H), float32, with the kernels' casts."""
    if len(ws) != n_packed(cfg):
        raise ValueError(f"{len(ws)} packed weights, expected "
                         f"{n_packed(cfg)}")
    lead = tuple(x.shape[:-2])
    T = x.shape[-2]
    d, h, hd = cfg.tf_in_dim, cfg.n_heads, cfg.head_dim
    cd = ws[0].dtype
    f32 = torch.float32

    def r(a):
        return _round(a, cd)

    def w(i):
        return ws[i].to(f32)

    zc = _imu_dim(cfg) + 108
    x = torch.nan_to_num(x.to(f32), nan=0.0)
    x = torch.cat([x[..., :zc], torch.zeros_like(x[..., zc:zc + 3]),
                   x[..., zc + 3:]], dim=-1)
    x = x @ w(0) + w(1)            # the input is not rounded

    rows = torch.arange(T, device=x.device)
    mask = torch.where(rows[None, :] > rows[:, None],
                       torch.full((), -1e30, dtype=f32, device=x.device),
                       torch.zeros((), dtype=f32, device=x.device))
    scale = 1.0 / math.sqrt(hd)

    def heads(t):                  # (T, d) -> (h, T, hd)
        return r(t).reshape(lead + (T, h, hd)).transpose(-3, -2)

    for li in range(cfg.tf_layers):
        o = 2 + 12 * li
        qkv = r(x) @ w(o) + w(o + 1)
        q, k, v = heads(qkv[..., :d]), heads(qkv[..., d:2 * d]), \
            heads(qkv[..., 2 * d:])
        logits = q @ k.transpose(-1, -2) * scale + mask
        att = (r(torch.softmax(logits, dim=-1)) @ v).transpose(-3, -2) \
            .reshape(lead + (T, d))
        a = r(att) @ w(o + 2) + w(o + 3)
        x = _ln(x + a, ws[o + 8], ws[o + 9])
        f = torch.relu(r(x) @ w(o + 4) + w(o + 5))
        f = r(f) @ w(o + 6) + w(o + 7)
        x = _ln(x + f, ws[o + 10], ws[o + 11])

    o = 2 + 12 * cfg.tf_layers
    xin = r(x) @ w(o) + w(o + 1)
    w_hh = w(o + 2)
    hcur = torch.zeros(lead + (1, cfg.rnn_hid_size), dtype=f32,
                       device=x.device)
    hs = []
    for t in range(T):
        hcur = torch.tanh(xin[..., t:t + 1, :] + r(hcur) @ w_hh)
        hs.append(hcur[..., 0, :])
    return torch.stack(hs, dim=-2)


def fused_forward_plain(packed_ws, x, cfg: M.ModelConfig):
    """Plain version of K5: x (T, input_dim) -> (T, size_s) float32."""
    hs = _hiddens_plain(packed_ws, x, cfg)
    return (_round(hs, packed_ws[0].dtype) @ packed_ws[-2].float()
            + packed_ws[-1].float())


def fused_forward_last_plain(packed_ws, x, k_last, cfg: M.ModelConfig):
    """Plain version of K4: the (size_s,) prediction at window index
    ``k_last``. Rows after it cannot reach it (causal attention, a forward
    RNN), so only rows 0..k_last are computed."""
    k_last = _check_k_last(k_last, x.shape[0])
    hs = _hiddens_plain(packed_ws, x[:k_last + 1], cfg)
    return (_round(hs[k_last], packed_ws[0].dtype) @ packed_ws[-2].float()
            + packed_ws[-1].float())


# ---------------------------------------------------------------------------
# K4 / K5
# ---------------------------------------------------------------------------

def scratch_floats(T: int, cfg: M.ModelConfig) -> int:
    """Size of K4's and K5's scratch (csrc/fused_forward.cu's
    scratch_parts): x, qkv, att, the pre-norm sum, the feed-forward hidden
    and the RNN input in float32, and the walk's (value, step) pairs, two
    floats each; each part a multiple of 4 floats."""
    def r4(n):
        return -(-n // 4) * 4
    d, H = cfg.tf_in_dim, cfg.rnn_hid_size
    return (3 * r4(T * d) + r4(3 * T * d) + r4(T * cfg.tf_hid_size)
            + 3 * r4(T * H))


# check_packed's verdicts and the lists' pointer arrays, by list, for this
# process: {id(list): (its tensors, their data pointers, (dev, widths),
# pointer array)}, the most recent _PACKED_KEEP lists
_packed = collections.OrderedDict()
_PACKED_KEEP = 8


def _widths(cfg: M.ModelConfig):
    return (cfg.input_dim, cfg.tf_in_dim, cfg.n_heads, cfg.tf_hid_size,
            cfg.tf_layers, cfg.rnn_hid_size, cfg.size_s)


def check_packed(packed_ws, cfg: M.ModelConfig, dev, name: str):
    """Raise unless ``packed_ws`` is ``pack_weights``' list for ``cfg``:
    count, one packing dtype, every shape, contiguous, on ``dev``; and
    unless the widths are inside the kernels' limits. Returns the list's
    device pointers as a ctypes array.

    A list that passed is not checked again while it holds the same tensor
    objects at the same data pointers (the entry keeps them alive, so no
    other tensor can take their place): replacing a tensor of the list,
    another count, another device or other widths check it again."""
    key = (dev, _widths(cfg))
    hit = _packed.get(id(packed_ws))
    if (hit is not None and hit[2] == key and len(hit[0]) == len(packed_ws)
            and all(a is b for a, b in zip(hit[0], packed_ws))
            and hit[1] == tuple(t.data_ptr() for t in packed_ws)):
        _packed.move_to_end(id(packed_ws))
        return hit[3]
    _check_packed(packed_ws, cfg, dev, name)
    ptrs = tuple(t.data_ptr() for t in packed_ws)
    _packed[id(packed_ws)] = (tuple(packed_ws), ptrs, key,
                              (ctypes.c_void_p * len(ptrs))(*ptrs))
    while len(_packed) > _PACKED_KEEP:
        _packed.popitem(last=False)
    return _packed[id(packed_ws)][3]


def _check_packed(packed_ws, cfg: M.ModelConfig, dev, name: str):
    cd = packed_ws[0].dtype
    d, ff, H = cfg.tf_in_dim, cfg.tf_hid_size, cfg.rnn_hid_size
    if len(packed_ws) != n_packed(cfg):
        raise ValueError(f"{len(packed_ws)} packed weights, expected "
                         f"{n_packed(cfg)}")
    if cd not in PACK_DTYPES:
        raise TypeError(f"packing dtype {cd}: float32 or bfloat16")
    if not (1 <= cfg.tf_layers <= MAX_LAYERS and d % cfg.n_heads == 0):
        raise ValueError(
            f"{name}: the kernel holds 1..{MAX_LAYERS} layers of heads that "
            f"split d; got {cfg.tf_layers} layers, d={d}, {cfg.n_heads} "
            f"heads")
    f32 = torch.float32
    shapes = [((cfg.input_dim, d), cd), ((d,), cd)]
    for _ in range(cfg.tf_layers):
        shapes += [((d, 3 * d), cd), ((3 * d,), cd), ((d, d), cd), ((d,), cd),
                   ((d, ff), cd), ((ff,), cd), ((ff, d), cd), ((d,), cd),
                   ((d,), f32), ((d,), f32), ((d,), f32), ((d,), f32)]
    shapes += [((d, H), cd), ((H,), cd), ((H, H), cd),
               ((H, cfg.size_s), cd), ((cfg.size_s,), cd)]
    for i, (t, (shape, dt)) in enumerate(zip(packed_ws, shapes)):
        K.check_input(t, f"packed_ws[{i}]", shape, dt, dev)


def smem_bytes(so, fn: str, *args) -> int:
    """A kernel's ``*_smem_bytes`` entry point: the shared memory a block
    of that launch needs (64-bit)."""
    f = getattr(so, fn)
    f.restype = ctypes.c_longlong
    return int(f(*args))


def check_launch(err: int, name: str, cfg: M.ModelConfig, rows: str, need,
                 dev):
    """Raise for a launcher's return code other than 0. ``rows``: the rows
    or slots of the launch, for the message; ``need``: a callable giving
    the shared memory (bytes) a block of the launch needs, stated with what
    a block of ``dev`` has where the launch found too little."""
    if err == _ERR_SHAPE:
        raise ValueError(f"{name}: the kernel refused the shape")
    if err == _ERR_SMEM:
        have = torch.cuda.get_device_properties(
            dev).shared_memory_per_block_optin
        raise ValueError(
            f"{name}: {rows}d={cfg.tf_in_dim} ({cfg.n_heads} heads), "
            f"ff={cfg.tf_hid_size}, H={cfg.rnn_hid_size} need {need()} bytes "
            f"of shared memory a block, more than the {have} a block of this "
            f"card has")
    K.check(err, name)


# K4's and K5's tile-major copies of packed lists, by list, for this
# process: {id(list): (its tensors, their versions, device, copy)}
_tiles = collections.OrderedDict()


def tile_major(packed_ws, cfg: M.ModelConfig, dev, ptrs):
    """The tile-major copy of a checked packed list that K4 and K5 read
    their weights from (csrc/fused_forward.cu's ``fused_forward_tiles``: a
    block's weights of a phase lie together), made on the current stream
    at the list's first launch and again after one of its tensors changed
    (its version counter)."""
    versions = tuple(t._version for t in packed_ws)
    hit = _tiles.get(id(packed_ws))
    if (hit is not None and hit[2] == dev and len(hit[0]) == len(packed_ws)
            and all(a is b for a, b in zip(hit[0], packed_ws))
            and hit[1] == versions):
        _tiles.move_to_end(id(packed_ws))
        return hit[3]
    so = K.lib("fused_forward", _SIG)
    is_bf16 = int(packed_ws[0].dtype == torch.bfloat16)
    widths = (cfg.input_dim, cfg.tf_in_dim, cfg.n_heads, cfg.tf_hid_size,
              cfg.tf_layers, cfg.rnn_hid_size, cfg.size_s)
    n = so.fused_forward_tiles_bytes(is_bf16, *widths)
    if n < 0:
        raise ValueError("fused_forward: the kernel refused the widths")
    tiles = torch.empty(n, dtype=torch.uint8, device=dev)
    K.check(so.fused_forward_tiles(
        ptrs, len(packed_ws), is_bf16, *widths, tiles.data_ptr(), n,
        torch.cuda.current_stream(dev).cuda_stream), "fused_forward_tiles")
    _tiles[id(packed_ws)] = (tuple(packed_ws), versions, dev, tiles)
    while len(_tiles) > _PACKED_KEEP:
        _tiles.popitem(last=False)
    return tiles


# kernel scratch buffers, by (kernel, device, stream, shape): a launch's
# scratch is reused by the next launch on the same stream, which runs after
# it
_scratch = {}


def scratch_buffer(kernel: str, floats, dev, stream, shape):
    """The cached float32 scratch for ``kernel`` at ``shape`` on ``dev``'s
    ``stream`` (a handle, as ``cuda_stream`` gives it): ``floats()``
    floats, asked only when the buffer is made."""
    key = (kernel, dev, stream, shape)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.empty(floats(), dtype=torch.float32,
                                          device=dev)
    return buf


def _launch(packed_ws, x, k_last: int, cfg: M.ModelConfig, name: str,
            clock=None):
    """One cooperative launch; ``k_last`` -1 asks for every row. ``clock``:
    None, or a per-phase clock (``forward_phases``)."""
    T = x.shape[0]
    dev = x.device
    cd = packed_ws[0].dtype
    d, ff, H = cfg.tf_in_dim, cfg.tf_hid_size, cfg.rnn_hid_size
    if T < 1:
        raise ValueError(f"{name}: a window of T={T} rows")
    ptrs = check_packed(packed_ws, cfg, dev, name)
    K.check_input(x, "x", (T, cfg.input_dim), torch.float32, dev)
    tiles = tile_major(packed_ws, cfg, dev, ptrs)
    out = torch.empty((cfg.size_s,) if k_last >= 0 else (T, cfg.size_s),
                      dtype=torch.float32, device=dev)
    so = K.lib("fused_forward", _SIG)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = scratch_buffer("fused_forward", lambda: scratch_floats(T, cfg),
                             dev, stream, (T, d, ff, H))
    err = so.fused_forward_launch(
        x.data_ptr(), ptrs, tiles.data_ptr(), len(packed_ws),
        int(cd == torch.bfloat16),
        T, cfg.input_dim, d, cfg.n_heads, ff, cfg.tf_layers, H, cfg.size_s,
        _imu_dim(cfg) + 108, k_last, scratch.data_ptr(), out.data_ptr(),
        None if clock is None else clock.data_ptr(),
        0 if clock is None else clock.shape[0], stream)
    check_launch(err, name, cfg, f"T={T}, ", lambda: smem_bytes(
        so, "fused_forward_smem_bytes", T, cfg.input_dim, d, cfg.n_heads,
        ff, cfg.tf_layers, H, cfg.size_s, k_last), dev)
    K.launch_counts[name] += 1
    return out


def fused_forward_last(packed_ws, x, k_last, cfg: M.ModelConfig,
                       impl: str = "auto"):
    """The (size_s,) prediction at window index ``k_last`` (0-based, a host
    int or a 0-d integer tensor) of the window x (T, input_dim); equals
    ``fused_forward(...)[k_last]``. Raises unless 0 <= k_last < T."""
    if not K.use_kernel(impl, x, "forward_impl", "fused"):
        return fused_forward_last_plain(packed_ws, x, k_last, cfg)
    k_last = _check_k_last(k_last, x.shape[0])
    return _launch(packed_ws, x, k_last, cfg, "fused_forward_last")


# the kinds of K4's and K5's phases, as csrc/fused_forward.cu numbers them
K4_PHASES = ("start", "in_proj", "qkv", "attention", "attn_out", "ln1",
             "ff1", "ff2", "ln2", "w_ih", "rnn", "out_proj")


def forward_phases(packed_ws, x, k_last, cfg: M.ModelConfig):
    """One launch of K4 (``k_last`` a window index) or K5 (``k_last``
    None) on CUDA tensors with its per-phase clock on, as
    ``recompute_batch_phases`` runs K9's: returns (out, {kind: ms},
    phases), the kinds those of ``K4_PHASES``."""
    k = -1 if k_last is None else _check_k_last(k_last, x.shape[0])
    clock = new_clock(x.device)
    out = _launch(packed_ws, x, k, cfg,
                  "fused_forward" if k < 0 else "fused_forward_last", clock)
    split, n = phase_split(clock.cpu().tolist(), K4_PHASES)
    return out, split, n


def fused_forward(packed_ws, x, cfg: M.ModelConfig, impl: str = "auto"):
    """x (T, input_dim), a single-stream window (imu features ++ history)
    -> (T, size_s) predictions. The input quirks (NaN -> 0, root-velocity
    history channels zeroed) are applied inside."""
    if not K.use_kernel(impl, x, "forward_impl", "fused"):
        return fused_forward_plain(packed_ws, x, cfg)
    return _launch(packed_ws, x, -1, cfg, "fused_forward")


# ---------------------------------------------------------------------------
# K9: K4 for a pool of B streams
# ---------------------------------------------------------------------------

def _check_k_last_batch(k_last, B: int, T: int):
    """``k_last`` as B host ints, each in [0, T). A host sequence or numpy
    array is checked as it is; a tensor is read back (on a CUDA tensor that
    waits for the device). An index outside the window raises."""
    ks = [int(k) for k in (k_last.tolist() if hasattr(k_last, "tolist")
                           else k_last)]
    if len(ks) != B:
        raise ValueError(f"k_last holds {len(ks)} indices for {B} streams")
    bad = [(b, k) for b, k in enumerate(ks) if not 0 <= k < T]
    if bad:
        raise IndexError(f"k_last[{bad[0][0]}]={bad[0][1]} is outside the "
                         f"{T}-row window")
    return ks


def fused_recompute_batch_plain(packed_ws, x, k_last, cfg: M.ModelConfig):
    """Plain version of K9: x (B, T, input_dim), k_last B indices -> the
    (B, size_s) float32 predictions, row b at window index k_last[b] of
    stream b (``fused_forward_last_plain`` per stream: rows after k_last[b]
    cannot reach it)."""
    B, T = x.shape[:2]
    ks = _check_k_last_batch(k_last, B, T)
    return _recompute_batch_rows(packed_ws, x,
                                 torch.as_tensor(ks, device=x.device), cfg)


def _recompute_batch_rows(packed_ws, x, k_idx, cfg: M.ModelConfig):
    """``fused_recompute_batch_plain`` for indices already checked, as an
    integer tensor on x's device: copies nothing from the host."""
    hs = _hiddens_plain(packed_ws, x, cfg)
    h = hs[torch.arange(x.shape[0], device=x.device), k_idx.long()]
    return (_round(h, packed_ws[0].dtype) @ packed_ws[-2].float()
            + packed_ws[-1].float())


def _launch_batch(packed_ws, x, k_dev, cfg: M.ModelConfig, clock=None):
    """One cooperative launch of csrc/fused_recompute_batch.cu; ``clock``:
    None, or the (rows, 4) int64 tensor of ``recompute_batch_phases``."""
    name = "fused_recompute_batch"
    B, T = x.shape[:2]
    dev = x.device
    cd = packed_ws[0].dtype
    d, ff, H = cfg.tf_in_dim, cfg.tf_hid_size, cfg.rnn_hid_size
    so = K.lib("fused_recompute_batch", _SIG_BATCH)
    n_scratch = so.fused_recompute_batch_scratch_floats(B, T, d, ff, H)
    if n_scratch < 0:
        raise ValueError(
            f"{name}: B={B} streams need more scratch than one launch "
            f"addresses (31-bit offsets: fewer than "
            f"{(2 ** 31 - 1) // (T * max(H, cfg.input_dim))} streams of {T} "
            f"rows)")
    f32 = torch.float32
    out = torch.empty((B, cfg.size_s), dtype=f32, device=dev)
    scratch = torch.empty(n_scratch, dtype=f32, device=dev)
    ptrs = check_packed(packed_ws, cfg, dev, name)
    err = so.fused_recompute_batch_launch(
        x.data_ptr(), k_dev.data_ptr(), ptrs, len(packed_ws),
        int(cd == torch.bfloat16), B, T, cfg.input_dim, d, cfg.n_heads, ff,
        cfg.tf_layers, H, cfg.size_s, _imu_dim(cfg) + 108,
        scratch.data_ptr(), n_scratch, out.data_ptr(),
        None if clock is None else clock.data_ptr(),
        0 if clock is None else clock.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, name, cfg, f"B={B}, T={T}, ", lambda: smem_bytes(
        so, "fused_recompute_batch_smem_bytes", B, T, d, cfg.n_heads, H),
        dev)
    K.launch_counts[name] += 1
    return out


# the kinds of K9's phases, as csrc/fused_recompute_batch.cu numbers them
K9_PHASES = ("start", "in_proj", "qkv", "attention", "attn_out", "ln1",
             "ff1", "ff2", "ln2", "w_ih", "rnn", "out_proj")
_CLOCK_ROWS = 1024


def recompute_batch_phases(packed_ws, x, k_last, cfg: M.ModelConfig):
    """One launch of K9 (CUDA tensors) with its per-phase clock on: the
    device ms of each kind of phase, summed over the launch. A phase's
    work is the time from the barrier before it to the last block's
    arrival at the barrier after it; ``barrier`` sums the time from that
    arrival to block 0's leaving the barrier, ``imbalance`` the time
    between the first and the last block's arrival (inside the work). The
    RNN runs its own barriers: its work includes them. Returns (out,
    {kind: ms}, phases)."""
    B, T = x.shape[:2]
    ks = _check_k_last_batch(k_last, B, T)
    check_packed(packed_ws, cfg, x.device, "fused_recompute_batch")
    K.check_input(x, "x", (B, T, cfg.input_dim), torch.float32, x.device)
    clock = new_clock(x.device)
    out = _launch_batch(packed_ws, x, torch.tensor(ks, dtype=torch.int32,
                                                   device=x.device),
                        cfg, clock)
    split, n = phase_split(clock.cpu().tolist())
    return out, split, n


def new_clock(dev):
    """An empty per-phase clock for a whole-model kernel (K4, K5, K7, K8,
    K9; csrc/fused_phases.cuh's PhaseClock): rows of (end, first arrival,
    last arrival, kind)."""
    clock = torch.zeros((_CLOCK_ROWS, 4), dtype=torch.int64, device=dev)
    clock[:, 1] = 2 ** 62
    return clock


def phase_split(rows, names=K9_PHASES):
    """A whole-model kernel's clock rows (end, first arrival, last
    arrival, kind), row 0 the start -> ({kind: ms, "barrier", "imbalance",
    "total"}, phases), the kinds named by ``names`` (K9's, ``K4_PHASES``,
    or ``streaming_cache.K7_PHASES`` / ``K8_PHASES``): see
    ``recompute_batch_phases``. Rows after the last written one (end 0)
    are not read."""
    split = dict.fromkeys(names[1:] + ("barrier", "imbalance"), 0.0)
    n = 0
    for prev, (end, first, last, kind) in zip(rows, rows[1:]):
        if end == 0:
            break
        n += 1
        if last == 0:                      # no arrivals: the RNN
            split[names[kind]] += (end - prev[0]) / 1e6
            continue
        split[names[kind]] += (last - prev[0]) / 1e6
        split["barrier"] += (end - last) / 1e6
        split["imbalance"] += (last - first) / 1e6
    split["total"] = (rows[n][0] - rows[0][0]) / 1e6
    return split, n


def fused_recompute_batch(packed_ws, x, k_last, cfg: M.ModelConfig,
                          impl: str = "auto"):
    """The exact windowed recompute of a pool in one op (twin of tip_tpu's
    ``fused_recompute_batch``): x (B, T, input_dim) float32 left-aligned
    windows, raw (the input quirks are applied inside, per stream); k_last
    B window indices, a host sequence or numpy array (checked on the host
    and copied up) or an integer tensor (read back to be checked). Returns
    (B, size_s) float32; row b equals ``fused_forward_last(packed_ws, x[b],
    k_last[b], cfg)``. Raises ``IndexError`` unless every 0 <= k_last[b] <
    T. Kernel K9 for a CUDA tensor, the plain version for a CPU tensor or
    ``impl="plain"``; ``impl="fused"`` on a CPU tensor raises. One launch
    serves the whole pool; a pool beyond the kernel's 31-bit scratch offsets
    (B * T * H elements, about 10^5 streams at the serving widths) raises."""
    if not K.use_kernel(impl, x, "forward_impl", "fused"):
        return fused_recompute_batch_plain(packed_ws, x, k_last, cfg)
    name = "fused_recompute_batch"
    if x.dim() != 3:
        raise ValueError(f"{name}: x is (B, T, input_dim), got "
                         f"{tuple(x.shape)}")
    B, T = x.shape[:2]
    dev = x.device
    ks = _check_k_last_batch(k_last, B, T)
    check_packed(packed_ws, cfg, dev, name)
    K.check_input(x, "x", (B, T, cfg.input_dim), torch.float32, dev)
    k_dev = torch.tensor(ks, dtype=torch.int32, device=dev)
    return _launch_batch(packed_ws, x, k_dev, cfg)
