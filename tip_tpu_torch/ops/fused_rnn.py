"""Fused tanh-RNN head (twin of tip_tpu/ops/pallas_kernels.py::fused_rnn
and ``fused_rnn_train``).

    h_t = tanh(xin_t + h_{t-1} @ W_hh),  h_{-1} = 0

The RNN head is the one inherently sequential op of the model: each frame
pays T=40 dependent (B, H) x (H, H) steps. Kernel K1
(``csrc/fused_rnn.cu``) walks all T steps in one launch with W_hh resident
in a thread-block cluster's shared memory (``fused_rnn_plan``);
``fused_rnn_plain`` is the same function as a Python loop over T. Both
also run in bf16 (xin and W_hh bf16, f32 sums, each step rounded where
tip_tpu's kernel rounds).

For training, ``fused_rnn_train`` is differentiable: its forward is K1, its
backward the BPTT kernel K10 (``csrc/fused_rnn_bwd.cu``: K1's cluster walk
run backwards, then dW on the tensor cores; ``fused_rnn_bwd_plan``), which
reads only the saved hidden states (tanh' = 1 - h^2):

    dh_t = g_t + da_{t+1} @ W_hh^T,  da_t = dh_t * (1 - h_t^2) -> dxin_t
    dW_hh = sum over t of h_{t-1}^T @ da_t     (h_{-1} = 0)

In bf16 (hs, g and W_hh bf16) both K10 and its plain version compute in
f32 on bf16 operands where tip_tpu's kernel rounds: da_t is rounded to
bf16 once, and that value is dxin_t, the next step's operand and dW's;
dW is summed in f32 and rounded to bf16 at the end.

The bf16 variants walk on the tensor cores (``rnn_cluster.cuh``'s
``tc_walk_kernel``: W_hh's slice in registers as bf16 mma fragments), and
K10 bf16 forms dW as one product of hs and its own output written a row
up (``shifted_rows``: the operand in a scratch of B T H bf16) on wgmma.
``clock=`` runs either with its per-step clock (``K1_PHASES``,
``step_ns``).
"""

import ctypes
import dataclasses

import torch

from tip_tpu_torch.ops import _kernels as K

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_longlong,
                                                      ctypes.c_void_p]
# the bf16 entry point also takes the clock
_ARGS_BF16 = _ARGS[:-1] + [ctypes.c_void_p, ctypes.c_void_p]
_SIG = {"fused_rnn_launch": _ARGS, "fused_rnn_bf16_launch": _ARGS_BF16}
# the entry point and the launch counter of each storage dtype
_VARIANT = {torch.float32: "fused_rnn", torch.bfloat16: "fused_rnn_bf16"}
_ARGS_BWD = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p])
# bf16: the shifted operand for the scratch, dW's product plan (bm, bn,
# kchunk, splits) and the clock; both take the padded operands' scratch
# (pad_scratch) last
_ARGS_BWD_BF16 = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                  + [ctypes.c_longlong] + [ctypes.c_int] * 4
                  + [ctypes.c_void_p] * 3)
_SIG_BWD = {"fused_rnn_bwd_launch": _ARGS_BWD,
            "fused_rnn_bwd_bf16_launch": _ARGS_BWD_BF16}
_VARIANT_BWD = {torch.float32: "fused_rnn_bwd",
                torch.bfloat16: "fused_rnn_bwd_bf16"}


def fused_rnn_plain(xin, w_hh):
    """Plain PyTorch version: xin (B, T, H) with both biases folded in,
    w_hh (H, H) stored (in, out). Returns the (B, T, H) hidden states.

    In bf16 it rounds where tip_tpu's kernel does, three times a step:
    the product h_{t-1} W_hh is summed in f32 and rounded to bf16, the add
    of xin_t runs in f32 and is rounded to bf16, and tanh runs in f32 and
    is rounded to bf16 (torch's bf16 matmul, add and tanh each do that)."""
    B, T, H = xin.shape
    h = xin.new_zeros((B, H))
    hs = []
    for t in range(T):
        h = torch.tanh(xin[:, t] + h @ w_hh)
        hs.append(h)
    return torch.stack(hs, dim=1)


# The walk of K1 and K10 (csrc/rnn_cluster.cuh): a cluster of 8 blocks (the
# portable cluster size) shares W_hh, each block H/8 of its output columns
# rounded up to 32 (32, 64 or 96: wider never fits; the columns past H
# zero) and 256 threads (8 warps, one per eighth of the depth); a cluster
# owns a tile of batch rows. Any H >= 1 whose W slice and one row's
# buffers fit a block runs; where the tile's buffers do not fit, the tile
# shrinks (more clusters, which then run in turns).
#   f32: W's slice in shared memory, the depth padded to 8 slices of a
#   multiple of 4; the tile grows with B (RNN_TILES) until 16 clusters
#   (128 of the H100's 132 SMs) hold B.
#   bf16: the walk on the tensor cores, W's slice in registers (staged once
#   through shared memory), the depth padded to 8 slices of 64 (TC_DEPTH)
#   up to 64 columns a block and to 8 slices of the block's columns past
#   that (768 at 96: a second, deeper instantiation), the row buffers bf16
#   and the partial sums f32. An H100 runs at most 15 clusters of 8 such
#   blocks at once at one block an SM (cudaOccupancyMaxActiveClusters; a
#   16th waits for one of them to end, doubling the time; two blocks on one
#   SM slow both), and a step costs little more with each row of the tile,
#   so a block takes more than half an SM's shared memory and the tile is
#   the fewest rows (up to TC_MAX_TILE) that hold B in TC_CLUSTERS clusters
RNN_CLUSTER = 8
RNN_SPLITS = 8
RNN_TILES = (1, 2, 4, 8, 16)
RNN_FULL_CLUSTERS = 16
RNN_COL_UNIT = 32            # a block's columns, a multiple of this
MAX_SMEM = 232448            # bytes of shared memory a block can have
RNN_THREADS = 256
TC_DEPTH = RNN_SPLITS * 64   # the bf16 walk's padded depth up to H 512
TC_LDH = TC_DEPTH + 8        # bf16 stride of its buffered rows
TC_CLUSTERS = 15
TC_MAX_TILE = 32
TC_MIN_SMEM = 120 * 1024     # more than half an SM's shared memory


@dataclasses.dataclass(frozen=True)
class RNNPlan:
    cluster: int             # blocks of a cluster
    cols: int                # columns of W_hh a block keeps
    batch_tile: int          # batch rows of a cluster
    clusters: int            # cluster i takes rows i * batch_tile, ...
    smem_bytes: int          # shared memory of a block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_cols(H: int) -> int:
    """rnn_cluster.cuh's block_cols(H, 32): the columns of W_hh a block
    keeps, H / 8 rounded up to a multiple of 32."""
    return _cdiv(_cdiv(H, RNN_CLUSTER), RNN_COL_UNIT) * RNN_COL_UNIT


def walk_smem_bytes(H: int, cols: int, bt: int) -> int:
    """rnn_cluster.cuh's smem_bytes: the f32 walk's W slice (depth, cols),
    its two row buffers (bt, depth) and the 8 warps' partial sums."""
    slice_depth = _cdiv(_cdiv(H, RNN_SPLITS), 4) * 4
    depth = RNN_SPLITS * slice_depth
    return 4 * (depth * cols + 2 * bt * depth + RNN_SPLITS * bt * cols)


def _refuse(name: str, H: int, need: int, slice_bytes: int):
    raise ValueError(
        f"{name}: H={H} needs {need} bytes of shared memory a block (W_hh's "
        f"slice {slice_bytes} bytes and the buffers of one batch row), more "
        f"than the {MAX_SMEM} a block can have ({RNN_CLUSTER} blocks of a "
        f"cluster hold {RNN_CLUSTER * MAX_SMEM})")


def _fit_tile(want: int, tiles, smem, name: str, H: int,
              slice_bytes: int) -> int:
    """The largest of ``tiles`` up to ``want`` whose block fits MAX_SMEM
    (``smem(bt)``); refuses where one row does not fit."""
    fits = [t for t in tiles if t <= want and smem(t) <= MAX_SMEM]
    if not fits:
        _refuse(name, H, smem(min(tiles)), slice_bytes)
    return max(fits)


def _walk_plan(B: int, H: int, name: str) -> RNNPlan:
    """The f32 walk's plan for B rows of width H: block_cols(H) columns a
    block, the depth padded to 8 slices of a multiple of 4 (rnn_cluster.cuh's
    slice_depth); the tile of RNN_TILES that holds B in RNN_FULL_CLUSTERS
    clusters, or the largest smaller one whose buffers fit."""
    cols = block_cols(H)
    want = _cdiv(B, RNN_FULL_CLUSTERS)
    want = next((t for t in RNN_TILES if t >= want), RNN_TILES[-1])
    w_bytes = walk_smem_bytes(H, cols, 0)
    bt = _fit_tile(want, RNN_TILES, lambda t: walk_smem_bytes(H, cols, t),
                   name, H, w_bytes)
    return RNNPlan(RNN_CLUSTER, cols, bt, _cdiv(B, bt),
                   walk_smem_bytes(H, cols, bt))


def tc_rows(bt: int) -> int:
    """Rows of the bf16 walk's row buffers: the mma's 8-wide side, 1 to 4
    times."""
    return -(-bt // 8) * 8


def tc_batch_tile(B: int) -> int:
    """The bf16 walk's tile: the fewest rows that hold B in TC_CLUSTERS
    clusters, at most TC_MAX_TILE (past TC_CLUSTERS TC_MAX_TILE rows the
    clusters run in turns)."""
    return min(-(-B // TC_CLUSTERS), TC_MAX_TILE)


def tc_depth(cols: int) -> int:
    """rnn_cluster.cuh's tc_depth: the bf16 walk's padded depth, TC_DEPTH up
    to 64 columns a block, 8 slices of the block's columns past that."""
    return RNN_SPLITS * max(cols, 64)


def tc_smem_bytes(cols: int, bt: int, back: bool) -> int:
    """rnn_cluster.cuh's tc_smem_bytes: W's slice as staged (forward (depth,
    cols + 8), backward (cols, depth + 8), bf16), the two row buffers (bf16)
    and the 8 warps' partial sums (f32, bt rows of cols + 4); at least
    TC_MIN_SMEM, so that no two blocks share an SM."""
    depth = tc_depth(cols)
    ldh = depth + 8
    w = cols * ldh if back else depth * (cols + 8)
    return max(2 * w + 2 * 2 * tc_rows(bt) * ldh
               + 4 * RNN_SPLITS * bt * (cols + 4), TC_MIN_SMEM)


def _tc_walk_plan(B: int, H: int, name: str, back: bool) -> RNNPlan:
    """The bf16 walk's plan (csrc/rnn_cluster.cuh's tc_plan_ok):
    block_cols(H) columns a block, the tile ``tc_batch_tile``, or the
    largest smaller one whose buffers fit."""
    cols = block_cols(H)
    depth = tc_depth(cols)
    w_bytes = 2 * (cols * (depth + 8) if back else depth * (cols + 8))
    bt = _fit_tile(tc_batch_tile(B), range(1, TC_MAX_TILE + 1),
                   lambda t: tc_smem_bytes(cols, t, back), name, H, w_bytes)
    return RNNPlan(RNN_CLUSTER, cols, bt, _cdiv(B, bt),
                   tc_smem_bytes(cols, bt, back))


def fused_rnn_plan(B: int, H: int, w_bytes: int = 4) -> RNNPlan:
    """K1's launch plan for B rows of width H, W_hh stored ``w_bytes``
    bytes an entry (4: the f32 walk; 2: the bf16 walk on the tensor
    cores). Raises where W_hh's slice and one row's buffers do not fit a
    block (there is no other kernel to fall back to), with the bytes."""
    if B <= 0 or H <= 0:
        raise ValueError(f"fused_rnn: B={B}, H={H}")
    if w_bytes == 2:
        return _tc_walk_plan(B, H, "fused_rnn", back=False)
    return _walk_plan(B, H, "fused_rnn")


# f32 dW's product (csrc/train_mma.cuh's tiles): 128 rows x 64 columns a
# block where N <= 256, else 128 x 128; the B T rows split into chunks of a
# multiple of 32 (at least 256 rows) until the card has about 264 blocks
# (two an SM), as train_mma.cuh's split_plan cuts a weight gradient
DW_TILE_M = 128
DW_SLICE = 32
DW_TARGET_BLOCKS = 264


@dataclasses.dataclass(frozen=True)
class RNNBwdPlan:
    walk: RNNPlan            # the walk backwards (K1's, W's rows in a block)
    dw_rows: int             # rows of B T a split of dW's product takes
    dw_splits: int           # partial products, added in order (1: none)
    dw_tile: tuple = ()      # bf16: (bm, bn) of bf16_gemm.cuh's product;
    #                          f32: () (train_mma.cuh's tile, by H)


def pad_width(H: int, w_bytes: int) -> int:
    """The row of K10's dW operands: H, or H rounded up to 16 bytes (4 f32,
    8 bf16) where it is not a multiple of them (the walk then writes padded
    copies of hs and da)."""
    unit = 16 // w_bytes
    return _cdiv(H, unit) * unit


def fused_rnn_bwd_plan(B: int, T: int, H: int,
                      w_bytes: int = 4) -> RNNBwdPlan:
    """K10's launch plan: the walk's (K1's, W's rows in a block; W stored
    ``w_bytes`` bytes an entry: 2 is the bf16 walk on the tensor cores) and
    dW's split. f32: train_mma.cuh's split of the B T rows. bf16:
    ops/encoder_train.py's product plan of dW = hs^T shifted, an (Hp, Hp,
    B T) product, Hp = ``pad_width(H, 2)`` (its splits one cluster, summed
    in rank order). Raises where W's slice and one row's buffers do not
    fit, with the bytes."""
    if B <= 0 or T <= 0 or H <= 0:
        raise ValueError(f"fused_rnn_bwd: B={B}, T={T}, H={H}")
    rows = B * T
    if w_bytes == 2:
        from tip_tpu_torch.ops.encoder_train import product_plan
        walk = _tc_walk_plan(B, H, "fused_rnn_bwd", back=True)
        hp = pad_width(H, 2)
        dw = product_plan("dW", "hs^T shifted", hp, hp, rows)
        return RNNBwdPlan(walk, dw.kchunk, dw.splits, (dw.bm, dw.bn))
    walk = _walk_plan(B, H, "fused_rnn_bwd")
    tile_n = 64 if H <= 256 else 128
    tiles = -(-H // DW_TILE_M) * -(-H // tile_n)
    splits = max(1, min(-(-DW_TARGET_BLOCKS // tiles), -(-rows // 256)))
    per_split = -(-rows // splits)
    chunk = -(-per_split // DW_SLICE) * DW_SLICE
    return RNNBwdPlan(walk, chunk, -(-rows // chunk))


def bwd_scratch(plan: RNNBwdPlan, B: int, T: int, H: int, dtype):
    """(entries, dtype) of K10's scratch: bf16, the shifted operand of dW
    (B T Hp bf16, Hp = ``pad_width(H, 2)``, written by the walk, read by
    dW's product); f32, dW's partial products where it is split (else
    none)."""
    if dtype == torch.bfloat16:
        return B * T * pad_width(H, 2), torch.bfloat16
    n = plan.dw_splits * H * H if plan.dw_splits > 1 else 0
    return n, torch.float32


def pad_scratch(B: int, T: int, H: int, dtype) -> int:
    """Entries of K10's scratch for its padded operands where a row of H is
    not a multiple of 16 bytes (else 0): f32, hs's and da's copies (2 B T
    Hp); bf16, hs's copy and dW before its crop (B T Hp + Hp Hp)."""
    w_bytes = 2 if dtype == torch.bfloat16 else 4
    hp = pad_width(H, w_bytes)
    if hp == H:
        return 0
    return B * T * hp + hp * hp if w_bytes == 2 else 2 * B * T * hp


def shifted_rows(dx):
    """Plain model of K10 bf16's dW operand (B, T, H): dx a row up within
    each sequence, shifted[:, t - 1] = dx[:, t], shifted[:, T - 1] = 0, so
    that dW = hs^T shifted over all B T rows (h_{t-1} pairs with da_t)."""
    return torch.cat([dx[:, 1:], torch.zeros_like(dx[:, :1])], dim=1)


# the phases of the bf16 walk's per-step clock (csrc/rnn_cluster.cuh's
# StepClock), in the order of the step
K1_PHASES = ("product", "split_sum", "epilogue", "broadcast", "barrier_wait")
CLOCK_ROWS = 2 + len(K1_PHASES)


def step_ns(stamps, T: int, cycles_per_ns: float) -> dict:
    """The bf16 walk's clock (block 0's thread 0: the kernel's start, the
    loop's start, then the end of each phase as if the phases of all T
    steps ran one after another, SM cycles) -> {"prologue": ns, phase: ns
    a step, "step": ns a step}."""
    out = {"prologue": (stamps[1] - stamps[0]) / cycles_per_ns}
    for i, name in enumerate(K1_PHASES):
        out[name] = (stamps[2 + i] - stamps[1 + i]) / cycles_per_ns / T
    out["step"] = (stamps[-1] - stamps[1]) / cycles_per_ns / T
    return out


def _check_clock(clock, plan: RNNPlan, H: int, name: str):
    """The bf16 walk's clock is built for blocks of up to 64 columns and
    rows of 16 bytes."""
    if clock is not None and (plan.cols > 64 or H % 8):
        raise ValueError(f"{name}: the bf16 walk's clock is built for H a "
                         f"multiple of 8 up to {RNN_CLUSTER * 64}")


def _launch(xin, w_hh, clock=None):
    """K1 in xin's dtype, float32 or bfloat16 (W_hh in the same); clock
    (bf16 only): None or a (CLOCK_ROWS,) int64 tensor."""
    B, T, H = xin.shape
    name = _VARIANT.get(xin.dtype)
    if name is None:
        raise TypeError(f"xin: dtype {xin.dtype}, expected float32 or "
                        f"bfloat16")
    bf16 = xin.dtype == torch.bfloat16
    if clock is not None and not bf16:
        raise ValueError("fused_rnn: the clock is the bf16 walk's")
    K.check_input(xin, "xin", (B, T, H), xin.dtype, xin.device)
    K.check_input(w_hh, "w_hh", (H, H), xin.dtype, xin.device)
    plan = fused_rnn_plan(B, H, xin.element_size())
    _check_clock(clock, plan, H, "fused_rnn")
    out = torch.empty_like(xin)
    so = K.lib("fused_rnn", _SIG)
    args = [xin.data_ptr(), w_hh.data_ptr(), out.data_ptr(), B, T, H,
            plan.cluster, plan.cols, plan.batch_tile, plan.clusters,
            plan.smem_bytes]
    if bf16:
        args.append(K.clock_ptr(clock, CLOCK_ROWS, xin.device))
    err = getattr(so, f"{name}_launch")(*args, K.stream_of(xin.device))
    K.check(err, name)
    K.launch_counts[name] += 1
    return out


def fused_rnn(xin, w_hh, impl: str = "auto", clock=None):
    """The RNN head by ``impl``: "kernel" launches K1 (CUDA tensors only),
    "plain" runs ``fused_rnn_plain``, "auto" launches K1 for a CUDA tensor
    and runs the plain version for a CPU tensor. K1 takes float32 or
    bfloat16 (xin and W_hh alike; counted as ``fused_rnn`` and
    ``fused_rnn_bf16``). clock: None, or a (CLOCK_ROWS,) int64 tensor on
    the device for the bf16 walk's per-step clock (``step_ns``)."""
    if xin.dtype != w_hh.dtype:
        raise TypeError(f"fused_rnn: xin is {xin.dtype}, w_hh {w_hh.dtype}; "
                        f"both float32 or both bfloat16")
    if K.use_kernel(impl, xin, "rnn_impl", "kernel"):
        return _launch(xin, w_hh, clock)
    return fused_rnn_plain(xin, w_hh)


def fused_rnn_bwd_plain(hs, w_hh, g):
    """Plain PyTorch version of K10: hs (B, T, H) the hidden states, w_hh
    (H, H), g (B, T, H) the gradient of the hidden states. Returns (dxin
    (B, T, H) in hs's dtype, dw (H, H) in W's) in the order of tip_tpu's
    ``_rnn_bwd``: dW summed from t = T-1 down to 0.

    In bf16 it is f32 arithmetic on bf16 operands, as tip_tpu's kernel: dh
    = g_t + bf16(da_{t+1}) W^T and da = dh (1 - h_t^2) in f32, dxin_t =
    bf16(da), dW += bf16(h_{t-1})^T bf16(da) in f32, rounded to bf16 at
    the end (torch's bf16 ``@`` would round each product's output)."""
    B, T, H = hs.shape
    f = torch.float64 if hs.dtype == torch.float64 else torch.float32
    if hs.dtype == torch.bfloat16:
        def rnd(t):                    # the bf16 operand, as its f32 image
            return t.to(torch.bfloat16).to(f)
    else:
        def rnd(t):
            return t
    wt = w_hh.to(f).T
    da = hs.new_zeros((B, H), dtype=f)
    dw = hs.new_zeros((H, H), dtype=f)
    dx = torch.empty_like(hs)
    for t in range(T - 1, -1, -1):
        h_t = hs[:, t].to(f)
        dh = g[:, t].to(f) + da @ wt
        da = rnd(dh * (1.0 - h_t * h_t))
        dx[:, t] = da
        h_prev = hs[:, t - 1].to(f) if t > 0 else torch.zeros_like(h_t)
        dw = dw + h_prev.T @ da
    return dx, dw.to(w_hh.dtype)


def _launch_bwd(hs, w_hh, g, clock=None):
    """K10 in hs's dtype, float32 or bfloat16 (W and g in the same); clock
    (bf16 only): None or a (CLOCK_ROWS,) int64 tensor for the walk's."""
    B, T, H = hs.shape
    name = _VARIANT_BWD.get(hs.dtype)
    if name is None:
        raise TypeError(f"hs: dtype {hs.dtype}, expected float32 or "
                        f"bfloat16")
    bf16 = hs.dtype == torch.bfloat16
    if clock is not None and not bf16:
        raise ValueError("fused_rnn_bwd: the clock is the bf16 walk's")
    for t, tn, shape in ((hs, "hs", (B, T, H)), (w_hh, "w_hh", (H, H)),
                         (g, "g", (B, T, H))):
        K.check_input(t, tn, shape, hs.dtype, hs.device)
    plan = fused_rnn_bwd_plan(B, T, H, hs.element_size())
    walk = plan.walk
    _check_clock(clock, walk, H, "fused_rnn_bwd")
    so = K.lib("fused_rnn_bwd", _SIG_BWD)
    dx = torch.empty_like(hs)
    dw = torch.empty((H, H), dtype=hs.dtype, device=hs.device)
    n_part, part_dtype = bwd_scratch(plan, B, T, H, hs.dtype)

    def scratch(n):
        return torch.empty(n, dtype=part_dtype, device=hs.device) if n else None

    part = scratch(n_part)
    pad = scratch(pad_scratch(B, T, H, hs.dtype))
    args = [hs.data_ptr(), w_hh.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), None if part is None else part.data_ptr(), B, T,
            H, walk.cluster, walk.cols, walk.batch_tile, walk.clusters,
            walk.smem_bytes]
    if bf16:
        args += [*plan.dw_tile, plan.dw_rows, plan.dw_splits,
                 K.clock_ptr(clock, CLOCK_ROWS, hs.device)]
    else:
        args += [plan.dw_rows, plan.dw_splits]
    args.append(None if pad is None else pad.data_ptr())
    err = getattr(so, f"{name}_launch")(*args, K.stream_of(hs.device))
    K.check(err, name)
    K.launch_counts[name] += 1
    return dx, dw


def fused_rnn_bwd(hs, w_hh, g, impl: str = "auto", clock=None):
    """The RNN head's backward by ``impl``, as ``fused_rnn``: "kernel"
    launches K10 (CUDA tensors only), "plain" runs ``fused_rnn_bwd_plain``,
    "auto" K10 for a CUDA tensor and the plain version for a CPU one. K10
    takes float32 or bfloat16 (hs, W and g alike; counted as
    ``fused_rnn_bwd`` and ``fused_rnn_bwd_bf16``). clock: as
    ``fused_rnn``'s, for the bf16 walk."""
    if not hs.dtype == w_hh.dtype == g.dtype:
        raise TypeError(f"fused_rnn_bwd: hs is {hs.dtype}, w_hh "
                        f"{w_hh.dtype}, g {g.dtype}; all float32 or all "
                        f"bfloat16")
    if K.use_kernel(impl, hs, "rnn_impl", "kernel"):
        return _launch_bwd(hs, w_hh, g, clock)
    return fused_rnn_bwd_plain(hs, w_hh, g)


class _FusedRNNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xin, w_hh, impl):
        hs = fused_rnn(xin.detach().contiguous(), w_hh.detach().contiguous(),
                       impl=impl)
        ctx.save_for_backward(hs, w_hh)
        ctx.impl = impl
        return hs

    @staticmethod
    def backward(ctx, g):
        hs, w_hh = ctx.saved_tensors
        dxin, dw = fused_rnn_bwd(hs.detach(), w_hh.detach().contiguous(),
                                 g.contiguous(), impl=ctx.impl)
        return dxin, dw, None


def fused_rnn_train(xin, w_hh, impl: str = "auto"):
    """Differentiable fused tanh-RNN (twin of tip_tpu's ``fused_rnn_train``):
    forward K1, backward K10 on CUDA tensors, the plain versions on CPU
    tensors (``impl`` as ``fused_rnn``). Saves only the hidden states.
    float32 or bfloat16 (float64 plain); the gradients come back in the
    dtypes of xin and W_hh."""
    return _FusedRNNTrain.apply(xin, w_hh, impl)
