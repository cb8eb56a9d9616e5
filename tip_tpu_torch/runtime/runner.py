"""Streaming inference runtime: the minimal runner in its three serving
modes, for one stream (``runner_step``) and for a pool of B streams that
tick together (``pool_step``, ``make_multi_stream_step``); twin of
tip_tpu/runtime/runner.py.

One 60 Hz frame of the minimal runner is

    runner_step : (model, carry, imu_t) -> (carry', out_t)

over a carry of fixed-size tensors (ring buffers) plus three host ints.
The frame pipeline (reference real_time_runner_minimal.py:114-200):

  1. raw ring: acc smoothed over an 11-frame centered window; orientation
     delayed 5 frames (fixed 5-frame algorithmic latency);
  2. per-frame root-local IMU features + running 40-frame acc-sum;
  3. model forward: in ``serving_mode="recompute"`` over the (<=40)-frame
     window, left-aligned, with the output read at the last valid index
     (``forward_impl="fused"``: the whole model as kernel K4,
     ops/fused_forward.fused_forward_last); in the KV-cache modes the newest
     token alone against cached K/V rings (runtime/streaming_cache.py;
     ``forward_impl="fused"``: the whole cached step as kernel K7);
  4. exponential output filter (0.6^k over the last 6 raw outputs) and
     SBP / 6D decode (kernel K2, ops/fused_tail.decode_fused);
  5. state assembly: root ori from IMU0, root xyz integrated from the
     predicted velocity, 2-frame pose blend;
  6. FK + SBP root correction (kernel K3, ops/fused_tail.tail_fused; with
     ``tail_impl="plain"`` the plain ops, their FK by ``fk_impl``: plain or
     kernel K6, ops/kinematics.fk_bullet_fused) with the flat-ground z fix;
  7. history push for the next frame's autoregressive input.

The frame counters ``t``, ``k`` and ``n_out`` depend only on the frame
index, so they are host ints and tip_tpu's ``jnp.where(active, ...)``
selects become host branches: a frame enqueues its work on the device and
never waits for it. A frame before the first smoothed IMU frame (``t <
imu_n_smooth``) runs no model and no kernel and returns ``s_init``.

**The pool's frame step.** tip_tpu gets it from ``jax.vmap`` over its
``runner_step``; here it is written out over a leading stream axis B
(``pool_step`` over a ``PoolCarry``). Each stream of a pool joins at its own
tick, so the single stream's host branches become per-stream selects. The
counters stay on the host, as (B,) integer arrays: the masks they give
(first frame, commit, window full, active, filter on, blend, the
left-aligned push positions) go up to the device in two small tensors with
the IMU batch, every select is a ``torch.where`` on the device, and a tick
reads nothing back but the outputs it returns. With
``forward_impl="fused"`` the model stage of a tick is one launch (K8
``streaming_cache.fused_cached_batch`` in the KV-cache modes, K9
``ops.fused_forward.fused_recompute_batch`` in recompute mode), and decode,
tail and FK (K2, K3, K6) are one launch each for the whole pool.
"""

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch import device_const, resolve_device
from tip_tpu_torch.models import tip_model as M
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import fused_forward as FF
from tip_tpu_torch.ops import fused_tail as FT
from tip_tpu_torch.ops import imu as imu_ops
from tip_tpu_torch.ops import kinematics as kin
from tip_tpu_torch.ops import rotations as rot
from tip_tpu_torch.ops import sbp as sbp_ops
from tip_tpu_torch.runtime import streaming_cache as SC

SERVING_MODES = ("recompute", "kv_cache", "kv_cache_rnn_carry")


@dataclass(frozen=True)
class RunnerConfig:
    model: M.ModelConfig = M.ModelConfig()
    n_sbps: int = 5
    window: int = 40                      # max_input_l
    imu_n_smooth: int = cst.IMU_N_SMOOTH  # 5
    with_acc_sum: bool = True
    dt: float = cst.DT
    # exponential output filter weights 0.6^[5..0]
    filter_len: int = 6
    # stages 4-7: "fused" launches kernels K2 (decode) and K3 (tail) and
    # needs CUDA tensors and the 5-SBP layout; "plain" runs the plain ops.
    # "auto" is resolved once from the configuration by
    # ``resolved_tail_impl``, as tip_tpu's: "fused" on a CUDA device with
    # 5 SBPs, else the plain versions of K2 and K3 (with another SBP count
    # on the card too, which K3 does not take). K2 takes any count, but
    # the route keeps decode and tail together, as tip_tpu's XLA tail does
    tail_impl: str = "auto"
    # FK of the plain tail (tail_impl="plain"; the fused tail holds its own
    # tree walk): "plain" is the level-parallel ops/kinematics.fk, "kernel"
    # the whole pose -> frames pipeline as kernel K6
    # (kinematics.fk_bullet_fused, CUDA tensors only), "auto" K6 on a CUDA
    # device and plain on the CPU
    fk_impl: str = "plain"
    # "recompute": the windowed forward every frame (reference semantics);
    # "kv_cache": per-layer K/V rings, only the newest token runs through
    # the encoder (exact while the window grows, a documented divergence
    # once it slides: runtime/streaming_cache.py); "kv_cache_rnn_carry": the
    # same plus a carried RNN hidden (one RNN step a frame instead of a
    # 40-step replay)
    serving_mode: str = "recompute"

    def __post_init__(self):
        # the per-frame acc-sum equals the sum over the model window only
        # when the two lengths coincide
        if self.with_acc_sum and self.window != cst.ACC_SUM_WIN_LEN:
            raise ValueError("acc-sum feature requires window == "
                             "ACC_SUM_WIN_LEN")
        K.check_impl(self.tail_impl, "tail_impl", "fused")
        if self.tail_impl == "fused" and self.n_sbps != 5:
            raise ValueError("tail_impl='fused' supports the 5-SBP layout only")
        if self.serving_mode not in SERVING_MODES:
            raise ValueError(f"serving_mode must be one of "
                             f"{'|'.join(SERVING_MODES)}, got "
                             f"{self.serving_mode!r}")
        K.check_impl(self.fk_impl, "fk_impl", "kernel")
        if self.fk_impl != "plain" and self.tail_impl != "plain":
            raise ValueError(
                f"fk_impl={self.fk_impl!r} selects the FK of the plain tail: "
                f"it needs tail_impl='plain' (the fused tail holds its own "
                f"FK), got tail_impl={self.tail_impl!r}")

    def resolved_tail_impl(self, device_type: str) -> str:
        """The route of stages 4-7 on a device of ``device_type`` ("cuda",
        "cpu"), for K2's and K3's wrappers: "auto" is "fused" on "cuda" with
        the 5-SBP layout and "plain" otherwise; an explicit value passes
        through (an explicit "fused" with another SBP count is refused in
        ``__post_init__``). Pure in (tail_impl, n_sbps, device_type): the
        route comes from the configuration, never from a failed launch."""
        if self.tail_impl != "auto":
            return self.tail_impl
        return ("fused" if device_type == "cuda" and self.n_sbps == 5
                else "plain")

    @property
    def cached(self) -> bool:
        """A KV-cache serving mode (the carry has the cached layout)."""
        return self.serving_mode != "recompute"

    @property
    def smooth_win(self) -> int:
        return 2 * self.imu_n_smooth + 1   # 11

    @property
    def state_dim(self) -> int:
        return cst.state_dim(self.n_sbps)  # 131 for 5 SBPs


@dataclass
class RunnerCarry:
    """Runner state; the three counters are host ints.

    The window buffers depend on the mode. The recompute forward needs the
    whole chronological windows; the KV-cache modes only ever read the
    newest history entry and the 40-frame-old acc, so they keep one-row
    writes instead of shifts:

      field        recompute                       kv-cache modes
      imu_win      (40, 72) features, left-aligned (40, 18) circular acc ring
      accsum_win   (40, 18) acc-sum, left-aligned  None
      s_and_c_win  (40, state_dim), left-aligned   (state_dim,) newest entry
      out_buf      (6, state_dim), newest last     (6, state_dim) circular
      cache        None                            streaming_cache.KVCache

    A step returns a new carry and leaves the old one's tensors as they
    were, except ``cache``: its rings are updated in place, so the carry a
    step was given shares the new carry's cache."""
    t: int                         # frames seen so far
    raw_imu: torch.Tensor          # (11, 72) raw ring, newest last
    k: int                         # smoothed frames seen (window holds
    #                                the last min(k, window) of them)
    imu_win: torch.Tensor          # see the class docstring
    accsum_win: Optional[torch.Tensor]   # acc-sum features (unscaled)
    acc_runsum: torch.Tensor       # (18,) running 40-frame local-acc sum
    s_and_c_win: torch.Tensor      # autoregressive history
    out_buf: torch.Tensor          # (6, state_dim) raw outputs for the filter
    n_out: int                     # outputs produced so far
    last_s: torch.Tensor           # (114,) previous assembled state
    prev_pq: torch.Tensor          # (20, 7) previous FK frames
    prev_root: torch.Tensor        # (3,) previous root xyz (post-correction)
    c_locs: torch.Tensor           # (n_sbps, 3)
    s_init: torch.Tensor           # (114,) initial state (warmup output)
    cache: Optional[SC.KVCache] = None


def _filter_coeff(cfg: RunnerConfig, dtype, device) -> torch.Tensor:
    return device_const(tuple(0.6 ** np.arange(cfg.filter_len)[::-1]),
                        dtype, device)


def state_to_history(s, c, n_sbps: int):
    """(114,) state + (n_sbps*4,) SBP vector -> (state_dim,) history entry:
    [root_aa + 17 joint aa] as two-axis 6D (108) + root velocity (3) + SBP
    vector. Leading batch dimensions carry over."""
    lead = s.shape[:-1]
    aa = s[..., 3:3 + 54].reshape(lead + (18, 3))
    sixd = rot.aa_to_sixd(aa).reshape(lead + (108,))
    root_v = s[..., cst.N_DOFS:cst.N_DOFS + 3]
    return torch.cat([sixd, root_v, c], dim=-1)


def _init_leaves(cfg: RunnerConfig, skel: kin.Skeleton, s_init, dtype,
                 device):
    """The tensor leaves of a carry before the first frame, by field name:
    one stream's for s_init (114,), a pool's (a leading B) for (B, 114)."""
    _check_on(skel.joint_offset, device, "skeleton")
    s_init = torch.as_tensor(s_init, dtype=dtype, device=device)
    lead = tuple(s_init.shape[:-1])
    sd = cfg.state_dim
    hist0 = state_to_history(
        s_init, torch.zeros(lead + (cfg.n_sbps * 4,), dtype=dtype,
                            device=device), cfg.n_sbps)
    pq0 = kin.fk_our_state(skel, s_init)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    if cfg.cached:
        cache = SC.cache_init(cfg.model, cfg.window, dtype, device,
                              batch=lead[0] if lead else None)
        imu_win = zeros(cfg.window, cst.ACC_SUM_DIM)
        accsum_win = None
        s_and_c = hist0
    else:
        cache = None
        imu_win = zeros(cfg.window, cst.IMU_DIM)
        accsum_win = zeros(cfg.window, cst.ACC_SUM_DIM)
        s_and_c = zeros(cfg.window, sd)
        s_and_c[..., 0, :] = hist0
    return dict(
        cache=cache,
        raw_imu=zeros(cfg.smooth_win, cst.IMU_DIM),
        imu_win=imu_win,
        accsum_win=accsum_win,
        acc_runsum=zeros(cst.ACC_SUM_DIM),
        s_and_c_win=s_and_c,
        out_buf=zeros(cfg.filter_len, sd),
        last_s=s_init,
        prev_pq=pq0.to(dtype),
        prev_root=s_init[..., :3],
        c_locs=torch.full(lead + (cfg.n_sbps, 3), 100.0, dtype=dtype,
                          device=device),
        s_init=s_init,
    )


def runner_init(cfg: RunnerConfig, skel: kin.Skeleton, s_init,
                dtype=torch.float32, device=None) -> RunnerCarry:
    """The carry before the first frame, on ``device`` (``cuda`` unless the
    caller asks for another)."""
    device = resolve_device(device)
    return RunnerCarry(t=0, k=0, n_out=0,
                       **_init_leaves(cfg, skel, s_init, dtype, device))


def _push_left_aligned(win, k: int, x, window: int):
    """Append x to a left-aligned ring: write at slot k while k < window,
    else shift left and write at the end."""
    if k < window:
        out = win.clone()
        out[k] = x
        return out
    return torch.cat([win[1:], x[None]], dim=0)


def _ring_push(buf, cursor: int, new_row):
    """Circular push: a copy of ``buf`` with ``new_row`` at slot
    ``cursor % rows``. Returns (the old row at that slot, the new buffer,
    the slot): the old row is read before the write."""
    slot = cursor % buf.shape[0]
    out = buf.clone()
    out[slot] = new_row
    return buf[slot], out, slot


def push_history(cfg: RunnerConfig, old_win, k_new: int, hist):
    """Append a history entry by the mode's layout: recompute keeps the
    chronological left-aligned window the windowed forward consumes; the
    cached modes only ever read the newest entry, stored as a bare
    vector."""
    if cfg.cached:
        return hist
    return _push_left_aligned(old_win, k_new, hist, cfg.window)


class SensedFrame(tuple):
    """(raw, k_new, imu_win, accsum_win, acc_runsum, out_buf, n_out, active,
    s_t, c_t) — output of the sensing/prediction front-end. ``active`` is a
    host bool (the model has at least one frame); s_t and c_t are None
    when it is False. The cache is not in it: a cached step updates
    ``carry.cache`` in place."""
    __slots__ = ()


def model_window(cfg: RunnerConfig, imu_win, accsum_win, s_and_c_win):
    """The model's input over the window: (window, 72 or 90) IMU features
    (the scaled acc-sum appended if enabled) and the (window, state_dim)
    history."""
    if cfg.with_acc_sum:
        imu_win = torch.cat([imu_win, accsum_win / cst.ACC_SUM_DOWN_SCALE],
                            dim=-1)
    return imu_win, s_and_c_win


def pack_dtype(cfg: RunnerConfig, dtype=torch.float32) -> torch.dtype:
    """Packing dtype of the runner's fused path: ``compute_dtype`` when it
    is set; else bfloat16 for the windowed forward, and the carry's
    ``dtype`` for the cached modes, whose rings are stored in it (K7 takes
    weights and rings of one dtype)."""
    if cfg.model.compute_dtype is not None:
        return getattr(torch, cfg.model.compute_dtype)
    return dtype if cfg.cached else torch.bfloat16


def pack_fused_weights(model: M.TIPModel, cfg: RunnerConfig,
                       dtype=torch.float32):
    """The fused kernel's weights in the dtype the runner's fused path uses
    with a carry of ``dtype`` (None unless ``forward_impl="fused"``). Pass
    the result as ``packed_ws`` to ``runner_step`` so that a frame does
    not look the pack up in the model (``TIPModel.packed_weights`` walks
    every parameter to see that none changed)."""
    if cfg.model.forward_impl != "fused":
        return None
    return model.packed_weights(pack_dtype(cfg, dtype))


def _cached_forward(model: M.TIPModel, carry: RunnerCarry, x_token,
                    cfg: RunnerConfig, tick, packed_ws):
    """The newest token through the cached step of the mode: kernel K7 (or
    its plain version on the CPU) with ``forward_impl="fused"``, else the
    plain cached step; returns y_t and updates ``carry.cache`` in place.
    The cursor is the global ``tick`` when given, else the stream's own
    count of smoothed frames. The frame counts (``commit=True``): frames
    before the first smoothed one never get here."""
    rnn_carry = cfg.serving_mode == "kv_cache_rnn_carry"
    if cfg.model.forward_impl == "fused":
        if packed_ws is None:
            packed_ws = pack_fused_weights(model, cfg, carry.cache.enc.dtype)
        slot = (tick if tick is not None else carry.k) % cfg.window
        return SC.fused_cached_step_slot(
            packed_ws, carry.cache, x_token.to(torch.float32), slot, True,
            cfg.model, rnn_carry=rnn_carry)[1]
    return SC.cached_forward_step(
        model, carry.cache, x_token, carry.k, cfg.model, rnn_carry=rnn_carry,
        slot_override=tick, commit=True)[1]


@torch.no_grad()
def sense_and_predict(model: M.TIPModel, carry: RunnerCarry, cur_imu,
                      cfg: RunnerConfig, packed_ws=None,
                      tick=None) -> SensedFrame:
    """Stages 1-5: raw-ring smoothing, local features + acc-sum, model
    forward, output filter, state assembly. Returns (buffer updates…,
    active flag, assembled s_t, SBP vector c_t). ``packed_ws``: the fused
    forward's pre-packed weights (``pack_fused_weights``).

    tick: optional host int, a GLOBAL tick for the KV-cache modes: the
    cursor of the acc ring, the output ring and the cache rings instead of
    the stream's own counters, so that every stream of a pool writes the
    same slot (ignored in recompute mode)."""
    dtype = carry.imu_win.dtype
    dev = carry.imu_win.device
    cur_imu = torch.as_tensor(cur_imu, dtype=dtype, device=dev)
    W = cfg.window

    # ---- 1. raw ring + smoothing ---------------------------------------------
    if carry.t == 0:
        raw = cur_imu.expand(carry.raw_imu.shape).clone()
    else:
        raw = torch.cat([carry.raw_imu[1:], cur_imu[None]], dim=0)
    # a smoothed frame is available from t >= imu_n_smooth; before it the
    # model has no input and nothing but the raw ring moves
    if carry.t < cfg.imu_n_smooth:
        return SensedFrame((raw, carry.k, carry.imu_win, carry.accsum_win,
                            carry.acc_runsum, carry.out_buf, carry.n_out,
                            False, None, None))
    ori = raw[cfg.imu_n_smooth, :54]                  # 5-frame-delayed
    acc = torch.mean(raw[:, 54:72], dim=0)            # 11-frame average

    # ---- 2. per-frame local features + acc-sum -------------------------------
    local = imu_ops.imu_rotate_to_local(torch.cat([ori, acc])[None])[0]
    runsum = carry.acc_runsum + local[54:72]
    k_new = carry.k + 1
    if cfg.cached:
        # circular acc ring: the only window read the cached modes need is
        # the 40-frame-old acc leaving the running sum. Either cursor walks
        # consecutive slots, so the row at the cursor before the write is
        # the entry W pushes ago
        evicted, imu_win, _ = _ring_push(
            carry.imu_win, tick if tick is not None else carry.k,
            local[54:72])
        if carry.k >= W:
            runsum = runsum - evicted
        accsum_win = None

        # ---- 3. model forward: the newest token against the cache --------------
        parts = [local]
        if cfg.with_acc_sum:
            parts.append(runsum / cst.ACC_SUM_DOWN_SCALE)
        x_token = torch.cat(parts + [carry.s_and_c_win])
        y_t = _cached_forward(model, carry, x_token, cfg, tick,
                              packed_ws).to(dtype)
    else:
        if carry.k >= W:                              # oldest acc leaves
            runsum = runsum - carry.imu_win[0, 54:72]
        imu_win = _push_left_aligned(carry.imu_win, carry.k, local, W)
        accsum_win = _push_left_aligned(carry.accsum_win, carry.k, runsum, W)

        # ---- 3. model forward over the window -----------------------------------
        x_imu, x_s = model_window(cfg, imu_win, accsum_win,
                                  carry.s_and_c_win)
        last_idx = min(k_new, W) - 1             # last valid row
        if cfg.model.forward_impl == "fused":
            # the whole model as one kernel, emitting that row only
            if packed_ws is None:
                packed_ws = pack_fused_weights(model, cfg)
            x_full =torch.cat([x_imu, x_s], dim=-1).to(torch.float32)
            y_t = FF.fused_forward_last(packed_ws, x_full, last_idx,
                                        cfg.model).to(dtype)
        else:
            y_t = model(x_imu[None], x_s[None])[0, last_idx]  # (state_dim,)

    # ---- 4. output filter + decode (kernel K2) ---------------------------------
    if cfg.cached:
        # circular: one row written; the filter reads the ring oldest to
        # newest, so its sum keeps the recompute mode's order
        nf = cfg.filter_len
        _, out_buf, oslot = _ring_push(
            carry.out_buf, tick if tick is not None else carry.n_out, y_t)
        filt_view = out_buf[device_const(
            tuple((oslot + 1 + i) % nf for i in range(nf)), torch.int64, dev)]
    else:
        out_buf = torch.cat([carry.out_buf[1:], y_t[None]], dim=0)
        filt_view = out_buf
    n_out = carry.n_out + 1
    dec = FT.decode_fused(y_t, filt_view, _filter_coeff(cfg, dtype, dev),
                          n_out >= cfg.filter_len, local[:9],
                          filter_len=cfg.filter_len, n_sbps=cfg.n_sbps,
                          impl=cfg.resolved_tail_impl(dev.type))
    y_f = dec.y_f
    c_t = dec.c_t.reshape(-1)
    # quat -> axis-angle stays outside the kernel, as in tip_tpu
    aa18 = rot.q_to_aa(dec.q_rows)              # row 0: root ori from IMU0

    # ---- 5. state assembly -----------------------------------------------------
    root_v = y_f[108:111]
    s_t = torch.cat([carry.prev_root + root_v * cfg.dt, aa18.reshape(54),
                     root_v, torch.zeros(cst.N_DOFS - 3, dtype=dtype,
                                         device=dev)])
    if carry.n_out >= 1:                     # last_s was a real frame
        s_t = torch.cat([s_t[:6], (s_t[6:] + carry.last_s[6:]) / 2.0])
    return SensedFrame((raw, k_new, imu_win, accsum_win, runsum, out_buf,
                        n_out, True, s_t, c_t))


def _fk(cfg: RunnerConfig, skel: kin.Skeleton, s_t):
    """Pose -> (CoM frames, joint frames) by ``fk_impl``."""
    if cfg.fk_impl == "plain":
        return kin.fk_our_state(skel, s_t, return_joint_frame=True)
    return kin.fk_bullet_fused(skel, kin.our_pose_to_bullet(s_t),
                               impl=cfg.fk_impl)


def _tail(cfg: RunnerConfig, skel: kin.Skeleton, s_t, c_t,
          prev_pq) -> FT.TailOut:
    """Stages 6-7's FK + SBP root-correction inputs + 6D history encode:
    vel_res is the clipped mean feet residue BEFORE the z fix, c_locs the
    world SBP positions before the -vel_res*dt shift. ``tail_impl="plain"``
    runs the plain ops with the FK of ``fk_impl`` and leaves ``hist_sixd``
    None (the caller encodes the history with ``state_to_history``, which
    never reads the root position the correction moves); otherwise kernel
    K3, or its plain version where ``resolved_tail_impl`` says "plain"
    (CPU tensors, or an SBP count other than 5)."""
    if cfg.tail_impl != "plain":
        return FT.tail_fused(skel, s_t, c_t, prev_pq, dt=cfg.dt,
                             impl=cfg.resolved_tail_impl(s_t.device.type),
                             n_sbps=cfg.n_sbps)
    pq_com, pq_jf = _fk(cfg, skel, s_t)
    corr = sbp_ops.root_correction_from_constrs(
        prev_pq, pq_com, c_t, n_sbps=cfg.n_sbps,
        use_n_sbps=min(5, cfg.n_sbps), dt=cfg.dt)
    return FT.TailOut(pq_com=pq_com, pq_jf=pq_jf, hist_sixd=None,
                      vel_res=corr.vel_res, c_locs=corr.c_locs,
                      raw_res=corr.raw_residues,
                      active=corr.active.to(s_t.dtype))


@torch.no_grad()
def runner_step(model: M.TIPModel, carry: RunnerCarry, cur_imu,
                cfg: RunnerConfig, skel: kin.Skeleton, packed_ws=None,
                tick=None):
    """One 60 Hz frame of the minimal runner (flat-ground assumption).
    ``packed_ws``: the fused forward's pre-packed weights
    (``pack_fused_weights``), else looked up in the model each frame.
    ``tick``: a global ring cursor for the KV-cache modes
    (``sense_and_predict``). Runs without autograd, so a model that
    requires grad (a training state's) serves as it is. Returns (carry',
    dict(qdq, viz_locs, ct))."""
    (raw, k_new, imu_win, accsum_win, acc_runsum, out_buf, n_out, active,
     s_t, c_t) = sense_and_predict(model, carry, cur_imu, cfg, packed_ws,
                                   tick)
    if not active:
        # warmup: return s_init, freeze the state
        new_carry = replace(carry, t=carry.t + 1, raw_imu=raw)
        return new_carry, {
            "qdq": carry.s_init,
            "viz_locs": torch.full_like(carry.c_locs, 100.0),
            "ct": torch.zeros(cfg.n_sbps * 4, dtype=carry.s_init.dtype,
                              device=carry.s_init.device)}

    # ---- 6. FK + SBP root correction (kernel K3) ---------------------------
    to = _tail(cfg, skel, s_t, c_t, carry.prev_pq)
    # flat-ground assumption: z correction pulls active feet SBPs to z=0
    act = to.active > 0.5
    zero = torch.zeros((), dtype=s_t.dtype, device=s_t.device)
    z = (torch.where(act[0], to.c_locs[0, 2], zero)
         + torch.where(act[1], to.c_locs[1, 2], zero))
    vel_res = torch.cat([to.vel_res[:2], z[None]])
    shift = vel_res * cfg.dt
    c_locs = to.c_locs - shift[None, :]
    s_t = torch.cat([s_t[:3] - shift, s_t[3:]])
    pq_g = torch.cat([to.pq_com[:, :3] - shift[None, :], to.pq_com[:, 3:]],
                     dim=1)

    # ---- 7. history push ----------------------------------------------------
    if to.hist_sixd is None:
        hist = state_to_history(s_t, c_t, cfg.n_sbps)
    else:
        hist = torch.cat([to.hist_sixd.reshape(108),
                          s_t[cst.N_DOFS:cst.N_DOFS + 3], c_t])
    s_and_c_win = push_history(cfg, carry.s_and_c_win, k_new, hist)

    new_carry = RunnerCarry(
        t=carry.t + 1, raw_imu=raw, k=k_new, imu_win=imu_win,
        accsum_win=accsum_win, acc_runsum=acc_runsum,
        s_and_c_win=s_and_c_win, out_buf=out_buf, n_out=n_out,
        last_s=s_t, prev_pq=pq_g, prev_root=s_t[:3], c_locs=c_locs,
        s_init=carry.s_init, cache=carry.cache)
    return new_carry, {"qdq": s_t, "viz_locs": c_locs, "ct": c_t}


def _check_on(t: torch.Tensor, device: torch.device, what: str):
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(f"{what} is on {t.device}, the run is on {device}: "
                         f"build it there")


def run_offline(model: M.TIPModel, cfg: RunnerConfig, skel: kin.Skeleton,
                s_init, imu_seq, device=None):
    """Stream a recorded IMU sequence through the runner, frame by frame.

    s_traj[0] = s_init, then s_traj[t+1] = step(imu[t]) (offline driver
    loop, reference offline_testing_simple.py:109-155), in the serving mode
    of ``cfg``. The latency trim
    (IMU_n_smooth + 2 frames) is applied by the caller (``trim_latency``).
    Runs on ``device`` (``cuda`` unless the caller asks for another); the
    model and skeleton must already be there, in the dtype of the run.

    Returns (s_traj (T, 114), c_traj (T, n_sbps*4), viz (T, n_sbps, 3)).
    """
    device = resolve_device(device)
    if model.cfg != cfg.model:
        raise ValueError("the model was built for another ModelConfig than "
                         "cfg.model")
    _check_on(next(model.parameters()), device, "the model")
    dtype = next(model.parameters()).dtype
    carry = runner_init(cfg, skel, s_init, dtype=dtype, device=device)
    imu_seq = torch.as_tensor(imu_seq, dtype=dtype, device=device)
    packed_ws = pack_fused_weights(model, cfg, dtype)
    qdq, ct, viz = [carry.s_init], [], []
    with torch.no_grad():
        for t in range(imu_seq.shape[0] - 1):
            carry, out = runner_step(model, carry, imu_seq[t], cfg, skel,
                                     packed_ws)
            qdq.append(out["qdq"])
            ct.append(out["ct"])
            viz.append(out["viz_locs"])
    s_traj = torch.stack(qdq)
    c_traj = torch.stack([torch.zeros_like(carry.s_init[:cfg.n_sbps * 4])]
                         + ct)
    viz = torch.stack([torch.full_like(carry.c_locs, 100.0)] + viz)
    return s_traj, c_traj, viz


def trim_latency(arr, trim: int):
    """Shift predictions earlier by ``trim`` frames, repeating the final frame
    (reference offline_testing_simple.py:148-153). Host-side numpy."""
    arr = np.asarray(arr).copy()
    arr[0:-trim] = arr[trim:]
    arr[-trim:] = arr[-trim - 1]
    return arr


# ---------------------------------------------------------------------------
# a pool of B streams: the batched frame step
# ---------------------------------------------------------------------------

# the tensor leaves of a carry, in RunnerCarry's order (cache apart)
_TENSOR_LEAVES = ("raw_imu", "imu_win", "accsum_win", "acc_runsum",
                  "s_and_c_win", "out_buf", "last_s", "prev_pq", "prev_root",
                  "c_locs", "s_init")
_COUNTERS = ("t", "k", "n_out")


@dataclass
class PoolCarry:
    """The stacked carry of a pool: every tensor leaf of ``RunnerCarry``
    with a leading stream axis B (``cache`` a pool's ``KVCache``), and the
    three counters per stream as (B,) int64 arrays on the host. ``pool_step``
    returns a new carry and leaves the old one's tensors as they were,
    except ``cache``, whose rings are updated in place."""
    t: np.ndarray
    raw_imu: torch.Tensor
    k: np.ndarray
    imu_win: torch.Tensor
    accsum_win: Optional[torch.Tensor]
    acc_runsum: torch.Tensor
    s_and_c_win: torch.Tensor
    out_buf: torch.Tensor
    n_out: np.ndarray
    last_s: torch.Tensor
    prev_pq: torch.Tensor
    prev_root: torch.Tensor
    c_locs: torch.Tensor
    s_init: torch.Tensor
    cache: Optional[SC.KVCache] = None

    @property
    def n_streams(self) -> int:
        return self.t.shape[0]

    def streams(self, lo: int, hi: int) -> "PoolCarry":
        """Streams lo..hi-1 as a carry of their own (views of the tensors,
        copies of the counters)."""
        kw = {n: getattr(self, n)[lo:hi].copy() for n in _COUNTERS}
        for n in _TENSOR_LEAVES:
            leaf = getattr(self, n)
            kw[n] = None if leaf is None else leaf[lo:hi]
        cache = None if self.cache is None else self.cache.streams(lo, hi)
        return PoolCarry(cache=cache, **kw)


def pool_init(cfg: RunnerConfig, skel: kin.Skeleton, s_inits,
              dtype=torch.float32, device=None) -> PoolCarry:
    """The stacked carry of B streams before their first frames, from
    their initial states s_inits (B, 114), on ``device`` (``cuda`` unless
    the caller asks for another)."""
    device = resolve_device(device)
    s_inits = torch.as_tensor(s_inits, dtype=dtype, device=device)
    if s_inits.dim() != 2:
        raise ValueError(f"s_inits is (B, 114), got {tuple(s_inits.shape)}")
    zero = np.zeros(s_inits.shape[0], np.int64)
    return PoolCarry(t=zero.copy(), k=zero.copy(), n_out=zero.copy(),
                     **_init_leaves(cfg, skel, s_inits, dtype, device))


def pool_write_slot(carries: PoolCarry, slot: int, fresh: RunnerCarry):
    """Write one stream's carry into slot ``slot`` of a pool's, in place
    (a stream joins, or restarts)."""
    for n in _COUNTERS:
        getattr(carries, n)[slot] = getattr(fresh, n)
    for n in _TENSOR_LEAVES:
        leaf = getattr(carries, n)
        if leaf is not None:
            leaf[slot] = getattr(fresh, n)
    if carries.cache is not None:
        for n in SC._LEAVES:
            getattr(carries.cache, n)[slot] = getattr(fresh.cache, n)


def join_carries(parts, cache=None) -> PoolCarry:
    """Carries of consecutive stream ranges (``PoolCarry.streams``) as one
    again; ``cache``: the whole pool's cache, of which the parts' caches
    are views."""
    kw = {n: np.concatenate([getattr(c, n) for c in parts])
          for n in _COUNTERS}
    for n in _TENSOR_LEAVES:
        leaves = [getattr(c, n) for c in parts]
        kw[n] = None if leaves[0] is None else torch.cat(leaves)
    return PoolCarry(cache=cache, **kw)


def pool_carry_from_jax(carry, dtype=None, device="cpu") -> PoolCarry:
    """A stacked tip_tpu ``RunnerCarry`` (every leaf with a leading stream
    axis; numpy arrays, or anything ``numpy.asarray`` takes, by attribute or
    by key) as a pool's carry of this module, so that both pools can go on
    from one mid-session state. Floating leaves are cast to ``dtype`` when
    it is given (bfloat16 leaves arrive as float32 arrays); the cache rings
    keep the dtype they come in."""
    def get(node, name):
        return node[name] if isinstance(node, dict) else getattr(node, name)

    def tensor(a, cast=True):
        t = torch.as_tensor(np.array(a)).to(device)
        return t.to(dtype) if cast and dtype is not None \
            and t.is_floating_point() else t

    kw = {n: np.array(get(carry, n), np.int64).reshape(-1)
          for n in _COUNTERS}
    for n in _TENSOR_LEAVES:
        leaf = get(carry, n)
        kw[n] = None if leaf is None else tensor(leaf)
    jc = get(carry, "cache")
    cache = None
    if jc is not None:
        cache = SC.KVCache(*(tensor(get(jc, n), cast=False)
                             for n in SC._LEAVES))
    return PoolCarry(cache=cache, **kw)


def _pool_counters(cfg: RunnerConfig, carries: PoolCarry):
    """What the host counters say about this tick, per stream (numpy):
    have (a smoothed frame: the commit), k_new, active (the model's output
    counts) and k_last (the window row the recompute forward reads)."""
    have = carries.t >= cfg.imu_n_smooth
    k_new = carries.k + have
    active = k_new >= 1
    # the port's clamp: the last valid row is min(k_new, W) - 1, and row 0
    # for a stream with no frame yet
    k_last = np.where(active, np.minimum(k_new, cfg.window) - 1, 0)
    return have, k_new, active, k_last


def _pool_masks(cfg: RunnerConfig, carries: PoolCarry, dev):
    """What the host counters say about this tick, per stream: the new
    counters, and two small tensors on ``dev`` (one copy up each, nothing
    read back): bool rows [first frame, smoothed frame (the commit), window
    full, active, filter on, blend] and int64 rows [imu push shift, imu
    push position, history push shift, history push position, last valid
    window row]."""
    t, k, n_out = carries.t, carries.k, carries.n_out
    W = cfg.window
    have, k_new, active, k_last = _pool_counters(cfg, carries)
    n_out_new = n_out + active
    flags = np.stack([t == 0, have, k >= W, active,
                      n_out_new >= cfg.filter_len, n_out >= 1])
    idx = np.stack([have & (k >= W), np.minimum(k, W - 1),
                    active & (k_new >= W), np.minimum(k_new, W - 1),
                    k_last]).astype(np.int64)
    return (k_new, n_out_new, k_last,
            torch.as_tensor(flags).to(dev, non_blocking=True),
            torch.as_tensor(idx).to(dev, non_blocking=True))


def _rows(n: int, dev) -> torch.Tensor:
    return device_const(tuple(range(n)), torch.int64, dev)


def _push_left_aligned_batch(win, shift, pos, x, gate):
    """``_push_left_aligned`` per stream: win (B, W, C); a stream whose
    ``shift`` is set moves its rows one to the left; then row ``pos`` takes
    x (B, C) where ``gate`` is set. shift, pos: (B,) int64; gate: (B,)
    bool."""
    B, W, C = win.shape
    src = torch.clamp(_rows(W, win.device)[None, :] + shift[:, None],
                      max=W - 1)
    out = torch.gather(win, 1, src[:, :, None].expand(B, W, C))
    rows = _rows(B, win.device)
    out[rows, pos] = torch.where(gate[:, None], x, out[rows, pos])
    return out


def _ring_push_batch(buf, slot: int, new_rows, gate):
    """``_ring_push`` for a pool at one global slot: returns (the old rows
    at the slot, a copy of buf (B, R, C) whose row ``slot`` is new_rows
    where ``gate`` (B,) is set)."""
    old = buf[:, slot]
    out = buf.clone()
    out[:, slot] = torch.where(gate[:, None], new_rows, old)
    return old, out


@torch.no_grad()
def pool_step(model: M.TIPModel, carries: PoolCarry, imu_batch,
              cfg: RunnerConfig, skel: kin.Skeleton, tick=None,
              packed_ws=None):
    """One 60 Hz tick of the minimal runner for every stream of a pool:
    ``runner_step`` written out over a leading stream axis B, each stream at
    its own frame count (a stream joins a running pool with a fresh slot of
    the carry). imu_batch: (B, 72). ``tick``: the pool's global tick, a host
    int — the ring cursor of the KV-cache modes (required there, ignored in
    recompute mode). ``packed_ws``: ``pack_fused_weights``' result for a
    carry of this dtype, required with ``forward_impl="fused"`` (packed once
    by whoever owns the pool; a tick never looks the pack up in the model).

    A stream that has no smoothed frame yet returns its ``s_init``, 100s
    and zeros and keeps its carry but for ``t`` and the raw ring (its rows
    run through the model all the same and are dropped by a select).
    Runs without autograd, as ``runner_step``. Returns (carries', {"qdq" (B, 114), "viz_locs" (B, n_sbps, 3), "ct" (B,
    n_sbps*4)})."""
    dtype = carries.raw_imu.dtype
    dev = carries.raw_imu.device
    imu = torch.as_tensor(imu_batch, dtype=dtype, device=dev)
    B, W = carries.n_streams, cfg.window
    if tuple(imu.shape) != (B, cst.IMU_DIM):
        raise ValueError(f"imu_batch is ({B}, {cst.IMU_DIM}) for this pool, "
                         f"got {tuple(imu.shape)}")
    if cfg.cached and tick is None:
        raise ValueError("a pool's KV-cache modes write every stream at one "
                         "global ring cursor: pass the pool's tick")
    if cfg.model.forward_impl == "fused" and packed_ws is None:
        raise ValueError('forward_impl="fused" takes the packed weights: pass '
                         "packed_ws=pack_fused_weights(model, cfg, dtype)")
    k_new, n_out_new, k_last, flags, idx = _pool_masks(cfg, carries, dev)
    first, have, win_full, active, use_filter, has_last = flags
    col = [m[:, None] for m in flags]        # (B, 1) forms of the masks

    # ---- 1. raw ring + smoothing ---------------------------------------------
    raw = torch.where(col[0][:, :, None],
                      imu[:, None, :].expand(carries.raw_imu.shape),
                      torch.cat([carries.raw_imu[:, 1:], imu[:, None]], dim=1))
    ori = raw[:, cfg.imu_n_smooth, :54]
    acc = torch.mean(raw[:, :, 54:72], dim=1)

    # ---- 2. per-frame local features + acc-sum -------------------------------
    local = imu_ops.imu_rotate_to_local(torch.cat([ori, acc], dim=1))
    acc_local = local[:, 54:72]
    if cfg.cached:
        slot = int(tick) % W
        # the row under the cursor of a freshly joined slot is whatever the
        # fresh carry holds: it leaves the sum only for a stream whose own
        # window is full
        evicted, imu_win = _ring_push_batch(carries.imu_win, slot, acc_local,
                                            have)
        accsum_win = None
    else:
        evicted = carries.imu_win[:, 0, 54:72]
    runsum = carries.acc_runsum + acc_local \
        - torch.where(col[2], evicted, torch.zeros_like(evicted))
    acc_runsum = torch.where(col[1], runsum, carries.acc_runsum)

    # ---- 3. model forward ------------------------------------------------------
    if cfg.cached:
        parts = [local]
        if cfg.with_acc_sum:
            parts.append(runsum / cst.ACC_SUM_DOWN_SCALE)
        x_tokens = torch.cat(parts + [carries.s_and_c_win], dim=1)
        rnn_carry = cfg.serving_mode == "kv_cache_rnn_carry"
        if cfg.model.forward_impl == "fused":
            y_t = SC.fused_cached_batch(
                packed_ws, carries.cache, x_tokens.to(torch.float32), slot,
                have, cfg.model, rnn_carry=rnn_carry)[1]
        else:
            y_t = SC.cached_forward_step_batch(
                model, carries.cache, x_tokens, slot, have, cfg.model,
                rnn_carry=rnn_carry)[1]
        y_t = y_t.to(dtype)
    else:
        imu_win = _push_left_aligned_batch(carries.imu_win, idx[0], idx[1],
                                           local, have)
        accsum_win = _push_left_aligned_batch(carries.accsum_win, idx[0],
                                              idx[1], runsum, have)
        x_imu, x_s = model_window(cfg, imu_win, accsum_win,
                                  carries.s_and_c_win)
        if cfg.model.forward_impl == "fused":
            x_full = torch.cat([x_imu, x_s], dim=-1).to(torch.float32)
            y_t = FF.fused_recompute_batch(packed_ws, x_full, k_last,
                                           cfg.model).to(dtype)
        else:
            y_t = model(x_imu, x_s)[_rows(B, dev), idx[4]]

    # ---- 4. output filter + decode (kernel K2) ---------------------------------
    if cfg.cached:
        nf = cfg.filter_len
        oslot = int(tick) % nf
        _, out_buf = _ring_push_batch(carries.out_buf, oslot, y_t, active)
        filt_view = out_buf[:, device_const(
            tuple((oslot + 1 + i) % nf for i in range(nf)), torch.int64, dev)]
    else:
        out_buf = torch.where(
            col[3][:, :, None],
            torch.cat([carries.out_buf[:, 1:], y_t[:, None]], dim=1),
            carries.out_buf)
        filt_view = out_buf
    dec = FT.decode_fused(y_t, filt_view, _filter_coeff(cfg, dtype, dev),
                          use_filter, local[:, :9].contiguous(),
                          filter_len=cfg.filter_len, n_sbps=cfg.n_sbps,
                          impl=cfg.resolved_tail_impl(dev.type))
    y_f = dec.y_f
    c_t = dec.c_t.reshape(B, -1)
    aa18 = rot.q_to_aa(dec.q_rows)              # row 0: root ori from IMU0

    # ---- 5. state assembly -----------------------------------------------------
    root_v = y_f[:, 108:111]
    s_t = torch.cat([carries.prev_root + root_v * cfg.dt,
                     aa18.reshape(B, 54), root_v,
                     torch.zeros((B, cst.N_DOFS - 3), dtype=dtype,
                                 device=dev)], dim=1)
    blended = torch.cat([s_t[:, :6],
                         (s_t[:, 6:] + carries.last_s[:, 6:]) / 2.0], dim=1)
    s_t = torch.where(col[5], blended, s_t)

    # ---- 6. FK + SBP root correction (kernel K3) ---------------------------
    to = _tail(cfg, skel, s_t, c_t, carries.prev_pq)
    act = to.active > 0.5
    zero = torch.zeros((), dtype=dtype, device=dev)
    z = (torch.where(act[:, 0], to.c_locs[:, 0, 2], zero)
         + torch.where(act[:, 1], to.c_locs[:, 1, 2], zero))
    vel_res = torch.cat([to.vel_res[:, :2], z[:, None]], dim=1)
    shift = vel_res * cfg.dt
    c_locs = to.c_locs - shift[:, None, :]
    s_t = torch.cat([s_t[:, :3] - shift, s_t[:, 3:]], dim=1)
    pq_g = torch.cat([to.pq_com[:, :, :3] - shift[:, None, :],
                      to.pq_com[:, :, 3:]], dim=2)

    # ---- 7. history push ----------------------------------------------------
    if to.hist_sixd is None:
        hist = state_to_history(s_t, c_t, cfg.n_sbps)
    else:
        hist = torch.cat([to.hist_sixd.reshape(B, 108),
                          s_t[:, cst.N_DOFS:cst.N_DOFS + 3], c_t], dim=1)
    if cfg.cached:
        s_and_c_win = torch.where(col[3], hist, carries.s_and_c_win)
    else:
        s_and_c_win = _push_left_aligned_batch(carries.s_and_c_win, idx[2],
                                               idx[3], hist, active)

    # ---- outputs and carry: a stream with no frame yet keeps its state ------
    new_carries = PoolCarry(
        t=carries.t + 1, raw_imu=raw, k=k_new, imu_win=imu_win,
        accsum_win=accsum_win, acc_runsum=acc_runsum,
        s_and_c_win=s_and_c_win, out_buf=out_buf, n_out=n_out_new,
        last_s=torch.where(col[3], s_t, carries.last_s),
        prev_pq=torch.where(col[3][:, :, None], pq_g, carries.prev_pq),
        prev_root=torch.where(col[3], s_t[:, :3], carries.prev_root),
        c_locs=torch.where(col[3][:, :, None], c_locs, carries.c_locs),
        s_init=carries.s_init, cache=carries.cache)
    return new_carries, {
        "qdq": torch.where(col[3], s_t, carries.s_init),
        "viz_locs": torch.where(col[3][:, :, None], c_locs,
                                torch.full_like(c_locs, 100.0)),
        "ct": torch.where(col[3], c_t, torch.zeros_like(c_t))}


def make_multi_stream_step(cfg: RunnerConfig, skel: kin.Skeleton,
                           packed_ws=None):
    """The batched runner step that serves many IMU streams on one card
    (twin of tip_tpu's ``make_multi_stream_step``, whose ``vmap`` is
    ``pool_step`` here).

    ``packed_ws``: ``pack_fused_weights(model, cfg, dtype)`` of the model
    and carry dtype the step will be given, required with
    ``forward_impl="fused"``; it is bound here, once, as ``StreamPool``
    binds its own.

    Returns step(model, carries, imu_batch, tick) -> (carries', outputs)
    with ``carries`` a ``PoolCarry`` (``pool_init``), imu_batch (B, 72) and
    ``tick`` a host int, the global counter shared by all streams (the
    KV-cache ring cursor; ignored in recompute mode)."""
    if cfg.model.forward_impl == "fused" and packed_ws is None:
        raise ValueError('forward_impl="fused" takes the packed weights: pass '
                         "packed_ws=pack_fused_weights(model, cfg, dtype)")

    def step(model, carries, imu_batch, tick):
        with torch.no_grad():
            return pool_step(model, carries, imu_batch, cfg, skel, tick=tick,
                             packed_ws=packed_ws)

    return step
