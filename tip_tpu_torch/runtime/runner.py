"""Streaming inference runtime: the single-stream minimal runner in its
three serving modes (twin of tip_tpu/runtime/runner.py).

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
    # needs CUDA tensors; "plain" runs their plain PyTorch versions; "auto"
    # is fused on a CUDA device and plain on the CPU. K3 takes the 5-SBP
    # layout only: another SBP count on the card needs "plain"
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
    vector."""
    aa = s[3:3 + 54].reshape(18, 3)
    sixd = rot.aa_to_sixd(aa).reshape(108)
    root_v = s[cst.N_DOFS:cst.N_DOFS + 3]
    return torch.cat([sixd, root_v, c])


def runner_init(cfg: RunnerConfig, skel: kin.Skeleton, s_init,
                dtype=torch.float32, device=None) -> RunnerCarry:
    """The carry before the first frame, on ``device`` (``cuda`` unless the
    caller asks for another)."""
    device = resolve_device(device)
    _check_on(skel.joint_offset, device, "skeleton")
    s_init = torch.as_tensor(s_init, dtype=dtype, device=device)
    sd = cfg.state_dim
    hist0 = state_to_history(
        s_init, torch.zeros(cfg.n_sbps * 4, dtype=dtype, device=device),
        cfg.n_sbps)
    pq0 = kin.fk_our_state(skel, s_init)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.cached:
        cache = SC.cache_init(cfg.model, cfg.window, dtype, device)
        imu_win = zeros(cfg.window, cst.ACC_SUM_DIM)
        accsum_win = None
        s_and_c = hist0
    else:
        cache = None
        imu_win = zeros(cfg.window, cst.IMU_DIM)
        accsum_win = zeros(cfg.window, cst.ACC_SUM_DIM)
        s_and_c = zeros(cfg.window, sd)
        s_and_c[0] = hist0
    return RunnerCarry(
        cache=cache,
        t=0,
        raw_imu=zeros(cfg.smooth_win, cst.IMU_DIM),
        k=0,
        imu_win=imu_win,
        accsum_win=accsum_win,
        acc_runsum=zeros(cst.ACC_SUM_DIM),
        s_and_c_win=s_and_c,
        out_buf=zeros(cfg.filter_len, sd),
        n_out=0,
        last_s=s_init,
        prev_pq=pq0.to(dtype),
        prev_root=s_init[:3],
        c_locs=torch.full((cfg.n_sbps, 3), 100.0, dtype=dtype, device=device),
        s_init=s_init,
    )


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
            x_full = torch.cat([x_imu, x_s], dim=-1).to(torch.float32)
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
                          impl=cfg.tail_impl)
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
    K3, or its plain version for CPU tensors."""
    if cfg.tail_impl != "plain":
        return FT.tail_fused(skel, s_t, c_t, prev_pq, dt=cfg.dt,
                             impl=cfg.tail_impl, n_sbps=cfg.n_sbps)
    pq_com, pq_jf = _fk(cfg, skel, s_t)
    corr = sbp_ops.root_correction_from_constrs(
        prev_pq, pq_com, c_t, n_sbps=cfg.n_sbps,
        use_n_sbps=min(5, cfg.n_sbps), dt=cfg.dt)
    return FT.TailOut(pq_com=pq_com, pq_jf=pq_jf, hist_sixd=None,
                      vel_res=corr.vel_res, c_locs=corr.c_locs,
                      raw_res=corr.raw_residues,
                      active=corr.active.to(s_t.dtype))


def runner_step(model: M.TIPModel, carry: RunnerCarry, cur_imu,
                cfg: RunnerConfig, skel: kin.Skeleton, packed_ws=None,
                tick=None):
    """One 60 Hz frame of the minimal runner (flat-ground assumption).
    ``packed_ws``: the fused forward's pre-packed weights
    (``pack_fused_weights``), else looked up in the model each frame.
    ``tick``: a global ring cursor for the KV-cache modes
    (``sense_and_predict``). Returns (carry', dict(qdq, viz_locs, ct))."""
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
