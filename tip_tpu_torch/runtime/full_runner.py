"""Full streaming runner: terrain estimation + SBP-conditioned leg IK (twin
of tip_tpu/runtime/full_runner.py).

The reference's ``RTRunner``, built on the minimal runner's sensing and
prediction front-end (``runner.sense_and_predict``) and its tail
(``runner._tail``: kernel K3, or the plain ops). Per frame, beyond the
minimal runner:

  * the root z correction comes from the terrain height-region maps instead
    of the flat-ground SBP heights;
  * each foot SBP runs an "establishing phase" tick counter before its
    height is committed to the map;
  * optionally (``multi_sbp``) the pelvis SBP also feeds the terrain when
    far from the feet, and accumulated per-leg velocity residues drive
    analytic two-joint IK corrections written into the autoregressive
    *history* only — feedback, not display;
  * a ground-truth playback mode substitutes (s_gt, c_gt) for the model
    while still running FK, SBP and terrain.

As in the minimal runner, the frame counters are host ints and ``active``
is a host bool; everything the data decides (the establishing ticks, the
terrain updates and allocations, the IK's gates, the z correction) stays on
the device behind ``torch.where``, so a frame reads nothing back.
"""

from dataclasses import dataclass, replace

import numpy as np
import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch import device_const, resolve_device
from tip_tpu_torch.chars.amass import IK_CHAIN_BULLET, IK_CHAIN_NIMBLE
from tip_tpu_torch.models import tip_model as M
from tip_tpu_torch.ops import ik as ik_ops
from tip_tpu_torch.ops import kinematics as kin
from tip_tpu_torch.ops import rotations as rot
from tip_tpu_torch.runtime import terrain as terrain_lib
from tip_tpu_torch.runtime.runner import (RunnerCarry, RunnerConfig, _check_on,
                                          _tail, pack_fused_weights,
                                          push_history, runner_init,
                                          sense_and_predict, state_to_history)

# SBP order: lankle, rankle, lwrist, rwrist, root (chars.amass.SBP_LINKS)
_TICK_LINKS = (0, 1, 4)     # lankle, rankle, root carry establishing ticks

# the two leg chains of the IK feedback, corrected together
_IK_LEG_LINKS = tuple(tuple(int(i) + 1 for i in IK_CHAIN_BULLET[s])
                      for s in ("lankle", "rankle"))          # (2, 4) pq rows
_IK_LEG_JOINTS = np.array([IK_CHAIN_NIMBLE["lankle"],
                           IK_CHAIN_NIMBLE["rankle"]])        # (2, 3)
# state channels rewritten: 3 + j*3 + {0,1,2} per (side, joint)
_IK_WRITE_IDX = tuple(int(i) for i in (
    (3 + _IK_LEG_JOINTS * 3)[:, :, None] + np.arange(3)).reshape(-1))
# the rows of the 18-row history encode those joints take
_IK_HIST_ROWS = tuple(int(j) for j in _IK_LEG_JOINTS.reshape(-1))


@dataclass(frozen=True)
class FullRunnerConfig:
    base: RunnerConfig = RunnerConfig()
    terrain: terrain_lib.TerrainConfig = terrain_lib.TerrainConfig()
    multi_sbp: bool = False           # terrain-from-root + IK feedback
    playback_gt: bool = False

    def __post_init__(self):
        # the multi-SBP paths read the root SBP at slot 4
        if self.multi_sbp and self.base.n_sbps < 5:
            raise ValueError(
                f"multi_sbp needs the 5-SBP model (root SBP at slot 4); "
                f"got n_sbps={self.base.n_sbps}")


@dataclass
class FullCarry:
    base: RunnerCarry
    terrain: terrain_lib.TerrainState
    ticks: torch.Tensor         # (3,) int64 for (lankle, rankle, root); -1 idle
    ik_deltas: torch.Tensor     # (2, 3) accumulated targets (lankle, rankle)
    c_locs_prev: torch.Tensor   # (n_sbps, 3)


def full_runner_init(cfg: FullRunnerConfig, skel: kin.Skeleton, s_init,
                     dtype=torch.float32, device=None) -> FullCarry:
    """The carry before the first frame, on ``device`` (``cuda`` unless the
    caller asks for another)."""
    device = resolve_device(device)
    return FullCarry(
        base=runner_init(cfg.base, skel, s_init, dtype, device),
        terrain=terrain_lib.terrain_init(cfg.terrain, dtype, device),
        ticks=torch.full((3,), -1, dtype=torch.int64, device=device),
        ik_deltas=torch.zeros((2, 3), dtype=dtype, device=device),
        c_locs_prev=torch.full((cfg.base.n_sbps, 3), 100.0, dtype=dtype,
                               device=device))


def _active(locs):
    """An SBP location is real (not the 100s of an inactive one)."""
    return torch.linalg.vector_norm(locs, dim=-1) < 100.0


def _update_ticks(ticks, c_locs, c_locs_prev):
    """Establishing-phase countdown (the reference's
    update_sbp_establishing_height_ticks). A layout of fewer than 5 SBPs
    reads its last SBP for the root's slot, as tip_tpu's clamped gather
    does (the root's tick is then never used)."""
    n = c_locs.shape[0]
    idx = device_const(tuple(min(i, n - 1) for i in _TICK_LINKS),
                       torch.int64, c_locs.device)
    active_now = _active(c_locs[idx])
    active_prev = _active(c_locs_prev[idx])
    t = torch.where(ticks >= 0, ticks - 1, ticks)
    # contact just ended -> finalize immediately
    return torch.where((~active_now) & active_prev & (ticks >= 0),
                       torch.zeros_like(t), t)


def _ik_history_feedback(s_hist, pq_jf, raw_residues, ik_deltas, dt):
    """Two-joint leg IK for BOTH ankles writing into the history state (the
    reference's correct_joint_q_for_history_feedback). The reference
    corrects the legs one after the other; the computations are
    independent (disjoint joints and delta rows), so both run as one
    batched IK, as in tip_tpu. Returns (s_hist, new deltas, the written
    (2, 3, 3) axis-angles)."""
    dev = s_hist.device
    root_res = raw_residues[4]
    sbp_res = raw_residues[:2]                                  # (2, 3)
    both = (~torch.any(torch.isnan(sbp_res), dim=1)) \
        & (~torch.any(torch.isnan(root_res)))

    delta = ik_deltas + torch.where(
        both[:, None],
        (torch.nan_to_num(sbp_res) - torch.nan_to_num(root_res)[None, :])
        * dt, torch.zeros_like(sbp_res))
    corr = -delta
    n = torch.linalg.vector_norm(corr, dim=1)
    overflow = n > 0.5
    apply_ik = both & (~overflow) & (n > 0.05)

    quads = pq_jf[device_const(_IK_LEG_LINKS, torch.int64, dev)]  # (2, 4, 7)
    a_q, b_q, c_q = ik_ops.leg_two_joint_ik_keep_foot(
        quads[:, 0], quads[:, 1], quads[:, 2], quads[:, 3], corr)
    aa = rot.q_to_aa(torch.stack([a_q, b_q, c_q], dim=1).reshape(6, 4)) \
        .reshape(2, 3, 3)

    idx = device_const(_IK_WRITE_IDX, torch.int64, dev)
    old = s_hist[idx].reshape(2, 3, 3)
    vals = torch.where(apply_ik[:, None, None], aa, old)
    s_hist = s_hist.index_put((idx,), vals.reshape(-1).to(s_hist.dtype))
    new_deltas = torch.where((both & ~overflow)[:, None], delta,
                             torch.zeros_like(delta))
    return s_hist, new_deltas, vals


@torch.no_grad()
def full_runner_step(model: M.TIPModel, carry: FullCarry, cur_imu,
                     cfg: FullRunnerConfig, skel: kin.Skeleton, s_gt=None,
                     c_gt=None, packed_ws=None):
    """One frame (the reference's RTRunner.step). ``s_gt``/``c_gt``: this
    frame's ground truth under ``playback_gt``. ``packed_ws`` as for
    ``runner.runner_step``. Returns (carry', dict(qdq, viz_locs, ct, upd)):
    ``upd`` the (3,) bool flags of the terrain updates committed this frame
    for (lankle, rankle, root), centered on the previous frame's
    c_locs."""
    b = carry.base
    bcfg = cfg.base
    dtype, dev = b.imu_win.dtype, b.imu_win.device
    n_sbps = bcfg.n_sbps

    (raw, k_new, imu_win, accsum_win, acc_runsum, out_buf, n_out, active,
     s_pred, c_pred) = sense_and_predict(model, b, cur_imu, bcfg, packed_ws)
    if cfg.playback_gt:
        s_t = torch.as_tensor(s_gt, dtype=dtype, device=dev)
        c_t = torch.as_tensor(c_gt, dtype=dtype, device=dev)
        active = True
    else:
        s_t, c_t = s_pred, c_pred
    if not active:
        # warmup: return s_init, freeze the state
        return replace(carry, base=replace(b, t=b.t + 1, raw_imu=raw)), {
            "qdq": b.s_init,
            "viz_locs": torch.full_like(b.c_locs, 100.0),
            "ct": torch.zeros(n_sbps * 4, dtype=dtype, device=dev),
            "upd": torch.zeros(3, dtype=torch.bool, device=dev)}

    # ---- FK + SBP residues (kernel K3, or the plain tail) ----------------
    to = _tail(bcfg, skel, s_t, c_t, b.prev_pq)
    pq_g = to.pq_com
    # terrain, not SBP z, corrects root height
    zero = torch.zeros((), dtype=dtype, device=dev)
    vel_res = torch.cat([to.vel_res[:2], zero[None]])
    c_locs = to.c_locs - vel_res[None, :] * bcfg.dt

    # ---- establishing ticks + terrain updates -----------------------------
    ticks = _update_ticks(carry.ticks, c_locs, carry.c_locs_prev)
    terrain = carry.terrain
    z_corr = zero
    arm, done = [], []
    slots = ((0, 0), (1, 1), (2, 4)) if cfg.multi_sbp else ((0, 0), (1, 1))
    for slot, sbp_idx in slots:
        prev_loc = carry.c_locs_prev[sbp_idx]
        prev_active = _active(prev_loc)
        if slot == 2:
            # the pelvis feeds the terrain when far from the feet
            dist = torch.linalg.vector_norm(
                pq_g[0, :2] - (pq_g[3, :2] + pq_g[6, :2]) / 2.0)
            prev_active = prev_active & (
                dist > cfg.terrain.pelvis_terrain_thres)
        do_update = prev_active & (ticks[slot] == 0)
        arm.append(prev_active & (ticks[slot] < 0))   # start establishing
        done.append(do_update)
        terrain, d = terrain_lib.update_height_map(terrain, cfg.terrain,
                                                   prev_loc, do_update)
        if slot < 2:
            z_corr = z_corr - d * cfg.terrain.height_correction_force
    no = torch.zeros((), dtype=torch.bool, device=dev)
    arm = torch.stack(arm + [no] * (3 - len(arm)))
    done = torch.stack(done + [no] * (3 - len(done)))
    ticks = torch.where(done, torch.full_like(ticks, -1), torch.where(
        arm, torch.full_like(ticks, cfg.terrain.establish_ticks), ticks))
    vel_res = torch.cat([vel_res[:2], (vel_res[2] + z_corr)[None]])

    # ---- IK feedback into history ------------------------------------------
    s_hist = s_t
    ik_deltas = carry.ik_deltas
    ik_vals = None
    if cfg.multi_sbp:
        s_hist, ik_deltas, ik_vals = _ik_history_feedback(
            s_hist, to.pq_jf, to.raw_res, ik_deltas, bcfg.dt)

    # ---- apply root correction (playback skips it) --------------------------
    if not cfg.playback_gt:
        shift = vel_res * bcfg.dt
        s_t = torch.cat([s_t[:3] - shift, s_t[3:]])
        s_hist = torch.cat([s_hist[:3] - shift, s_hist[3:]])
        pq_g = torch.cat([pq_g[:, :3] - shift[None, :], pq_g[:, 3:]], dim=1)

    # ---- history push + carry -------------------------------------------------
    if to.hist_sixd is not None:
        # fused tail: the kernel encoded s_t's rows; only the 6 leg-joint
        # rows the IK feedback may have rewritten need encoding again (the
        # root correction never touches channels the encode reads)
        hist_sixd = to.hist_sixd
        if ik_vals is not None:
            rows = device_const(_IK_HIST_ROWS, torch.int64, dev)
            hist_sixd = hist_sixd.index_put(
                (rows,), rot.aa_to_sixd(ik_vals.reshape(6, 3))
                .to(hist_sixd.dtype))
        hist = torch.cat([hist_sixd.reshape(108),
                          s_hist[cst.N_DOFS:cst.N_DOFS + 3], c_t])
    else:
        hist = state_to_history(s_hist, c_t, n_sbps)
    s_and_c_win = push_history(bcfg, b.s_and_c_win, k_new, hist)

    new_base = RunnerCarry(
        t=b.t + 1, raw_imu=raw, k=k_new, imu_win=imu_win,
        accsum_win=accsum_win, acc_runsum=acc_runsum,
        s_and_c_win=s_and_c_win, out_buf=out_buf, n_out=n_out,
        # the prediction before the root correction (none under playback)
        last_s=b.last_s if cfg.playback_gt else s_pred,
        prev_pq=pq_g, prev_root=s_t[:3], c_locs=c_locs, s_init=b.s_init,
        cache=b.cache)
    new_carry = FullCarry(base=new_base, terrain=terrain, ticks=ticks,
                          ik_deltas=ik_deltas, c_locs_prev=c_locs)
    return new_carry, {"qdq": s_t, "viz_locs": c_locs, "ct": c_t,
                       "upd": done}


def run_offline_full(model: M.TIPModel, cfg: FullRunnerConfig,
                     skel: kin.Skeleton, s_init, imu_seq, s_gt=None,
                     c_gt=None, collect_updates: bool = False, device=None):
    """Stream a recorded IMU sequence through the full runner, frame by
    frame (offline evaluation, ground-truth playback), on ``device``
    (``cuda`` unless the caller asks for another); the model and skeleton
    must already be there, in the dtype of the run. Under ``playback_gt``,
    frame t plays (s_gt[t], c_gt[t]).

    Returns (s_traj (T, 114), c_traj (T, n_sbps*4), viz (T, n_sbps, 3),
    final FullCarry), with ``collect_updates`` (s_traj, c_traj, viz, upd,
    final): upd the (T, 3) bool track of terrain updates (row t: committed
    at frame t, centered on viz[t-1]'s rows lankle, rankle, root).
    """
    device = resolve_device(device)
    if model.cfg != cfg.base.model:
        raise ValueError("the model was built for another ModelConfig than "
                         "cfg.base.model")
    _check_on(next(model.parameters()), device, "the model")
    dtype = next(model.parameters()).dtype
    carry = full_runner_init(cfg, skel, s_init, dtype=dtype, device=device)
    imu_seq = torch.as_tensor(imu_seq, dtype=dtype, device=device)
    if cfg.playback_gt:
        s_gt = torch.as_tensor(s_gt, dtype=dtype, device=device)
        c_gt = torch.as_tensor(c_gt, dtype=dtype, device=device)
    packed_ws = pack_fused_weights(model, cfg.base, dtype)
    outs = []
    with torch.no_grad():
        for t in range(imu_seq.shape[0] - 1):
            gt = (s_gt[t], c_gt[t]) if cfg.playback_gt else (None, None)
            carry, out = full_runner_step(model, carry, imu_seq[t], cfg,
                                          skel, *gt, packed_ws=packed_ws)
            outs.append(out)
    s0 = carry.base.s_init
    s_traj = torch.stack([s0] + [o["qdq"] for o in outs])
    c_traj = torch.stack([torch.zeros_like(outs[0]["ct"])]
                         + [o["ct"] for o in outs])
    viz = torch.stack([torch.full_like(carry.base.c_locs, 100.0)]
                      + [o["viz_locs"] for o in outs])
    if collect_updates:
        upd = torch.stack([torch.zeros_like(outs[0]["upd"])]
                          + [o["upd"] for o in outs])
        return s_traj, c_traj, viz, upd, carry
    return s_traj, c_traj, viz, carry
