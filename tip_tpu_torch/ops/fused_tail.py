"""Fused runner decode and tail (twin of tip_tpu/ops/fused_tail.py).

Two kernels in ``csrc/fused_tail.cu``, each one launch per frame. Both take
one stream's inputs or, with a leading stream axis B on every input and
output, a pool's: one launch of one block a stream either way.

  K2 ``decode_fused``: runner stages 4-5's heavy math — the exponential
     output filter, SBP flag/offset decode, the root IMU matrix -> quat and
     the 17 6D -> quat joint decodes. The quat -> axis-angle step stays
     outside, as in tip_tpu, so the outputs compare one to one.
  K3 ``tail_fused``: runner stages 6-7 — aa -> quat decode, the FK tree
     walk, CoM/joint frames, the 5 SBP residues, the clipped feet mean and
     the 18-row 6D history re-encode. The z fix and the -vel_res*dt shifts
     stay in the runner.

Beside each, a plain PyTorch version with the same outputs
(``decode_fused_plain``, ``tail_fused_plain``). The wrappers take
``impl``: "fused" launches the kernel (CUDA tensors only), "plain" runs the
plain version, "auto" launches for a CUDA tensor and runs the plain
version for a CPU tensor. Each checks the skeleton's tables or the filter
weights once per (skeleton or weights, device, leading shape), and takes
``clock=`` for its per-phase clock (``phase_ns``); ``floor_launch`` is their
launch floor, an empty kernel, and ``timer_probe`` the device timers' step.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tip_tpu_torch import constants as cst
from tip_tpu_torch.chars import amass as _char
from tip_tpu_torch.ops import _kernels as K
from tip_tpu_torch.ops import kinematics as kin
from tip_tpu_torch.ops import rotations as rot
from tip_tpu_torch.ops import sbp as sbp_ops

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = {
    "decode_fused_launch": [_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _P, _P,
                            _P],
    "tail_fused_launch": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P,
                          _P, _P],
    "tail_floor_launch": [_I, _P, _P],
    "timer_probe_launch": [_I, ctypes.c_longlong, _P, _P],
}
# the phases of K2's and K3's per-phase clocks (stamp 0 is the start)
K2_PHASES = ("filter", "decode")
K3_PHASES = ("aa_to_q", "walk", "link_frames", "encode_6d", "residues",
             "feet_mean")

# joint j -> nimble aa slot whose quat is its local rotation (-1: fixed)
_JOINT_SLOT = np.full(len(_char.JOINT_NAMES), -1, np.int32)
_JOINT_SLOT[_char.NON_ROOT_ACTIVE_IDX] = _char.BULLET_FROM_NIMBLE_GATHER
_JOINT_SLOT = tuple(int(i) for i in _JOINT_SLOT)


class DecodeOut(NamedTuple):
    y_f: torch.Tensor        # (131,) filtered model output
    c_t: torch.Tensor        # (5, 4) decoded SBP rows [flag, offsets/5]
    q_rows: torch.Tensor     # (18, 4) quats: row 0 = root (from IMU ori),
    #                          rows 1..17 = model joints 1..17 (6D-decoded)


class TailOut(NamedTuple):
    pq_com: torch.Tensor     # (20, 7) CoM link frames (pre-correction)
    pq_jf: torch.Tensor      # (20, 7) joint frames
    hist_sixd: torch.Tensor  # (18, 6) two-axis encode of s[3:57] (None from
    #                          the runner's plain tail, which encodes later)
    vel_res: torch.Tensor    # (3,) clipped mean feet residue (pre z-fix)
    c_locs: torch.Tensor     # (5, 3) world SBP positions (100s if inactive)
    raw_res: torch.Tensor    # (5, 3) per-SBP residue (NaN rows if inactive)
    active: torch.Tensor     # (5,) float 0/1 — SBP flag set


# ---------------------------------------------------------------------------
# K2: decode
# ---------------------------------------------------------------------------

def decode_fused_plain(y_t, filt_view, coeff, use_filter, local9,
                       n_sbps: int = 5) -> DecodeOut:
    """Plain version of K2: the runner's stage 4-5 math before the
    axis-angle step, plus matrix_to_q. One stream, or B streams with a
    leading axis on ``y_t``, ``filt_view`` and ``local9`` (and on the
    outputs); ``use_filter`` is a host bool or a (B,) bool tensor."""
    lead = y_t.shape[:-1]
    y_smooth = torch.sum(filt_view * coeff[:, None], dim=-2) \
        / torch.sum(coeff)
    if isinstance(use_filter, torch.Tensor):
        y_f = torch.where(use_filter[..., None], y_smooth, y_t)
    else:
        y_f = y_smooth if use_filter else y_t
    c = y_f[..., -n_sbps * 4:].reshape(lead + (n_sbps, 4))
    flags = (c[..., 0] > 0.0).to(y_f.dtype)
    c_t = torch.cat([flags[..., None], c[..., 1:] / 5.0], dim=-1)
    q_root = rot.matrix_to_q(local9.reshape(lead + (3, 3)))
    q_joints = rot.matrix_to_q(
        rot.sixd_to_matrix(y_f[..., :108].reshape(lead + (18, 6))))
    return DecodeOut(y_f=y_f, c_t=c_t,
                     q_rows=torch.cat([q_root[..., None, :],
                                       q_joints[..., 1:, :]], dim=-2))


def decode_fused(y_t, filt_view, coeff, use_filter, local9,
                 filter_len: int = 6, n_sbps: int = 5,
                 impl: str = "auto", clock=None) -> DecodeOut:
    """Output filter + SBP decode + 18 quat decodes as one op, for one
    stream or for B streams in one launch (a leading axis B on ``y_t``,
    ``filt_view``, ``local9`` and every output).

    Args:
      y_t: (D,) raw model output of this frame.
      filt_view: (filter_len, D) chronological output ring (oldest first).
      coeff: (filter_len,) filter weights, shared by all streams.
      use_filter: host bool — n_out >= filter_len — or a (B,) bool tensor,
        one flag a stream.
      local9: (9,) row-major root IMU rotation matrix.
      filter_len: frames in the ring, at least 1 (the kernel sums them in
        chunks of 16).
      clock: None, or a (3,) int64 tensor on the kernel's device for the
        per-phase clock (``phase_ns``).
    """
    if not K.use_kernel(impl, y_t, "tail_impl", "fused"):
        return decode_fused_plain(y_t, filt_view, coeff, use_filter, local9,
                                  n_sbps)
    dev = y_t.device
    a = _decode_args(coeff, dev, tuple(y_t.shape), filter_len, n_sbps)
    f32 = torch.float32
    K.check_input(y_t, "y_t", a.shapes[0], f32, dev)
    K.check_input(filt_view, "filt_view", a.shapes[1], f32, dev)
    K.check_input(local9, "local9", a.shapes[2], f32, dev)
    flags = 0
    if isinstance(use_filter, torch.Tensor):
        K.check_input(use_filter, "use_filter", a.shapes[0][:-1], torch.bool,
                      dev)
        flags = use_filter.data_ptr()
    out = torch.empty(a.n_out, dtype=f32, device=dev)
    err = K.lib("fused_tail", _SIG).decode_fused_launch(
        y_t.data_ptr(), filt_view.data_ptr(), coeff.data_ptr(), filter_len,
        local9.data_ptr(), 0 if flags else int(bool(use_filter)), flags, a.B,
        a.shapes[0][-1], n_sbps, out.data_ptr(),
        K.clock_ptr(clock, 1 + len(K2_PHASES), dev), K.stream_of(dev))
    K.check(err, "decode_fused")
    K.launch_counts["decode_fused"] += 1
    return DecodeOut(*(out.as_strided(*v) for v in a.views))


def _decode_args(coeff, device, y_shape, filter_len: int,
                 n_sbps: int) -> K.LaunchArgs:
    """K2's checks of its shapes and filter weights, once per (coeff,
    device, shape); the kernel reads coeff at every launch."""
    def make():
        lead, D = y_shape[:-1], y_shape[-1]
        if len(lead) > 1:
            raise ValueError(f"y_t: one stream (D,) or a pool (B, D), got "
                             f"{y_shape}")
        if not 108 + 4 * n_sbps <= D <= 114 + 4 * n_sbps:
            raise ValueError(f"y_t width {D}: decode_fused takes 18 6D rows, "
                             f"at most 6 columns, then {n_sbps} SBP rows")
        if not 0 < n_sbps <= 96:
            raise ValueError(f"decode_fused's block decodes 1..96 SBPs, got "
                             f"{n_sbps}")
        if filter_len < 1:
            raise ValueError(f"decode_fused filters over at least 1 frame, "
                             f"got {filter_len}")
        K.check_input(coeff, "coeff", (filter_len,), torch.float32, device)
        n_out, views = K.out_views(lead, ((D,), (n_sbps, 4), (18, 4)))
        return K.LaunchArgs(
            shapes=(y_shape, lead + (filter_len, D), lead + (9,)),
            table=coeff, B=lead[0] if lead else 1, n_out=n_out, views=views)
    return K.launch_args(coeff, (device, y_shape, filter_len, n_sbps), make)


# ---------------------------------------------------------------------------
# K3: tail
# ---------------------------------------------------------------------------

def tail_fused_plain(skel: kin.Skeleton, s_t, c_t, prev_pq,
                     dt: float = cst.DT, n_sbps: int = 5) -> TailOut:
    """Plain version of K3: fk_our_state + root_correction_from_constrs +
    aa_to_sixd of s[3:57], for one stream or with a leading stream axis on
    ``s_t``, ``c_t``, ``prev_pq`` and every output. Unlike the kernel it
    takes any SBP count (the first ``min(5, n_sbps)`` evaluated)."""
    pq_com, pq_jf = kin.fk_our_state(skel, s_t, return_joint_frame=True)
    corr = sbp_ops.root_correction_from_constrs(
        prev_pq, pq_com, c_t, n_sbps=n_sbps, use_n_sbps=min(5, n_sbps), dt=dt)
    hist = rot.aa_to_sixd(s_t[..., 3:57].reshape(s_t.shape[:-1] + (18, 3)))
    return TailOut(pq_com=pq_com, pq_jf=pq_jf, hist_sixd=hist,
                   vel_res=corr.vel_res, c_locs=corr.c_locs,
                   raw_res=corr.raw_residues,
                   active=corr.active.to(s_t.dtype))


def tail_fused(skel: kin.Skeleton, s_t, c_t, prev_pq, dt: float = cst.DT,
               impl: str = "auto", n_sbps: int = 5, clock=None) -> TailOut:
    """Stages 6-7 of the runner for one (114,) nimble state and the 5-SBP
    layout, minus the runner's z fix and -vel_res*dt shifts:

        pq_com, pq_jf = kinematics.fk_our_state(skel, s_t, True)
        corr = sbp.root_correction_from_constrs(prev_pq, pq_com, c_t)
        hist_sixd = rotations.aa_to_sixd(s_t[3:57].reshape(18, 3))

    or for B streams in one launch: ``s_t`` (B, 114), ``c_t`` (B, 20),
    ``prev_pq`` (B, 20, 7), every output with the leading B. ``clock``:
    None, or a (7,) int64 tensor for the per-phase clock (``phase_ns``).
    """
    if not K.use_kernel(impl, s_t, "tail_impl", "fused"):
        return tail_fused_plain(skel, s_t, c_t, prev_pq, dt, n_sbps)
    if n_sbps != 5:
        raise ValueError(f"tail_fused's kernel takes the 5-SBP layout only, "
                         f"got n_sbps={n_sbps}")
    dev, f32 = s_t.device, torch.float32
    a = _tail_args(skel, dev, tuple(s_t.shape[:-1]))
    K.check_input(s_t, "s_t", a.shapes[0], f32, dev)
    K.check_input(c_t, "c_t", a.shapes[1], f32, dev)
    K.check_input(prev_pq, "prev_pq", a.shapes[2], f32, dev)
    out = torch.empty(a.n_out, dtype=f32, device=dev)
    err = K.lib("fused_tail", _SIG).tail_fused_launch(
        s_t.data_ptr(), c_t.data_ptr(), prev_pq.data_ptr(),
        a.table.data_ptr(), a.B, skel.n_joints, int(a.deep), float(dt),
        out.data_ptr(),
        K.clock_ptr(clock, 1 + len(K3_PHASES), dev), K.stream_of(dev))
    K.check(err, "tail_fused")
    K.launch_counts["tail_fused"] += 1
    return TailOut(*(out.as_strided(*v) for v in a.views))


def _tail_args(skel: kin.Skeleton, device, lead) -> K.LaunchArgs:
    L = skel.n_joints + 1
    return kin.skeleton_args(
        skel, "tail_fused", _JOINT_SLOT, device, lead,
        ((114,), (20,), (L, 7)),
        ((L, 7), (L, 7), (18, 6), (3,), (5, 3), (5, 3), (5,)))


# ---------------------------------------------------------------------------
# the per-phase clock, the launch floor and the timer probe
# ---------------------------------------------------------------------------

def phase_ns(stamps, names, cycles_per_ns: float) -> dict:
    """A per-phase clock's stamps (cycle counts: the start, then the end of
    each phase) -> {phase: ns, "total": ns}."""
    out = {n: (b - a) / cycles_per_ns
           for n, a, b in zip(names, stamps, stamps[1:])}
    out["total"] = (stamps[len(names)] - stamps[0]) / cycles_per_ns
    return out


def floor_launch(out):
    """The launch floor: an empty kernel of B blocks of 32 threads, B =
    ``out.numel()``, each writing its own float32 of ``out`` (CUDA)."""
    so = K.lib("fused_tail", _SIG)
    K.check(so.tail_floor_launch(out.numel(), out.data_ptr(),
                                 K.stream_of(out.device)), "tail_floor")


def timer_probe(dev, reads: int = 100000, spin: int = 10 ** 7) -> dict:
    """%globaltimer's step (the smallest change over ``reads`` reads in a
    tight loop, and how many changes), and the SM's cycles per ns of
    %globaltimer over a spin of ``spin`` cycles; one thread, synchronised."""
    out = torch.zeros(4, dtype=torch.int64, device=dev)
    so = K.lib("fused_tail", _SIG)
    K.check(so.timer_probe_launch(reads, spin, out.data_ptr(),
                                  K.stream_of(out.device)), "timer_probe")
    step, changes, ns, cycles = out.tolist()
    return dict(globaltimer_step_ns=step, globaltimer_changes=changes,
                reads=reads, cycles_per_ns=cycles / ns)
