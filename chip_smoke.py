#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tip_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. require CUDA, turn TF32 off and cuBLAS's reduced-precision bf16 sums
     off (bf16 products sum in f32, as XLA's), print the card's name and
     power limit;
  2. build the CUDA kernels from tip_tpu_torch/csrc with nvcc;
  3. hold each kernel (K1-K12) against its plain PyTorch version on the card
     at the main paths' shapes, and time both, with one PyTorch call that
     computes the same function where there is one (cuDNN's RNN beside K1
     at B 1, 64 and 256; TransformerEncoderLayer beside K11 and K12); the
     pool's kernels K8 and K9 also against the single-stream K7 and K4
     stream by stream, and the batched K2, K3, K6 against B unbatched calls;
     K8's and K9's device time split by phase (their per-phase clock) at B
     64; K10 beside cuDNN's RNN backward and split by kernel; K2, K3 and K6
     beside the launch floor (an empty kernel of as many blocks), timed at
     B 1 and 64 and split by phase (their per-phase clock, in SM cycles),
     and K2 and K3 each after the op that writes their input, 20 pairs in
     a CUDA graph (a read before that op finished would show); K3 and K6
     also on a skeleton that lists children before their parents, with a
     fixed joint inside a chain, and on chains deeper than a pass of their
     walk (11 and 19 joints); K2 also at filter lengths 17 and 20; the
     bf16 variants of K1 (at K1's batch sizes, beside cuDNN's RNN in bf16),
     K11 (at B 1, 64 and 256, p 0 and 0.1, beside TransformerEncoderLayer
     in bf16), K10 (at B 1, 3, 64 and 256, beside cuDNN's bf16 RNN
     backward) and K12 (at B 1, 64 and 256, p 0 and 0.1, beside
     TransformerEncoderLayer bf16's autograd) against their bf16 plain
     versions, each also by its share of entries off the plain version
     against controls that round elsewhere (K1 and K10 step by step, K12
     stage by stage);
  4. run the main paths: the full-width model (ModelConfig() defaults,
     random weights from a seeded generator) in the streaming runner over
     the first 360 frames of an in-tree motion, each path with every launch
     counter reset just before and read just after. Recompute mode:
       A  eager model with the plain encoder loop (encoder_impl="plain")
          and K1, decode K2, tail K3;
       A-enc  A with the encoder layers through K11 (encoder_impl="kernel",
          which the default "auto" takes on the card), 120 frames;
       A-bf16  ModelConfig(compute_dtype="bfloat16"), every other setting
          at its default: four launches of K11's bf16 variant and one of
          K1's a frame, K2, K3, no f32 K1 or K11; 120 frames;
       C  forward_impl="fused" with f32 packing (K4), plain decode and tail
          with the FK kernel (K6);
       B  forward_impl="fused" with bf16 packing (K4), K2, K3; then a
          teacher-forced replay of every window path B saw through K5;
     KV-cache modes:
       D  serving_mode="kv_cache", forward_impl="fused", f32 rings: the
          cached step K7 (RNN replay), K2, K3;
       E  serving_mode="kv_cache_rnn_carry", forward_impl="fused", bf16
          rings: K7 (carried hidden), K2, K3;
       F  serving_mode="kv_cache" with the plain cached step, K2, K3;
     compare A and C with the plain path on the card and with a float64 CPU
     run of the plain path, A-enc with A, hold every window of A-bf16
     through K11/K1 in bf16 against the same window through their plain
     versions (teacher-forced) and report A-bf16's free-running drift from
     A-enc, hold B's recorded outputs against
     K5 and the plain version window by window; compare D with F, with C
     while the window grows and with a float64 CPU run of F's
     configuration, hold every frame of E against K7's plain version on
     E's own tokens; time and profile frames;
  4b. the full runner (terrain + leg IK, run_offline_full), counters reset
     before and read after each, N and N-gt over the motion's first 360
     frames:
       N  bench.py's configuration: recompute, K1, K2, K3, multi_sbp,
          default TerrainConfig, f32, the plain encoder loop;
       N-gt  ground-truth playback of the motion (nimble_qdq, constrs),
          multi_sbp, through K3 on every frame;
       N-E  120 frames in kv_cache_rnn_carry, fused, bf16: K7, K2, K3;
     compare N with the plain versions on the card (300 frames, terrain at
     frame 300) and a float64 CPU run (120), N-gt with a float64 CPU
     playback (contacts, updates, terrain, terrain metrics), hold every
     frame of N-E against K7's plain version; time and profile N, and
     count the host syncs of a steady frame of A and N;
  5. run the pool paths: StreamPool at capacity 64 over the 60 in-tree
     motions (four slots join later, one stream is removed and its slot
     re-added), 300 ticks, counters reset before and read after each:
       G  kv_cache_rnn_carry, fused, bf16: K8 (carry), K2, K3;
       H  kv_cache, fused, f32: K8 (replay), K2, K3;
       I  kv_cache, plain batched cached step, f32, K2, K3: H's reference;
       J  recompute, fused, f32: K9, K2, K3;
       K  recompute, plain model (plain encoder loop, K1 at (64, 40, 512)),
          plain tail with the batched FK kernel K6, 120 ticks;
       K-bf16  A-bf16 pooled: four launches of K11's bf16 variant at (64,
          40, 256) and one of K1's at (64, 40, 512) a tick, K2, K3, 120
          ticks;
     compare H with I over all streams, four streams of H with the
     single-stream path D and of J with C from each stream's own first
     frame, G teacher-forced with K8's plain version on its own tokens, K
     with J, four streams of K-bf16 teacher-forced against A-bf16's
     single-stream model from each stream's own first frame; time and
     profile ticks;
  5b. the serving daemon, the live demo and data generation, through
     their CLIs' own builders (cli/serve.build_daemon, cli/live_demo's
     build_runner and run_loop) on checkpoints of seeded random weights
     written under output/, over in-process sockets that speak the
     imu_bridge wire protocol (tests/torch_wire.py):
       P  cli/serve --five_sbp --with_acc_sum --serving_mode
          kv_cache_rnn_carry --forward_impl fused --bf16 (G's route: K8,
          K2, K3) with 64 clients replaying the in-tree motions: 120 ticks
          in lockstep, each client's lines equal to a twin pool stepped on
          the same parsed batches, a client leaving and a new one taking
          its recycled slot; the schedule's streams in f32 against the
          single-stream runner; then ServeDaemon.run free at 60 Hz for
          10 s, one client stopping to read halfway
          (scripts/torch_serve_load.py's harness): ticks done and due,
          the tick's host ms split into the fill, the pool step, the
          encode and the sends, beside the bare pool step; the ticker's
          CPU time, the daemon's threads, the connects' add_stream; lines
          for every client, dropped for that client's only, no failed
          tick, one launch of K8, K2 and K3 a tick;
       P-2  cli/serve's defaults (2 SBPs, recompute, the plain forward,
          tail_impl auto: K11, K1 and the plain decode and tail, ROADMAP
          C14) with 16 clients, 120 lockstep ticks against the plain route
          on the card; cli/evaluate without --five_sbp over one motion;
       Q  cli/live_demo's loop through IMUClient from a 60 Hz replay
          server, --five_sbp --with_acc_sum --multi_sbp_correction (K11,
          K1, K2, K3), 200 frames with --out, --record and --metrics; the
          recorded frames through run_offline_full give --out's poses, and
          through the plain versions, frame by frame from the kernels' own
          carry, agree within TOL_PATH; the step's latency;
       R  amass_syn.synthesize of a 600-frame procedural SMPL motion in
          float64 on the card against the CPU, timed by stage;
  6. the training paths: pack the 60 in-tree motions with the port's
     data_gen/combine.py into output/, then
       L  one epoch of train_loop at the paper recipe (B 256, T 40, AdamW,
          cosine, clip 5, history noise 0.15, past dropout 0.8, layer
          dropout 0.1), full width, f32: one launch of K1 and K10 and four
          of K11 and K12 a step, none of a serving kernel; a checkpoint
          written and restored bit-equal; the restored model (it requires
          grad; its encoder takes K11, and with grad on K12) serves a frame
          of paths A and F outside no_grad, equal to the detached model's,
          and runs one forward and backward with grad on; the step timed
          and profiled;
          held against a float64 step on the CPU and, ten steps, against
       M  the same training with the plain versions on the card;
       L-bf16  L with compute_dtype="bfloat16" (cli/train --bf16): one
          launch of K1 bf16 and K10 bf16 and four of K11 bf16 and K12 bf16
          a step, no f32 K1, K10, K11 or K12; the parameters, moments and
          checkpoint float32; the restored model's forward with grad on
          equal to no_grad's, and its backward; the step timed and
          profiled; held against the plain versions' bf16 step on the CPU
          and, ten steps, against
       M-bf16  the same bf16 training with the plain versions on the card;
     (K10, K11, K12 are held against their plain versions in phase 3);
  6b. the convergence recipe (scripts/torch_train_convergence.py):
       T  its corpus phase, 4 training motions (seed 100) and 1 held-out
          motion (seed 900, 12.5 s) in float64 on the card and on the CPU:
          the same files, the payloads within path R's tolerance;
       U  the recipe's configuration over T's files (bf16, K1 bf16 and
          K10 bf16, the xla layer loop, rng dropout, B 256, AdamW): one
          epoch of make_epoch_fn with the device sampler under torch's
          sync debug mode "error" (one K1 bf16 and one K10 bf16 a step,
          nothing else), against the same epoch with rnn_impl="plain";
          phase_train for two epochs, a run resumed from epoch 1's
          checkpoint ending bit-equal, and phase_eval on the held-out
          motion (K1, K2, K3); one epoch of cli/train with the recipe's
          flags (K1 bf16, K10 bf16) and with tip_tpu's defaults (none);
       V  make_epoch_fn in the kernel configuration (f32, hash dropout; K1,
          K10 and four each of K11 and K12 a step) over given ends with no
          host sync, bit-equal to as many train_step calls; an epoch of a
          batch with an inf: skipped, the state kept;
  6c. tip_tpu's orbax checkpoint:
       X  tests/data/orbax_tiny (tip_tpu's own save_checkpoint at path S's
          widths, 5 SBPs, acc-sum, AdamW with the clip, after two of its
          train steps; scripts/torch_make_orbax_fixture.py) read on the
          card's host by utils/orbax_read.py (libzstd.so.1 through ctypes):
          every array equal to tests/data/orbax_tiny.json's digests;
          cli/evaluate's load_model from it serves an in-tree motion over
          X_FRAMES frames through the default route (K1, 2 x K11, K2, K3 a
          model frame), within TOL_EVAL of the same weights through the
          plain versions on the card; a full resume from it
          (train.restore_checkpoint, params_only=False: parameters, Adam's
          moments and count, step, generators) takes X_STEPS steps of
          X_BATCH windows in the kernel configuration (K1, K10, 2 x K11, 2
          x K12 a step), its first step's loss and parameters within
          TOL_PATH of the plain versions' step from the same restore;
  6d. the (data, model) mesh (parallel/mesh.py), in child processes of
     this script that share the card (``chip_smoke.py --mesh-child``; they
     load the kernels this process built), all started together, each
     case's ranks on gloo with CUDA tensors (NCCL refuses two ranks on one
     device), the launch counters reset just before and read just after
     on each rank:
       Y  (a) a 2x1 mesh: three steps of the paper recipe at full width
          in the kernel configuration (hash dropout, f32, B 256, T 40; a
          mesh trains the xla layer loop: one K1 and one K10 a step on
          every rank, nothing else) against the same steps in one process
          on the same global batches (TOL_Y_*: loss, grad norm, Adam's
          moments and the update leaf by leaf, the share of parameter
          entries off; the leaves a rank holds whole alike on every rank
          bit for bit); (b) a 1x2 mesh (tensor
          parallel, 8 heads a rank): one step, likewise; (c)
          StreamPool(mesh=) 2x1 in path H's configuration (K8, K2, K3 one
          launch a tick on each rank), capacity 64, 60 ticks with streams
          joining at ticks 7 and 50, against one card's pool (TOL_Y_POOL);
          (d) a one-rank NCCL mesh whose step is the unmeshed step bit for
          bit; it prints a {"mesh_path": ...} line with each check's worst
          difference and the step and tick times;
  7. print one {"kernels": [...]} line (sixteen entries: K1-K12 and the
     bf16 variants of K1, K10, K11 and K12), then a "summary" line a path
     (passed, with its key number: P's ticks done of due, Y's checks),
     then the {"ok": true, ...} line. A failure prints the summary of
     what passed and the stage that failed before it exits: a chip call
     returns only the last 24 KB of the output.
"""

import contextlib
import dataclasses
import json
import math
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CORPUS = ROOT / "artifacts" / "corpus_run_v3" / "corpus_extra"
MOTION = CORPUS / "freeform2_0000.pkl"

# H100 SXM published peaks (NVIDIA data sheet, dense rates): HBM bytes/s,
# f32 FLOP/s outside the tensor cores, bf16 FLOP/s of the tensor cores.
# Work on f32 values is held to the f32 peak; the products of K4/K5 with
# bf16 packing are bf16 x bf16 with f32 sums, which the tensor cores can
# do, so their bound uses the bf16 peak
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
# K12's products run 3xTF32 on the tensor cores: three TF32 products (495
# TFLOP/s) for each f32 one, so K11 and K12 also get a bound at 165
PEAK_3XTF32_FLOP_S = 495e12 / 3

# tolerances of the kernel checks (f32 on the card, kernel vs plain)
TOL = 1e-5
# K1's batch sizes: checked (one stream, tiles of 1 and 2 rows, a cluster
# with a partial tile, the pool's 64, the training batch), and timed with
# cuDNN beside it
RNN_CHECKED_B = (1, 3, 8, 17, 64, 256)
RNN_TIMED_B = (1, 64, 256)
# K1 in bf16 against its plain version in bf16: both round three times a
# step (the f32 sum, the add, the tanh), but they sum the product in
# another order, so a sum that lies at a bf16 rounding boundary rounds the
# other way and moves h by one bf16 step (2^-8 for |h| in [0.5, 1)); W_hh
# (|W| ~ 1/sqrt(H)) carries it on damped, and a later step can flip again.
# Held within four such steps
TOL_RNN_BF16 = 4 * 2.0 ** -8
# A max error cannot show that a bf16 kernel rounds where tip_tpu's does:
# cuDNN's bf16 RNN and TransformerEncoderLayer in bf16, which round at other
# places, come as close to the plain versions. A sum that the kernel orders
# otherwise and that ends near a bf16 rounding boundary moves few entries;
# a rounding left out or put in moves a large share of them. So each bf16
# check also counts the share of entries that differ from the plain version
# at all and holds it within ROUND_SHARE, and the same share of controls
# that round elsewhere, on the same inputs, must exceed it (else the check
# is blind and the run fails). K1 is held step by step, each step against
# the plain version's step from the kernel's own previous state, so that a
# flip is not carried on through the recurrence; K11 on y. The library's
# bf16 function (cuDNN's RNN, TransformerEncoderLayer) is read beside the
# controls, not held: where it rounds is its own. On an H100 80GB HBM3
# the kernels read 2.4e-5 to 3.8e-5 (K1) and 6.0e-3 to 1.02e-2 (K11), the
# controls at least 0.150 and 0.295; each limit lies near the geometric
# middle of the kernel's highest reading and the controls' lowest. The bf16
# backwards are held the same way, each step or stage against the plain
# version's from the kernel's own inputs to it: K10 step by step (dx_t from
# its own dx_{t+1}, dW from its own dx: rnn_bwd_steps_plain), K12 stage by
# stage (each product from its own activations in its scratch:
# k12_stages_plain); end to end a flip is carried on through the later
# roundings (K12: 0.128 of dx's and the gradients' entries). On an H100
# 80GB HBM3 K10 bf16 read 8.7e-5 (the walk on the CUDA cores) and 1.25e-4
# (on the tensor cores, dW on wgmma), its controls at least 0.031 (dW
# rounded per split), K12 bf16 1.3e-4 to 1.9e-4 (the latter on wgmma
# products) and its controls at least 0.108 (the attention backward's
# operands unrounded)
ROUND_SHARE = {"fused_rnn_bf16": 2e-3, "encoder_layer_fwd_bf16": 5e-2,
               "fused_rnn_bwd_bf16": 2e-3, "encoder_layer_bwd_bf16": 5e-3}
ROUND_READ_ONLY = ("cudnn_bf16", "library_bf16")
# the bf16 yardsticks (cuDNN's RNN, TransformerEncoderLayer) round at other
# places than tip_tpu's kernels; they are held only to be the same
# function (a transposed weight or a lost input shows at O(1)), relative to
# the largest entry
TOL_LIB_BF16 = 2.0 ** -3
# residues (and their clipped feet mean) divide a position difference by
# dt = 1/60: rounding of ~1e-7 m is amplified 60x, hence 1e-4
TOL_RES = 1e-4
# main path, kernels vs plain on the card, and card f32 vs CPU f64: an
# autoregressive 40-frame window of a random model feeds rounding back
TOL_PATH = 1e-3
PATH_FRAMES = 300
CPU_FRAMES = 120
# path A-enc (the encoder through K11) against path A
ENC_FRAMES = 120
# frames of the per-frame timing pass of each single-stream path
TIMED_FRAMES = 150
# the single-stream paths A-F run over the motion's first MAIN_FRAMES
# frames, and a profile reads PROFILED_FRAMES steady frames: the script's
# whole run must end well inside its time limit on a slow host
MAIN_FRAMES = 360
PROFILED_FRAMES = 20
# K4/K5 against their plain versions. f32 packing: the same f32 products
# summed in another order over up to 1024 terms, through 4 layers and 40
# RNN steps; the card shows 1.3e-6, so 1e-5 (not the 1e-4 a first guess
# allowed). bf16 packing: a sum that lands on the other side of a rounding
# boundary moves an activation by one bf16 step (2^-8 relative) before it
# is multiplied on; the card shows 2.8e-3 on outputs of order 1, so 1e-2
TOL_FF = {"float32": 1e-5, "bfloat16": 1e-2}
# K4's row against the same row of K5, and K6's frames against K3's: the
# same device code on the same values in the same order (the card shows 0)
TOL_SAME = 1e-6
# K7's rings with bf16 packing, kernel against plain: a stored row differs
# by a bf16 step or two where a sum rounded the other way, 2^-8 of the
# value each; held relative to the ring's largest magnitude
TOL_RING_BF16_REL = 2.0 ** -7
# trajectory rows while the 40-row window still grows (5 warm-up frames,
# 40 model frames, s_init): the cached step is the windowed forward there
GROW_ROWS = 46
KERNELS = ("fused_rnn", "decode_fused", "tail_fused", "fused_forward_last",
           "fused_forward", "fk_bullet_fused", "fused_cached_forward_step",
           "fused_cached_batch", "fused_recompute_batch", "fused_rnn_bwd",
           "encoder_layer_fwd", "encoder_layer_bwd", "fused_rnn_bf16",
           "encoder_layer_fwd_bf16", "fused_rnn_bwd_bf16",
           "encoder_layer_bwd_bf16")

# the pool paths: capacity, ticks, and who sits where. Slots 0-59 hold the
# 60 motions from tick 0; slots 60-63 join later with motions reused from
# their first frame; slot 5's stream is removed and the slot re-added.
# Motion 0 sits in slot 0, in two late slots and in the re-added slot, so
# that one single-stream run of it is the reference of all four
POOL_CAPACITY = 64
POOL_TICKS = 300
POOL_TICKS_K = 120
POOL_JOINS = {7: (60, 0), 50: (61, 1), 100: (62, 0), 130: (63, 3)}
POOL_REMOVE = (150, 5)          # (tick, slot)
POOL_READD = (160, 5, 0)        # (tick, slot, motion)
# (slot, first tick) of the four streams held against a single-stream run
POOL_CHECKED = ((0, 0), (60, 7), (62, 100), (5, 160))

# arithmetic per item of K2/K3, counted from csrc/fused_tail.cu (an add,
# multiply, divide, sqrt, compare or transcendental each counts one)
OPS_MATRIX_TO_Q = 40
OPS_SIXD_TO_Q = 71          # two column normalisations + cross + Shepperd
OPS_AA_TO_Q = 15
OPS_TREE_STEP = 61          # rotate the offset, add, compose the quats
OPS_LINK_FRAME = 33         # rotate the CoM offset, add
OPS_HIST_ROW = 27           # normalise + 6 matrix entries
OPS_SBP_RESIDUE = 80
OPS_FEET_MEAN = 15


def log(msg):
    print(msg, flush=True)


T0 = time.perf_counter()


def stamp(what):
    """A line with the seconds since the script started: where its time
    limit goes."""
    log(f"[{time.perf_counter() - T0:.1f} s] {what}")


class Report:
    """The end of the output: a "summary" line a path, passed with its key
    number, and on a failure the stage that failed with its error. The
    whole log runs to hundreds of KB and a chip call returns its last 24
    KB, so these lines come last."""

    WIDTH = 96                  # a line's characters: all under 4 KB

    def __init__(self):
        self.lines = []

    def add(self, path, key):
        self.lines.append(f"summary {path}: passed; {key}"[:self.WIDTH])

    def paths(self, launches, numbers=None):
        """A line a path of ``launches``: its launches, and its number from
        ``numbers`` where it has one."""
        for path, counts in launches.items():
            key = f"{sum(counts.values())} launches"
            if numbers and path in numbers:
                key += f"; {numbers[path]}"
            self.add(path, key)

    @contextlib.contextmanager
    def stage(self, name):
        try:
            yield
        except BaseException as e:
            first = (str(e).splitlines() or [""])[0]
            self.lines.append(f"summary {name}: FAILED; "
                              f"{type(e).__name__}: {first}"[:4 * self.WIDTH])
            self.print()
            raise

    def print(self):
        print("\n".join(self.lines), flush=True)


def time_ms(fn, n=200, warmup=20):
    """Median time of one eager call on the device stream over n calls
    (CUDA events around each call, so host launch gaps count), after a
    warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def host_us(fn, n=200, warmup=20):
    """Median host time of one call without a sync, in us: what a call's
    wrapper costs the host while the device may idle."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e6


def graph_ms(fn, per_graph=20, replays=50):
    """Device time of one call without host launch gaps: per_graph calls
    captured in one CUDA graph, replayed back to back, CUDA events around
    all replays, divided by the number of calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(replays):
        g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (replays * per_graph)


def timings(kernel, plain, library=None, graph=None, light=False):
    """ms (kernel device time), plain_ms and library_ms the same way, and
    the eager per-call times beside them. graph: (kernel, plain) forms for
    the graph replay where the eager forms copy from the host (a copy from
    pageable memory cannot be captured). light: fewer calls, for the pool's
    kernels, whose calls take milliseconds."""
    g = dict(per_graph=5, replays=10) if light else {}
    e = dict(n=30, warmup=5) if light else {}
    g_kernel, g_plain = graph if graph is not None else (kernel, plain)
    out = dict(ms=graph_ms(g_kernel, **g), plain_ms=graph_ms(g_plain, **g),
               call_ms=time_ms(kernel, **e), plain_call_ms=time_ms(plain, **e),
               library_ms=None, library_call_ms=None)
    if library is not None:
        out.update(library_ms=graph_ms(library, **g),
                   library_call_ms=time_ms(library, **e))
    return out


# the bf16 encoder layer's widening and rounding passes, gone since K11
# bf16 and K12 bf16 read and write bf16 as it is, and K10 bf16's, gone
# since its dW reads bf16 operands on wgmma: no by-kernel list may show
# them
GONE_KERNELS = ("widen_bf16", "narrow_bf16", "widen2_kernel",
                "round_splits_kernel")


def kernel_breakdown(fn, n=5):
    """Device ms a call by kernel of fn (torch.profiler over n calls after
    one warm-up call), largest first: [[name, ms, launches], ...]."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [[e.key[:80], e.self_device_time_total / 1e3 / n, e.count / n]
            for e in prof.key_averages() if e.self_device_time_total > 0]
    gone = [r[0] for r in rows if any(k in r[0] for k in GONE_KERNELS)]
    if gone:
        raise AssertionError(f"kernels that no longer exist ran: {gone}")
    return sorted(rows, key=lambda r: -r[1])


def bound(nbytes, ops, peak_flop_s=PEAK_F32_FLOP_S):
    """Least time (ms) for the work on the card, and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_flop_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_err(a, b):
    """Max |a - b| over entries that are not NaN in both; raises if the NaN
    patterns differ."""
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        raise AssertionError("NaN patterns differ")
    d = (a - b).abs()[~na]
    return d.max().item() if d.numel() else 0.0


def check(name, errs):
    """errs: {output: (err, tol)}. Raise if any output is out of its
    tolerance; return the max error."""
    for out, (err, tol) in errs.items():
        if not err <= tol:
            raise AssertionError(f"{name}.{out}: max |kernel - plain| = "
                                 f"{err:.3g} > {tol:g}")
    return max(err for err, _ in errs.values())


class OffShare:
    """Entries that differ from their plain version at all, summed over
    calls: add(a, b) counts them; share() is their share of all."""

    def __init__(self):
        self.off = self.n = 0

    def add(self, a, b):
        self.off += int((a != b).sum())
        self.n += a.numel()

    def share(self):
        return self.off / self.n


def check_rounding(name, kernel, controls):
    """kernel, controls: OffShare of the kernel and of each control
    ({name: OffShare}) against the plain version on the same inputs. Raise
    unless the kernel's share is within ROUND_SHARE[name] and every
    control's but ROUND_READ_ONLY's above it; return the readings."""
    limit = ROUND_SHARE[name]
    out = dict(kernel=kernel.share(), limit=limit, entries=kernel.n,
               controls={k: c.share() for k, c in controls.items()})
    log(f"  {name} share of entries off the plain version: "
        f"{json.dumps(out)}")
    if not out["kernel"] <= limit:
        raise AssertionError(f"{name}: {out['kernel']:.3g} of the entries "
                             f"differ from the plain version > {limit:g}: "
                             f"the kernel rounds at other places")
    blind = {k: v for k, v in out["controls"].items()
             if not v > limit and k not in ROUND_READ_ONLY}
    if blind:
        raise AssertionError(f"{name}: controls {blind} within {limit:g}: "
                             f"the check cannot tell another rounding")
    return out


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip()


def sm_cycles_per_ns(dev):
    """The SM's cycles per ns of %globaltimer (fused_tail.timer_probe, the
    second of two probes): what turns a kernel's clock into ns."""
    from tip_tpu_torch.ops import fused_tail as FT
    FT.timer_probe(dev)
    return FT.timer_probe(dev)["cycles_per_ns"]


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def rnn_work(B, T, H, itemsize=4):
    """Compulsory bytes (xin, W_hh in; the hidden states out; itemsize
    bytes an entry) and operations (a product and the add and tanh per
    entry) of K1."""
    return itemsize * (2 * B * T * H + H * H), B * T * H * (2 * H + 2)


def cudnn_rnn(w, H, dev):
    """Yardstick only, never called by the port: cuDNN's tanh RNN with
    W_ih = I and zero biases is the same function of xin, in w's dtype."""
    rnn = torch.nn.RNN(H, H, nonlinearity="tanh", batch_first=True).to(
        dev, w.dtype)
    with torch.no_grad():
        rnn.weight_ih_l0.copy_(torch.eye(H, device=dev))
        rnn.weight_hh_l0.copy_(w.T)
        rnn.bias_ih_l0.zero_()
        rnn.bias_hh_l0.zero_()
    return rnn


def rnn_steps_plain(xin, w, hs):
    """Each step of K1's plain version on its own, from the states hs (B,
    T, H) in place of its own: tanh(xin_t + hs_{t-1} W_hh) with hs_{-1} =
    0, in one product (in bf16 the plain version's three roundings a
    step)."""
    prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    return torch.tanh(xin + prev @ w)


def rnn_add_unrounded(xin, w):
    """Control: K1's bf16 recurrence with the add of xin kept in f32 (its
    rounding to bf16 left out)."""
    h, hs = xin.new_zeros((xin.shape[0], xin.shape[2])), []
    for t in range(xin.shape[1]):
        h = torch.tanh(xin[:, t].float() + (h @ w).float()).to(xin.dtype)
        hs.append(h)
    return torch.stack(hs, dim=1)


def rnn_controls(xin, w, rnn):
    """The controls of K1 bf16's rounding check on xin: {name: their hidden
    states in bf16}. rnn: cuDNN's bf16 RNN (cudnn_rnn)."""
    from tip_tpu_torch.ops import fused_rnn as FR
    with torch.no_grad():
        return {"add_unrounded": rnn_add_unrounded(xin, w),
                "cudnn_bf16": rnn(xin)[0],
                "f32_kernel_widened": FR.fused_rnn(
                    xin.float(), w.float(), impl="kernel").to(xin.dtype)}


def same_outputs(a, b):
    if isinstance(a, (tuple, list)):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def rnn_step_clock(run, dev, T, cycles_per_ns, n=11, warm=3):
    """The bf16 walk's per-step clock (run(clock) launches K1 bf16 or K10
    bf16 with it, run(None) without): the median over n clocked launches
    after `warm` of ns a step by phase (fused_rnn.K1_PHASES, step_ns), and
    the prologue's ns; a clocked launch's outputs must equal an unclocked
    one's bit for bit."""
    from tip_tpu_torch.ops import fused_rnn as FR
    rows = torch.zeros((n + warm, FR.CLOCK_ROWS), dtype=torch.int64,
                       device=dev)
    for i in range(n + warm):
        out = run(rows[i])
    if not same_outputs(out, run(None)):
        raise AssertionError("the clocked bf16 walk's outputs differ from "
                             "the unclocked one's")
    steps = [FR.step_ns(r, T, cycles_per_ns) for r in rows.tolist()[warm:]]
    return {k: statistics.median(s[k] for s in steps) for k in steps[0]}


def check_fused_rnn(dev, gen, dtype=torch.float32):
    """K1 in dtype (float32, or its bf16 variant) against its plain version
    in the same dtype at RNN_CHECKED_B (two calls bit-equal; in bf16 also
    step by step, check_rounding), timed at RNN_TIMED_B beside cuDNN's RNN
    in that dtype; the entry's own numbers are B 1's, the other Bs are its
    variants."""
    from tip_tpu_torch.ops import fused_rnn as FR
    bf16 = dtype == torch.bfloat16
    name = "fused_rnn_bf16" if bf16 else "fused_rnn"
    tol = TOL_RNN_BF16 if bf16 else TOL
    size = torch.tensor([], dtype=dtype).element_size()
    H, T = 512, 40
    w = ((torch.rand(H, H, generator=gen, device=dev) * 2 - 1)
         / math.sqrt(H)).to(dtype)
    rnn = cudnn_rnn(w, H, dev)
    errs, steps = {}, OffShare()
    controls = {}
    for B in RNN_CHECKED_B:
        xin = (torch.randn(B, T, H, generator=gen, device=dev) * 0.5).to(dtype)
        out = FR.fused_rnn(xin, w, impl="kernel")
        if out.dtype != dtype or not torch.equal(
                out, FR.fused_rnn(xin, w, impl="kernel")):
            raise AssertionError(f"{name} B {B}: two calls differ, or the "
                                 f"output is {out.dtype}")
        errs[f"B{B}"] = (max_err(out.float(),
                                 FR.fused_rnn_plain(xin, w).float()), tol)
        if bf16:
            steps.add(out, rnn_steps_plain(xin, w, out))
            for c, hs in rnn_controls(xin, w, rnn).items():
                controls.setdefault(c, OffShare()).add(
                    hs, rnn_steps_plain(xin, w, hs))
    err = check(name, errs)
    log(f"  {name} vs plain: {errs}")
    rounding = check_rounding(name, steps, controls) if bf16 else None
    cpn = sm_cycles_per_ns(dev) if bf16 else None
    variants = []
    for B in RNN_TIMED_B:
        xin = (torch.randn(B, T, H, generator=gen, device=dev) * 0.5).to(dtype)
        plan = FR.fused_rnn_plan(B, H, size)
        log(f"  {name} B {B} plan: {plan}")
        clock = (rnn_step_clock(lambda c, xin=xin: FR.fused_rnn(
            xin, w, impl="kernel", clock=c), dev, T, cpn) if bf16 else None)
        if clock is not None:
            log(f"  {name} B {B} step by phase (ns): "
                f"{json.dumps({k: round(v, 1) for k, v in clock.items()})}")
        with torch.no_grad():
            ref = FR.fused_rnn_plain(xin, w)
            lib_err = (rel_err(rnn(xin)[0], ref) if bf16
                       else max_err(rnn(xin)[0], ref))
            if not lib_err <= (TOL_LIB_BF16 if bf16 else TOL):
                raise AssertionError(f"cuDNN yardstick disagrees at B {B}: "
                                     f"{lib_err:.3g}")
            times = timings(lambda: FR.fused_rnn(xin, w, impl="kernel"),
                            lambda: FR.fused_rnn_plain(xin, w),
                            lambda: rnn(xin))
        b_ms, b_by = bound(*rnn_work(B, T, H, size),
                           PEAK_BF16_FLOP_S if bf16 else PEAK_F32_FLOP_S)
        variants.append(dict(
            B=B, bound_ms=b_ms, bound_by=b_by, library_err=lib_err,
            plan=dataclasses.asdict(plan), **times,
            **({"step_ns": clock} if bf16 else {})))
        log(f"  {name} B {B}: device {times['ms']:.4f} ms, cuDNN "
            f"{times['library_ms']:.4f} (|cuDNN - plain| {lib_err:.3g}), "
            f"plain {times['plain_ms']:.4f}, bound {b_ms:.2e} ({b_by})")
    own = {k: v for k, v in variants[0].items() if k != "B"}
    return dict(name=name, route="cuda",
                source="tip_tpu_torch/csrc/fused_rnn.cu",
                replaces="tip_tpu/ops/pallas_kernels.py:67",
                shape=[1, T, H], dtype=str(dtype).split(".")[1],
                max_abs_err=err, tol=tol,
                library=f"cuDNN torch.nn.RNN (tanh), {dtype}", **own,
                variants=variants[1:],
                **({"rounding_step_by_step": rounding} if bf16 else {}))


def check_decode_fused(dev, gen):
    from tip_tpu_torch.ops import fused_tail as FT
    from tip_tpu_torch.ops import rotations as rot
    D, nf, n_sbps = 131, 6, 5
    coeff = torch.tensor([0.6 ** i for i in range(nf - 1, -1, -1)],
                         dtype=torch.float32, device=dev)
    errs = {}
    cases = []
    for i in range(8):
        y_t = torch.randn(D, generator=gen, device=dev)
        filt = torch.randn(nf, D, generator=gen, device=dev)
        aa = torch.randn(3, generator=gen, device=dev)
        if i == 6:                       # near pi: the x/y/z branches
            aa = aa / aa.norm() * (math.pi - 1e-3)
        if i == 7:                       # identity
            aa = torch.zeros(3, device=dev)
        local9 = rot.aa_to_matrix(aa).reshape(9).contiguous()
        for use_filter in (False, True):
            out = FT.decode_fused(y_t, filt, coeff, use_filter, local9,
                                  impl="fused")
            ref = FT.decode_fused_plain(y_t, filt, coeff, use_filter, local9)
            for f in out._fields:
                e = max_err(getattr(out, f), getattr(ref, f))
                errs[f] = (max(e, errs.get(f, (0.0, TOL))[0]), TOL)
        cases.append((y_t, filt, local9))
    err = check("decode_fused", errs)
    y_t, filt, local9 = cases[0]
    times = timings(lambda: FT.decode_fused(y_t, filt, coeff, True, local9,
                                            impl="fused"),
                    lambda: FT.decode_fused_plain(y_t, filt, coeff, True,
                                                  local9))
    # the timed call filters (use_filter=True), so it reads filt and not
    # y_t: filt, coeff, local9 in; y_f, c_t, q out
    nbytes = 4 * (nf * D + nf + 9 + D + 4 * n_sbps + 18 * 4)
    ops = (2 * nf * D + D + nf + 4 * n_sbps + OPS_MATRIX_TO_Q
           + 17 * OPS_SIXD_TO_Q)
    b_ms, b_by = bound(nbytes, ops)
    return dict(name="decode_fused", route="cuda",
                source="tip_tpu_torch/csrc/fused_tail.cu",
                replaces="tip_tpu/ops/fused_tail.py:228", shape=[D],
                max_abs_err=err, tol=TOL, bound_ms=b_ms, bound_by=b_by,
                **times)


def check_tail_fused(dev, gen, skel):
    from tip_tpu_torch.ops import fused_tail as FT
    from tip_tpu_torch.ops import kinematics as kin
    tols = dict(pq_com=TOL, pq_jf=TOL, hist_sixd=TOL, c_locs=TOL,
                active=0.0, vel_res=TOL_RES, raw_res=TOL_RES)
    errs = {}
    inputs = None
    for _ in range(8):
        s = torch.randn(114, generator=gen, device=dev) * 0.4
        s[2] += 0.9
        ct = torch.randn(5, 4, generator=gen, device=dev)
        ct[:, 0] = (ct[:, 0] > 0).float()             # decoded flags
        ct[:, 1:] *= 0.05                             # decoded offsets
        ct = ct.reshape(-1)
        prev_s = s + torch.randn(114, generator=gen, device=dev) * 0.01
        prev_pq = kin.fk_our_state(skel, prev_s).contiguous()
        out = FT.tail_fused(skel, s, ct, prev_pq, impl="fused")
        ref = FT.tail_fused_plain(skel, s, ct, prev_pq)
        for f in out._fields:
            e = max_err(getattr(out, f), getattr(ref, f))
            errs[f] = (max(e, errs.get(f, (0.0, 0.0))[0]), tols[f])
        inputs = (s, ct, prev_pq)
    err = check("tail_fused", errs)
    s, ct, prev_pq = inputs
    times = timings(lambda: FT.tail_fused(skel, s, ct, prev_pq, impl="fused"),
                    lambda: FT.tail_fused_plain(skel, s, ct, prev_pq))
    J, L = skel.n_joints, skel.n_joints + 1
    # what the function reads: s[0:57] (root position + 18 axis-angles),
    # the 20 SBP floats, the 5 SBP rows of prev_pq, and the skeleton: both
    # offset tables and three int32 tables (parent, is_fixed, slot), which
    # the kernel reads packed as its FK plan; what it writes: TailOut
    nbytes = (4 * (57 + 20 + 5 * 7 + 3 * J + 3 * L + 3 * J)
              + 4 * (2 * 7 * L + 108 + 3 + 15 + 15 + 5))
    ops = (18 * OPS_AA_TO_Q + J * OPS_TREE_STEP + L * OPS_LINK_FRAME
           + 18 * OPS_HIST_ROW + 5 * OPS_SBP_RESIDUE + OPS_FEET_MEAN)
    b_ms, b_by = bound(nbytes, ops)
    return dict(name="tail_fused", route="cuda",
                source="tip_tpu_torch/csrc/fused_tail.cu",
                replaces="tip_tpu/ops/fused_tail.py:341", shape=[114],
                max_abs_err=err, tol=TOL_RES, bound_ms=b_ms, bound_by=b_by,
                **times)


def weight_bytes(cfg, itemsize):
    """Bytes of the packed weights: matrices and biases in the packing
    dtype, the LayerNorm vectors in f32."""
    d, ff, H, L = cfg.tf_in_dim, cfg.tf_hid_size, cfg.rnn_hid_size, \
        cfg.tf_layers
    n_w = (cfg.input_dim * d + d + L * (3 * d * d + 3 * d + d * d + d
                                        + 2 * d * ff + ff + d)
           + d * H + H + H * H + H * cfg.size_s + cfg.size_s)
    return n_w * itemsize + L * 4 * d * 4


def forward_ops(cfg, T, rows_out):
    """Operations of one whole-model forward over T rows that emits
    rows_out rows: a multiply and an add per product term, the causal half
    of the attention, 8 per LayerNorm element, 5 per softmax entry, 1 per
    tanh."""
    d, ff, H, L = cfg.tf_in_dim, cfg.tf_hid_size, cfg.rnn_hid_size, \
        cfg.tf_layers
    causal = T * (T + 1) // 2
    return (2 * T * (cfg.input_dim * d + L * (4 * d * d + 2 * d * ff) + d * H)
            + L * (4 * d * causal + 5 * cfg.n_heads * causal + 2 * 8 * T * d)
            + 2 * T * H * H + T * H + 2 * rows_out * H * cfg.size_s)


def fused_forward_work(cfg, T, rows_out, itemsize):
    """Compulsory bytes and operations of one whole-model forward over T
    rows that emits rows_out rows: every packed weight, x and the output
    once (``forward_ops`` for the operations)."""
    nbytes = (weight_bytes(cfg, itemsize) + T * cfg.input_dim * 4
              + rows_out * cfg.size_s * 4)
    return nbytes, forward_ops(cfg, T, rows_out)


def fused_recompute_batch_work(cfg, T, k_last, itemsize):
    """Compulsory bytes and operations of K9 on these inputs: every packed
    weight once, the B windows, k_last and the B output rows; per stream
    the forward over the rows 0..k_last[b] that its output needs."""
    B = len(k_last)
    nbytes = (weight_bytes(cfg, itemsize) + B * T * cfg.input_dim * 4 + B * 4
              + B * cfg.size_s * 4)
    return nbytes, sum(forward_ops(cfg, k + 1, 1) for k in k_last)


def clock_split(what, clocked, unclocked):
    """A whole-model kernel's device time by phase (its per-phase clock):
    one clocked launch after a warm one; its output equals an unclocked
    launch's (TOL_SAME). clocked() returns (out, split, phases)."""
    clocked()                                            # warm
    y, split, n = clocked()
    check(f"{what} phases", {what: (max_err(y, unclocked()), TOL_SAME)})
    log(f"  {what} by phase ({n} phases): " + json.dumps(
        {k: round(v, 4) for k, v in split.items()}))
    return split


def check_fused_forward(dev, gen, model):
    """K4 and K5 against their plain versions at the runner's window
    (40, 221) and a short one (7, 221), both packing dtypes, at full width;
    then at the CPU tests' small widths."""
    from tip_tpu_torch.ops import fused_forward as FF
    cfg = model.cfg
    errs = {"last": {}, "all": {}}
    worst = {"last": 0.0, "all": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        ws = model.packed_weights(dt)
        for T in (40, 7):
            x = torch.randn(T, cfg.input_dim, generator=gen, device=dev)
            x[::3, 100] = float("nan")               # NaN history entries
            x[:, 90 + 108:90 + 111] = 5.0            # root-velocity columns
            full = FF.fused_forward(ws, x, cfg, impl="fused")
            e = max_err(full, FF.fused_forward_plain(ws, x, cfg))
            errs["all"][f"{name}_T{T}"] = (e, TOL_FF[name])
            worst["all"] = max(worst["all"], e)
            for k in sorted({0, 6, T - 1}):
                y = FF.fused_forward_last(ws, x, k, cfg, impl="fused")
                e = max_err(y, FF.fused_forward_last_plain(ws, x, k, cfg))
                errs["last"][f"{name}_T{T}_k{k}"] = (e, TOL_FF[name])
                errs["last"][f"{name}_T{T}_k{k}_vs_all"] = (
                    max_err(y, full[k]), TOL_SAME)
                worst["last"] = max(worst["last"], e)
    # the widths are arguments of the kernel: the CPU tests' small config
    # goes through the same code
    small = small_model(dev)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        ws = small.packed_weights(dt)
        for T in (1, 12, 40):
            x = torch.randn(T, cfg.input_dim, generator=gen, device=dev)
            full = FF.fused_forward(ws, x, small.cfg, impl="fused")
            y = FF.fused_forward_last(ws, x, T - 1, small.cfg, impl="fused")
            errs["all"][f"small_{name}_T{T}"] = (
                max_err(full, FF.fused_forward_plain(ws, x, small.cfg)),
                TOL_FF[name])
            errs["last"][f"small_{name}_T{T}_vs_all"] = (
                max_err(y, full[T - 1]), TOL_SAME)
    check("fused_forward_last", errs["last"])
    check("fused_forward", errs["all"])

    T = 40
    x = torch.randn(T, cfg.input_dim, generator=gen, device=dev)
    out = []
    for kname, rows_out, replaces, kernel, plain in (
            ("fused_forward_last", 1, "tip_tpu/ops/fused_forward.py:146",
             lambda ws: FF.fused_forward_last(ws, x, T - 1, cfg,
                                              impl="fused"),
             lambda ws: FF.fused_forward_last_plain(ws, x, T - 1, cfg)),
            ("fused_forward", T, "tip_tpu/ops/fused_forward.py:233",
             lambda ws: FF.fused_forward(ws, x, cfg, impl="fused"),
             lambda ws: FF.fused_forward_plain(ws, x, cfg))):
        # the entry's own numbers are bf16 packing (the fused path's
        # default, path B); f32 packing (path C) rides beside them
        ws16 = model.packed_weights(torch.bfloat16)
        ws32 = model.packed_weights(torch.float32)
        t16 = timings(lambda: kernel(ws16), lambda: plain(ws16))
        t32 = timings(lambda: kernel(ws32), lambda: plain(ws32))
        k = T - 1 if rows_out == 1 else None
        c16, c32 = (clock_split(
            f"{kname} {name}", lambda: FF.forward_phases(ws, x, k, cfg),
            lambda: kernel(ws)) for name, ws in (("bfloat16", ws16),
                                                 ("float32", ws32)))
        b16 = bound(*fused_forward_work(cfg, T, rows_out, 2),
                    PEAK_BF16_FLOP_S)
        b32 = bound(*fused_forward_work(cfg, T, rows_out, 4))
        key = "last" if rows_out == 1 else "all"
        out.append(dict(
            name=kname, route="cuda",
            source="tip_tpu_torch/csrc/fused_forward.cu", replaces=replaces,
            shape=[T, cfg.input_dim], packing="bfloat16",
            max_abs_err=worst[key], tol=TOL_FF["bfloat16"],
            bound_ms=b16[0], bound_by=b16[1], **t16, clock_ms=c16,
            f32_packing=dict(ms=t32["ms"], plain_ms=t32["plain_ms"],
                             call_ms=t32["call_ms"],
                             plain_call_ms=t32["plain_call_ms"],
                             bound_ms=b32[0], bound_by=b32[1],
                             tol=TOL_FF["float32"], clock_ms=c32)))
    return out


def check_fk_bullet_fused(dev, gen, skel):
    from tip_tpu_torch.ops import fused_tail as FT
    from tip_tpu_torch.ops import kinematics as kin
    errs = {}
    pose = None
    for _ in range(8):
        s = torch.randn(114, generator=gen, device=dev) * 0.4
        s[2] += 0.9
        pose = kin.our_pose_to_bullet(s).contiguous()
        out = kin.fk_bullet_fused(skel, pose, impl="kernel")
        ref = kin.fk_bullet_fused_plain(skel, pose)
        # K3 walks the same tree over the same pose
        k3 = FT.tail_fused(skel, s, torch.zeros(20, device=dev),
                           ref[0].contiguous(), impl="fused")
        for f, a, b, c in (("pq_com", out[0], ref[0], k3.pq_com),
                           ("pq_jf", out[1], ref[1], k3.pq_jf)):
            errs[f] = (max(max_err(a, b), errs.get(f, (0.0,))[0]), TOL)
            errs[f + "_vs_tail_fused"] = (
                max(max_err(a, c), errs.get(f + "_vs_tail_fused", (0.0,))[0]),
                TOL_SAME)
    err = max(errs["pq_com"][0], errs["pq_jf"][0])
    check("fk_bullet_fused", errs)
    times = timings(lambda: kin.fk_bullet_fused(skel, pose, impl="kernel"),
                    lambda: kin.fk_bullet_fused_plain(skel, pose))
    J, L = skel.n_joints, skel.n_joints + 1
    # the pose and the skeleton (both offset tables and the three int32
    # tables, packed as the FK plan in the kernel) in; the CoM and joint
    # frames out
    nbytes = 4 * (57 + 3 * J + 3 * L + 3 * J) + 4 * 2 * 7 * L
    ops = 18 * OPS_AA_TO_Q + J * OPS_TREE_STEP + L * OPS_LINK_FRAME
    b_ms, b_by = bound(nbytes, ops)
    return dict(name="fk_bullet_fused", route="cuda",
                source="tip_tpu_torch/csrc/fused_fk.cu",
                replaces="tip_tpu/ops/kinematics.py:320", shape=[57],
                max_abs_err=err, tol=TOL, bound_ms=b_ms, bound_by=b_by,
                **times)


def fused_cached_work(cfg, W, itemsize, rnn_carry, steps, B=1):
    """Compulsory bytes and operations of one cached step of B committed
    streams (K7: B = 1; K8): every packed weight once; per stream the
    token, the K/V rings and (replay) the encoder ring or (carry) the
    hidden read once, the written rows, the hidden, the validity byte and y
    written once. A multiply and an add per product term, W keys per head,
    8 per LayerNorm element, 5 per softmax entry, 1 per tanh; the replay's
    W x d x H input product per stream and `steps` RNN steps (the valid
    slots of this call's rings, summed over the streams)."""
    d, ff, H, L = cfg.tf_in_dim, cfg.tf_hid_size, cfg.rnn_hid_size, \
        cfg.tf_layers
    nbytes = weight_bytes(cfg, itemsize) + B * (
        cfg.input_dim * 4 + 2 * L * W * d * itemsize + W
        + (2 * L + 1) * d * itemsize + 1 + cfg.size_s * 4)
    ops = B * (2 * (cfg.input_dim * d + L * (4 * d * d + 2 * d * ff) + d * H)
               + L * (4 * d * W + 5 * cfg.n_heads * W + 2 * 8 * d)
               + 2 * H * cfg.size_s)
    if rnn_carry:
        nbytes += B * 2 * H * itemsize
        ops += B * (2 * H * H + H)
    else:
        nbytes += B * W * d * itemsize
        ops += B * 2 * (W - 1) * d * H + steps * (2 * H * H + H)
    if B > 1:
        nbytes += B             # the commit flags
    return nbytes, ops


def check_fused_cached(dev, gen, model):
    """K7 against its plain version: a stream of 2 W + 3 tokens (the cursor
    wraps) entered at slot 5 with an uncommitted step in the middle, both
    packing dtypes, both RNN variants, at full width over 40 slots and at
    the CPU tests' small width over 8. y is compared every step, the rings,
    h and the validity bits at the end; after the uncommitted step the
    kernel's cache equals its clone bit for bit. Timed at a slot of a full
    window."""
    from tip_tpu_torch.runtime import streaming_cache as SC
    small = small_model(dev)
    errs, worst, timed = {}, {}, {}
    for tag, mdl, W in (("full", model, 40), ("small", small, 8)):
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            cfg = dataclasses.replace(mdl.cfg, compute_dtype=name)
            ws = mdl.packed_weights(dt)
            for rnn_carry in (False, True):
                key = f"{tag}_{name}_{'carry' if rnn_carry else 'replay'}"
                ck = SC.cache_init(cfg, W, device=dev)
                cp = SC.cache_init(cfg, W, device=dev)
                e_y = 0.0
                for step in range(2 * W + 3):
                    x = torch.randn(cfg.input_dim, generator=gen, device=dev)
                    if step % 3 == 0:
                        x[100] = float("nan")        # a NaN history entry
                    x[90 + 108:90 + 111] = 5.0       # root-velocity columns
                    commit = step != W + 1
                    slot = (step + 5) % W
                    before = ck.clone()
                    _, y = SC.fused_cached_step_slot(
                        ws, ck, x, slot, commit, cfg, rnn_carry=rnn_carry,
                        impl="fused")
                    _, ref = SC.fused_cached_forward_step_plain(
                        ws, cp, x, slot, commit, cfg, rnn_carry=rnn_carry)
                    e_y = max(e_y, max_err(y, ref))
                    if not commit and not all(
                            torch.equal(getattr(before, n), getattr(ck, n))
                            for n in ("k", "v", "enc", "h", "valid")):
                        raise AssertionError(
                            f"fused_cached_forward_step.{key}: an "
                            f"uncommitted step changed the cache")
                errs[f"{key}_y"] = (e_y, TOL_FF[name])
                worst[(name, rnn_carry)] = max(
                    worst.get((name, rnn_carry), 0.0), e_y)
                for n in ("k", "v", "enc", "h"):
                    a, b = getattr(ck, n).float(), getattr(cp, n).float()
                    tol = TOL_FF[name] if dt == torch.float32 else \
                        TOL_RING_BF16_REL * max(1.0, b.abs().max().item())
                    errs[f"{key}_{n}"] = (max_err(a, b), tol)
                if not torch.equal(ck.valid, cp.valid):
                    raise AssertionError(f"{key}: validity bits differ")
                if tag == "full":
                    timed[(name, rnn_carry)] = (cfg, ws, ck, cp, x)
    check("fused_cached_forward_step", errs)

    variants = {}
    for (name, rnn_carry), (cfg, ws, ck, cp, x) in timed.items():
        W = ck.enc.shape[0]
        t = timings(
            lambda: SC.fused_cached_step_slot(ws, ck, x, 7, True, cfg,
                                              rnn_carry=rnn_carry,
                                              impl="fused"),
            lambda: SC.fused_cached_forward_step_plain(ws, cp, x, 7, True,
                                                       cfg,
                                                       rnn_carry=rnn_carry))
        var = f"{'carry' if rnn_carry else 'replay'}_{name}"
        clock = clock_split(
            f"fused_cached_forward_step {var}",
            lambda: SC.cached_step_phases(ws, ck.clone(), x, 7, True, cfg,
                                          rnn_carry=rnn_carry),
            lambda: SC.fused_cached_step_slot(ws, ck.clone(), x, 7, True, cfg,
                                              rnn_carry=rnn_carry,
                                              impl="fused")[1])
        steps = int(ck.valid.sum().item())           # the ring is full: W
        b_ms, b_by = bound(
            *fused_cached_work(cfg, W, 4 if name == "float32" else 2,
                               rnn_carry, steps),
            PEAK_F32_FLOP_S if name == "float32" else PEAK_BF16_FLOP_S)
        variants[var] = dict(
            ms=t["ms"], plain_ms=t["plain_ms"], call_ms=t["call_ms"],
            plain_call_ms=t["plain_call_ms"], bound_ms=b_ms, bound_by=b_by,
            rnn_steps=steps, max_abs_err=worst[(name, rnn_carry)],
            tol=TOL_FF[name], clock_ms=clock)
    # the entry's own numbers are path D's: replay, f32 rings
    own = variants.pop("replay_float32")
    own.pop("rnn_steps")
    return dict(name="fused_cached_forward_step", route="cuda",
                source="tip_tpu_torch/csrc/fused_cached.cu",
                replaces="tip_tpu/runtime/streaming_cache.py:341",
                shape=[model.cfg.input_dim], variant="replay_float32",
                ring_slots=40, library_ms=None, library_call_ms=None, **own,
                variants=variants)


def small_model(dev):
    """The CPU tests' small widths (edges everywhere: 32 output columns of a
    256-column unit, 8-wide heads, fewer W_hh columns than blocks)."""
    from tip_tpu_torch.models import tip_model as M
    return M.TIPModel(M.ModelConfig(tf_in_dim=32, tf_hid_size=64, n_heads=4,
                                    tf_layers=2, rnn_hid_size=24,
                                    forward_impl="fused"), device=dev,
                      generator=torch.Generator().manual_seed(2))


def wide_head_model(dev):
    """Heads 48 wide, which do not divide a warp: in K8's attention a lane
    takes two output channels or one."""
    from tip_tpu_torch.models import tip_model as M
    return M.TIPModel(M.ModelConfig(tf_in_dim=96, tf_hid_size=64, n_heads=2,
                                    tf_layers=1, rnn_hid_size=24,
                                    forward_impl="fused"), device=dev,
                      generator=torch.Generator().manual_seed(3))


def check_batched_tail(dev, gen, skel, B=POOL_CAPACITY):
    """K2, K3 and K6 with a leading stream axis (one launch of B blocks)
    against B unbatched calls (the same device code on the same values, so
    TOL_SAME) and against their plain versions on the same B inputs (the
    single-stream tolerances); and their device time at the pool's B beside
    one stream's."""
    from tip_tpu_torch.ops import fused_tail as FT
    from tip_tpu_torch.ops import kinematics as kin
    x = tail_inputs(B, dev, gen, skel)
    coeff, y_t, filt, local9, flags = (x[k] for k in ("coeff", "y_t", "filt",
                                                      "local9", "flags"))
    s, ct, prev, pose = (x[k] for k in ("s", "ct", "prev", "pose"))

    def nn(a):
        return torch.nan_to_num(a)

    dec = FT.decode_fused(y_t, filt, coeff, flags, local9, impl="fused")
    tail = FT.tail_fused(skel, s, ct, prev, impl="fused")
    fk = kin.fk_bullet_fused(skel, pose, impl="kernel")
    host_flags = flags.tolist()
    e = {"decode_fused": 0.0, "tail_fused": 0.0, "fk_bullet_fused": 0.0}
    for b in range(B):
        one = FT.decode_fused(y_t[b], filt[b], coeff, host_flags[b],
                              local9[b], impl="fused")
        e["decode_fused"] = max(e["decode_fused"], *(
            max_err(getattr(dec, f)[b], getattr(one, f)) for f in dec._fields))
        one = FT.tail_fused(skel, s[b], ct[b], prev[b], impl="fused")
        e["tail_fused"] = max(e["tail_fused"], *(
            max_err(nn(getattr(tail, f)[b]), nn(getattr(one, f)))
            for f in tail._fields))
        one = kin.fk_bullet_fused(skel, pose[b], impl="kernel")
        e["fk_bullet_fused"] = max(e["fk_bullet_fused"],
                                   max_err(fk[0][b], one[0]),
                                   max_err(fk[1][b], one[1]))
    check("batched vs unbatched", {k: (v, TOL_SAME) for k, v in e.items()})
    # and each against its plain version on the same B inputs
    ref = FT.decode_fused_plain(y_t, filt, coeff, flags, local9)
    e_plain = {"decode_fused": check("decode_fused batched vs plain", {
        f: (max_err(getattr(dec, f), getattr(ref, f)), TOL)
        for f in dec._fields})}
    ref = FT.tail_fused_plain(skel, s, ct, prev)
    tols = dict(pq_com=TOL, pq_jf=TOL, hist_sixd=TOL, c_locs=TOL,
                active=0.0, vel_res=TOL_RES, raw_res=TOL_RES)
    e_plain["tail_fused"] = check("tail_fused batched vs plain", {
        f: (max_err(getattr(tail, f), getattr(ref, f)), tols[f])
        for f in tail._fields})
    ref = kin.fk_bullet_fused_plain(skel, pose)
    e_plain["fk_bullet_fused"] = check("fk_bullet_fused batched vs plain", {
        "pq_com": (max_err(fk[0], ref[0]), TOL),
        "pq_jf": (max_err(fk[1], ref[1]), TOL)})
    ms = {"decode_fused": graph_ms(lambda: FT.decode_fused(
              y_t, filt, coeff, flags, local9, impl="fused")),
          "tail_fused": graph_ms(lambda: FT.tail_fused(skel, s, ct, prev,
                                                       impl="fused")),
          "fk_bullet_fused": graph_ms(lambda: kin.fk_bullet_fused(
              skel, pose, impl="kernel"))}
    log(f"  batched K2/K3/K6 at B={B}: max |batched - unbatched| {e}, "
        f"max |batched - plain| {e_plain}, device ms {ms}")
    return {k: dict(batch=B, ms=v, max_abs_err_vs_unbatched=e[k],
                    max_abs_err_vs_plain=e_plain[k])
            for k, v in ms.items()}


def _masked(ring, valid):
    """A pool's ring with its invalid slots zeroed: k, v (B, L, W, d) or
    enc (B, W, d)."""
    m = valid[:, None, :, None] if ring.dim() == 4 else valid[:, :, None]
    return ring.float() * m


# K8's variants whose device time chip_smoke.py splits by phase
K8_CLOCKED = (("replay", "float32", POOL_CAPACITY),
              ("carry", "bfloat16", POOL_CAPACITY), ("replay", "float32", 256))


def cached_batch_clock(ws, cache, x, commit, cfg, rnn_carry, what):
    """K8's device time by phase (its per-phase clock), one launch at slot 7
    after a warm one, on a copy of ``cache``; its y equals a launch without
    the clock on another copy (TOL_SAME)."""
    from tip_tpu_torch.runtime import streaming_cache as SC
    SC.cached_batch_phases(ws, cache.clone(), x, 7, commit, cfg,
                           rnn_carry=rnn_carry)                  # warm
    y, split, n = SC.cached_batch_phases(ws, cache.clone(), x, 7, commit, cfg,
                                         rnn_carry=rnn_carry)
    _, ref = SC.fused_cached_batch(ws, cache.clone(), x, 7, commit, cfg,
                                   rnn_carry=rnn_carry, impl="fused")
    check("fused_cached_batch phases", {what: (max_err(y, ref), TOL_SAME)})
    log(f"  fused_cached_batch {what} by phase ({n} phases): " + json.dumps(
        {k: round(v, 4) for k, v in split.items()}))
    return split


def check_fused_cached_batch(dev, gen, model):
    """K8 against its plain version and against K7 stream by stream: B
    streams at one global cursor, joining at staggered ticks (commit false
    before a stream's join), 2 W + 3 ticks (the cursor wraps twice), both
    packing dtypes, both RNN variants, at B = 1, 5, 64 and 256 (where the
    replay's walk keeps 2 W_hh columns a thread) at full width over 40
    slots, B = 6 at the CPU tests' small width over 8 and B = 6 with heads
    48 wide over 12. y of the committed streams every tick; h, the validity
    bits and the valid-masked rings at the end; at B 256 every 32nd stream
    against its own K7. Timed at a slot of full rings at B = 64 and 256,
    and split by phase (K8_CLOCKED)."""
    from tip_tpu_torch.runtime import streaming_cache as SC
    small, wide = small_model(dev), wide_head_model(dev)
    errs, worst, worst7 = {}, {}, {}
    for tag, mdl, W, B in (("full", model, 40, 1), ("full", model, 40, 5),
                           ("full", model, 40, POOL_CAPACITY),
                           ("full", model, 40, 256),
                           ("small", small, 8, 6), ("wide", wide, 12, 6)):
        held = range(0, B, 32 if B > POOL_CAPACITY else 1)
        joins = [(5 * b) % (W + 3) for b in range(B)]
        joins_t = torch.tensor(joins, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            cfg = dataclasses.replace(mdl.cfg, compute_dtype=name)
            ws = mdl.packed_weights(dt)
            for rnn_carry in (False, True):
                var = "carry" if rnn_carry else "replay"
                key = f"{tag}_B{B}_{name}_{var}"
                ck = SC.cache_init(cfg, W, device=dev, batch=B)
                cp = SC.cache_init(cfg, W, device=dev, batch=B)
                c7 = {b: SC.cache_init(cfg, W, device=dev) for b in held}
                e_y = e_7 = 0.0
                for step in range(2 * W + 3):
                    x = torch.randn(B, cfg.input_dim, generator=gen,
                                    device=dev)
                    if step % 3 == 0:
                        x[:, 100] = float("nan")     # a NaN history entry
                    x[:, 90 + 108:90 + 111] = 5.0    # root-velocity columns
                    commit = joins_t <= step
                    slot = (step + 5) % W
                    _, y = SC.fused_cached_batch(ws, ck, x, slot, commit, cfg,
                                                 rnn_carry=rnn_carry,
                                                 impl="fused")
                    _, ref = SC.fused_cached_batch_plain(
                        ws, cp, x, slot, commit, cfg, rnn_carry=rnn_carry)
                    e_y = max(e_y, max_err(y[commit], ref[commit]))
                    for b, c in c7.items():
                        if joins[b] <= step:
                            _, y7 = SC.fused_cached_step_slot(
                                ws, c, x[b], slot, True, cfg,
                                rnn_carry=rnn_carry, impl="fused")
                            e_7 = max(e_7, max_err(y[b], y7))
                errs[f"{key}_y"] = (e_y, TOL_FF[name])
                errs[f"{key}_y_vs_K7"] = (e_7, TOL_FF[name])
                worst[(name, rnn_carry)] = max(
                    worst.get((name, rnn_carry), 0.0), e_y)
                worst7[(name, rnn_carry)] = max(
                    worst7.get((name, rnn_carry), 0.0), e_7)
                if not torch.equal(ck.valid, cp.valid):
                    raise AssertionError(f"{key}: validity bits differ")
                for b, c in c7.items():
                    if not torch.equal(ck.valid[b], c.valid):
                        raise AssertionError(
                            f"{key}: stream {b}'s validity bits differ from "
                            f"the single-stream step's")
                for n in ("k", "v", "enc", "h"):
                    a, b_ = getattr(ck, n), getattr(cp, n)
                    if n != "h":
                        a, b_ = _masked(a, cp.valid), _masked(b_, cp.valid)
                    tol = TOL_FF[name] if dt == torch.float32 else \
                        TOL_RING_BF16_REL * max(1.0, b_.abs().max().item())
                    errs[f"{key}_{n}"] = (max_err(a.float(), b_.float()), tol)
    check("fused_cached_batch", errs)

    variants = {}
    for B in (POOL_CAPACITY, 256):
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            cfg = dataclasses.replace(model.cfg, compute_dtype=name)
            ws = model.packed_weights(dt)
            W = 40
            x = torch.randn(B, cfg.input_dim, generator=gen, device=dev)
            commit = torch.ones(B, dtype=torch.bool, device=dev)
            for rnn_carry in (False, True):
                ck = SC.cache_init(cfg, W, device=dev, batch=B)
                cp = SC.cache_init(cfg, W, device=dev, batch=B)
                for c in (ck, cp):           # full rings of plausible rows
                    for n in ("k", "v", "enc", "h"):
                        getattr(c, n).copy_(torch.randn(
                            getattr(c, n).shape, generator=gen, device=dev))
                    c.valid.fill_(True)
                t = timings(
                    lambda: SC.fused_cached_batch(ws, ck, x, 7, commit, cfg,
                                                  rnn_carry=rnn_carry,
                                                  impl="fused"),
                    lambda: SC.fused_cached_batch_plain(
                        ws, cp, x, 7, commit, cfg, rnn_carry=rnn_carry),
                    light=True)
                steps = int(ck.valid.sum().item())   # full rings: B * W
                b_ms, b_by = bound(
                    *fused_cached_work(cfg, W, 4 if name == "float32" else 2,
                                       rnn_carry, steps, B),
                    PEAK_F32_FLOP_S if name == "float32"
                    else PEAK_BF16_FLOP_S)
                var = "carry" if rnn_carry else "replay"
                variants[f"{var}_{name}_B{B}"] = dict(
                    ms=t["ms"], plain_ms=t["plain_ms"], call_ms=t["call_ms"],
                    plain_call_ms=t["plain_call_ms"], bound_ms=b_ms,
                    bound_by=b_by, rnn_steps=steps,
                    max_abs_err=worst[(name, rnn_carry)],
                    max_abs_err_vs_K7=worst7[(name, rnn_carry)],
                    tol=TOL_FF[name])
                if (var, name, B) in K8_CLOCKED:
                    variants[f"{var}_{name}_B{B}"]["phases_ms"] = \
                        cached_batch_clock(ws, ck, x, commit, cfg, rnn_carry,
                                           f"{var} {name} B {B}")
    for k, v in variants.items():
        log(f"  fused_cached_batch {k}: device {v['ms']:.4f} ms (eager "
            f"{v['call_ms']:.4f}), plain {v['plain_ms']:.4f} "
            f"({v['plain_call_ms']:.4f}), bound {v['bound_ms']:.2e} "
            f"({v['bound_by']})")
    # the entry's own numbers are path H's: replay, f32 rings, 64 streams
    own = variants.pop(f"replay_float32_B{POOL_CAPACITY}")
    own.pop("rnn_steps")
    return dict(name="fused_cached_batch", route="cuda",
                source="tip_tpu_torch/csrc/fused_cached_batch.cu",
                replaces="tip_tpu/runtime/streaming_cache.py:617",
                shape=[POOL_CAPACITY, model.cfg.input_dim],
                variant=f"replay_float32_B{POOL_CAPACITY}", ring_slots=40,
                library_ms=None, library_call_ms=None, **own,
                variants=variants)


def check_fused_recompute_batch(dev, gen, model):
    """K9 against its plain version and against K4 stream by stream: B
    windows of 40 rows with mixed k_last, NaN history entries and the
    root-velocity columns set, both packing dtypes, at B = 1, 5, 64 at full
    width and B = 6 at the small width. Timed at B = 64 and 256 with every
    window full (k_last 39), as a pool in its steady state, and split by
    phase at B = 64 (one launch with K9's per-phase clock, each packing)."""
    from tip_tpu_torch.ops import fused_forward as FF
    small = small_model(dev)
    errs, worst, worst4 = {}, {}, {}
    for tag, mdl, T, B in (("full", model, 40, 1), ("full", model, 40, 5),
                           ("full", model, 40, POOL_CAPACITY),
                           ("small", small, 12, 6)):
        cfg = mdl.cfg
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            ws = mdl.packed_weights(dt)
            x = torch.randn(B, T, cfg.input_dim, generator=gen, device=dev)
            x[:, ::3, 100] = float("nan")            # NaN history entries
            x[:, :, 90 + 108:90 + 111] = 5.0         # root-velocity columns
            ks = [(0, 3, 17, T - 1)[b % 4] % T for b in range(B)]
            y = FF.fused_recompute_batch(ws, x, ks, cfg, impl="fused")
            e = max_err(y, FF.fused_recompute_batch_plain(ws, x, ks, cfg))
            e4 = max(max_err(y[b], FF.fused_forward_last(ws, x[b], ks[b], cfg,
                                                         impl="fused"))
                     for b in range(B))
            errs[f"{tag}_B{B}_{name}"] = (e, TOL_FF[name])
            # K9's products (tensor cores) and K4's (CUDA cores) sum in
            # another order: K4 is held to its own plain version, so the
            # two kernels to the same tolerance
            errs[f"{tag}_B{B}_{name}_vs_K4"] = (e4, TOL_FF[name])
            worst[name] = max(worst.get(name, 0.0), e)
            worst4[name] = max(worst4.get(name, 0.0), e4)
        try:
            FF.fused_recompute_batch(ws, x, [T] * B, cfg, impl="fused")
        except IndexError:
            pass
        else:
            raise AssertionError("fused_recompute_batch took k_last = T")
    check("fused_recompute_batch", errs)

    cfg, T = model.cfg, 40
    variants = {}
    for B in (POOL_CAPACITY, 256):
        x = torch.randn(B, T, cfg.input_dim, generator=gen, device=dev)
        ks = [T - 1] * B
        k_dev = torch.tensor(ks, dtype=torch.int32, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            ws = model.packed_weights(dt)
            # the eager forms check k_last on the host and copy it up, as a
            # pool tick does; the captured forms take it on the device
            t = timings(
                lambda: FF.fused_recompute_batch(ws, x, ks, cfg,
                                                 impl="fused"),
                lambda: FF.fused_recompute_batch_plain(ws, x, ks, cfg),
                graph=(lambda: FF._launch_batch(ws, x, k_dev, cfg),
                       lambda: FF._recompute_batch_rows(ws, x, k_dev, cfg)),
                light=True)
            b_ms, b_by = bound(
                *fused_recompute_batch_work(
                    cfg, T, ks, 4 if name == "float32" else 2),
                PEAK_F32_FLOP_S if name == "float32" else PEAK_BF16_FLOP_S)
            variants[f"{name}_B{B}"] = dict(
                ms=t["ms"], plain_ms=t["plain_ms"], call_ms=t["call_ms"],
                plain_call_ms=t["plain_call_ms"], bound_ms=b_ms,
                bound_by=b_by, max_abs_err=worst[name],
                max_abs_err_vs_K4=worst4[name], tol=TOL_FF[name])
    for k, v in variants.items():
        log(f"  fused_recompute_batch {k}: device {v['ms']:.4f} ms (eager "
            f"{v['call_ms']:.4f}), plain {v['plain_ms']:.4f} "
            f"({v['plain_call_ms']:.4f}), bound {v['bound_ms']:.2e} "
            f"({v['bound_by']})")
    # the device time by phase, one launch each after the timed ones
    x = torch.randn(POOL_CAPACITY, T, cfg.input_dim, generator=gen,
                    device=dev)
    ks = [T - 1] * POOL_CAPACITY
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        ws = model.packed_weights(dt)
        FF.recompute_batch_phases(ws, x, ks, cfg)          # warm
        y, split, n = FF.recompute_batch_phases(ws, x, ks, cfg)
        check("fused_recompute_batch phases", {f"clock_{name}": (max_err(
            y, FF.fused_recompute_batch(ws, x, ks, cfg, impl="fused")),
            TOL_SAME)})
        variants[f"{name}_B{POOL_CAPACITY}"]["phases_ms"] = split
        log(f"  fused_recompute_batch {name} B {POOL_CAPACITY} by phase "
            f"({n} phases): " + json.dumps(
                {k: round(v, 4) for k, v in split.items()}))
    # the entry's own numbers are path J's: f32 packing, 64 streams
    own = variants.pop(f"float32_B{POOL_CAPACITY}")
    return dict(name="fused_recompute_batch", route="cuda",
                source="tip_tpu_torch/csrc/fused_recompute_batch.cu",
                replaces="tip_tpu/ops/fused_forward.py:328",
                shape=[POOL_CAPACITY, T, cfg.input_dim],
                variant=f"float32_B{POOL_CAPACITY}", library_ms=None,
                library_call_ms=None, **own, variants=variants)


# ---------------------------------------------------------------------------
# 4. the main paths
# ---------------------------------------------------------------------------

def load_motion():
    with open(MOTION, "rb") as f:     # in-tree motion written by data gen
        d = pickle.load(f)
    return d["imu"], d["nimble_qdq"][0]


def first_disagreement(a, b, tol):
    bad = ((a - b).abs() > tol).reshape(a.shape[0], -1).any(dim=1)
    idx = torch.nonzero(bad)
    return int(idx[0]) if idx.numel() else None


def compare_runs(what, runs_a, runs_b, frames, tol):
    for name, a, b in zip(("s_traj", "c_traj", "viz"), runs_a, runs_b):
        a, b = a[:frames].double().cpu(), b[:frames].double().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: {name} is not finite")
        err = (a - b).abs().max().item()
        log(f"  {what} {name}: max |diff| over {frames} frames = {err:.3g}")
        if not err <= tol:
            f0 = first_disagreement(a, b, tol)
            c = runs_a[1][:frames].cpu(), runs_b[1][:frames].cpu()
            flags = torch.nonzero((c[0][:, 0::4] != c[1][:, 0::4]).any(1))
            flip = int(flags[0]) if flags.numel() else None
            raise AssertionError(
                f"{what}: {name} differs by {err:.3g} > {tol:g}; first "
                f"frame out of tolerance {f0}, first SBP flag flip {flip}")


def stepper(model, cfg, skel, s_init, dev):
    """(carry, step) of the minimal runner for a RunnerConfig, of the full
    runner for a FullRunnerConfig: step(carry, imu_t) -> (carry', out),
    one frame with the fused weights packed once."""
    from tip_tpu_torch.runtime import full_runner as FR
    from tip_tpu_torch.runtime import runner as R
    if isinstance(cfg, FR.FullRunnerConfig):
        packed = R.pack_fused_weights(model, cfg.base)
        return (FR.full_runner_init(cfg, skel, s_init, device=dev),
                lambda c, x: FR.full_runner_step(model, c, x, cfg, skel,
                                                 packed_ws=packed))
    packed = R.pack_fused_weights(model, cfg)
    return (R.runner_init(cfg, skel, s_init, device=dev),
            lambda c, x: R.runner_step(model, c, x, cfg, skel, packed))


def n_smooth(cfg):
    base = getattr(cfg, "base", cfg)
    return base.imu_n_smooth


def frame_times_ms(model, cfg, skel, s_init, imu, dev):
    """Per-frame host time of a runner step (runner_step, or
    full_runner_step for a FullRunnerConfig) with a synchronise after each
    frame (eager launches), over the frames that run the model among the
    first TIMED_FRAMES (the window has slid long before the last)."""
    carry, step = stepper(model, cfg, skel, s_init, dev)
    imu = torch.as_tensor(imu[:TIMED_FRAMES + 1], dtype=torch.float32,
                          device=dev)
    times = []
    with torch.no_grad():
        for t in range(imu.shape[0] - 1):
            t0 = time.perf_counter()
            carry, _ = step(carry, imu[t])
            torch.cuda.synchronize()
            if t >= n_smooth(cfg):
                times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_frames(model, cfg, skel, s_init, imu, dev, first=100,
                   n=PROFILED_FRAMES):
    """Device time per frame by kernel over n steady frames
    (torch.profiler), from frame `first` on, and the median host time of
    those same frames (synchronised each frame, profiler on)."""
    from torch.profiler import ProfilerActivity, profile
    carry, step = stepper(model, cfg, skel, s_init, dev)
    imu = torch.as_tensor(imu, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for t in range(first):
            carry, _ = step(carry, imu[t])
        torch.cuda.synchronize()
        times = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for t in range(first, first + n):
                t0 = time.perf_counter()
                carry, _ = step(carry, imu[t])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return (sum(r[1] for r in rows), sum(r[2] for r in rows), rows,
            statistics.median(times))


def host_syncs(model, cfg, skel, s_init, imu, dev, first=100, n=50):
    """Host synchronisations a steady frame: the warnings of
    torch.cuda.set_sync_debug_mode("warn") counted over n frames from
    frame `first` on, divided by n."""
    import warnings
    carry, step = stepper(model, cfg, skel, s_init, dev)
    imu = torch.as_tensor(imu, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for t in range(first):
            carry, _ = step(carry, imu[t])
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for t in range(first, first + n):
                    carry, _ = step(carry, imu[t])
            finally:
                torch.cuda.set_sync_debug_mode("default")
    # torch also warns once that the debug mode is a prototype
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    return len(syncs) / n, sorted({str(w.message)[:80] for w in syncs})


def run_path(name, model, cfg, skel, s_init, imu, dev, on_path):
    """Drive one path over the whole motion through run_offline with the
    launch counters set to 0 just before and read just after. Every kernel
    in on_path must have been launched once per model frame (or as often
    as on_path says) and every other kernel not at all; the outputs must be
    finite and of the expected shape."""
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.runtime import runner as R
    n_frames = imu.shape[0] - 1
    n_model = sum(1 for t in range(n_frames) if t >= cfg.imu_n_smooth)
    # on_path: the kernels of the path, or {kernel: launches a frame}
    per_frame = (on_path if isinstance(on_path, dict)
                 else dict.fromkeys(on_path, 1))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    runs = R.run_offline(model, cfg, skel, s_init, imu, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    log(f"path {name}: {n_frames} frames in {wall:.3f} s "
        f"({wall / n_frames * 1e3:.3f} ms/frame, no per-frame sync); "
        f"launches {launches}")
    for k in KERNELS:
        want = n_model * per_frame.get(k, 0)
        if launches[k] != want:
            raise AssertionError(
                f"path {name}: {k} launched {launches[k]} times, expected "
                f"{want} ({n_model} model frames)")
    for a, shape in zip(runs, [(imu.shape[0], 114), (imu.shape[0], 20),
                               (imu.shape[0], 5, 3)]):
        if tuple(a.shape) != shape or not torch.isfinite(a).all():
            raise AssertionError(f"path {name}: output {tuple(a.shape)} is "
                                 f"not a finite {shape}")
    return runs, launches


def model_windows(model, cfg, skel, s_init, imu, dev, packed=None):
    """Step the single-stream runner over imu and record every frame that
    ran the model: its window rebuilt from the carries (x_imu (40, ·), x_s
    (40, ·)), the window's last valid row k-1 and the output y_t the frame
    produced."""
    from tip_tpu_torch.runtime import runner as R
    carry = R.runner_init(cfg, skel, s_init, device=dev)
    imu = torch.as_tensor(imu, dtype=torch.float32, device=dev)
    records = []
    with torch.no_grad():
        for t in range(imu.shape[0] - 1):
            new, _ = R.runner_step(model, carry, imu[t], cfg, skel, packed)
            if new.n_out > carry.n_out:              # the model ran
                x_imu, x_s = R.model_window(cfg, new.imu_win, new.accsum_win,
                                            carry.s_and_c_win)
                records.append((x_imu, x_s, min(new.k, cfg.window) - 1,
                                new.out_buf[-1].clone()))
            carry = new
    return records


def replay_path_b(model, cfg, skel, s_init, imu, dev):
    """Path B teacher-forced: a free-running bf16 trajectory of a random
    model drifts from the f32 one chaotically, so each frame is held on its
    own. Step the runner, rebuild every frame's model input from the
    carries and read the raw output y_t it produced (K4); then push every
    recorded window through K5 and through the plain version and compare
    row k-1 with the recorded y_t. Returns K5's launches and the errors."""
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import fused_forward as FF
    from tip_tpu_torch.runtime import runner as R
    packed = R.pack_fused_weights(model, cfg)
    records = [(torch.cat([x_imu, x_s], dim=-1), k, y_t) for x_imu, x_s, k, y_t
               in model_windows(model, cfg, skel, s_init, imu, dev, packed)]
    with torch.no_grad():
        K.reset_launch_counts()
        e_k5 = e_plain = 0.0
        for x, k, y_t in records:
            full = FF.fused_forward(packed, x, cfg.model, impl="fused")
            e_k5 = max(e_k5, max_err(full[k], y_t))
        torch.cuda.synchronize()
        launches = K.launch_counts.get("fused_forward", 0)
        others = sum(K.launch_counts.values()) - launches
        for x, k, y_t in records:
            e_plain = max(e_plain, max_err(
                FF.fused_forward_last_plain(packed, x, k, cfg.model), y_t))
    if launches != len(records) or others:
        raise AssertionError(f"replay: fused_forward launched {launches} "
                             f"times for {len(records)} windows, other "
                             f"kernels {others}")
    check("path B replay", {"K5_row_vs_recorded_K4": (e_k5, TOL_SAME),
                            "plain_vs_recorded_K4":
                                (e_plain, TOL_FF["bfloat16"])})
    log(f"  path B teacher-forced over {len(records)} windows: max |K5 row "
        f"- K4| = {e_k5:.3g}, max |plain - K4| = {e_plain:.3g}")
    return launches


def replay_path_e(model, cfg, skel, s_init, imu, dev):
    """Path E (or N-E, the full runner's) teacher-forced: its bf16
    free-running trajectory drifts from any other run chaotically, so each
    frame is held on its own. Step the runner with the cached step's
    wrapper recording every token, cursor and raw output y_t (K7); then
    feed the recorded tokens from a fresh cache through K7's plain version
    and compare frame by frame."""
    from tip_tpu_torch.runtime import runner as R
    from tip_tpu_torch.runtime import streaming_cache as SC
    records = []
    wrapper = SC.fused_cached_step_slot

    def recording(ws, cache, x, slot, commit, mcfg, **kw):
        out = wrapper(ws, cache, x, slot, commit, mcfg, **kw)
        records.append((x.clone(), slot, out[1].clone()))
        return out

    carry, step = stepper(model, cfg, skel, s_init, dev)
    imu = torch.as_tensor(imu, dtype=torch.float32, device=dev)
    mcfg = getattr(cfg, "base", cfg)
    packed = R.pack_fused_weights(model, mcfg)
    SC.fused_cached_step_slot = recording
    try:
        with torch.no_grad():
            for t in range(imu.shape[0] - 1):
                carry, _ = step(carry, imu[t])
    finally:
        SC.fused_cached_step_slot = wrapper
    cache_now = getattr(carry, "base", carry).cache
    cache = SC.cache_init(mcfg.model, mcfg.window, device=dev)
    err = 0.0
    with torch.no_grad():
        for x, slot, y_t in records:
            _, ref = SC.fused_cached_forward_step_plain(
                packed, cache, x, slot, True, mcfg.model, rnn_carry=True)
            err = max(err, max_err(ref, y_t))
    for n in ("k", "v", "enc", "h"):
        a, b = getattr(cache_now, n).float(), getattr(cache, n).float()
        check("path E replay", {f"ring_{n}": (
            max_err(a, b),
            TOL_RING_BF16_REL * max(1.0, b.abs().max().item()))})
    check("path E replay", {"plain_vs_recorded_K7":
                            (err, TOL_FF["bfloat16"])})
    log(f"  teacher-forced over {len(records)} frames: max |plain - "
        f"K7| = {err:.3g}")
    return len(records)


class PlainVersions:
    """Within this context the model's K11 and K1 wrappers run their plain
    versions on the card's tensors (``impl="plain"``): the twins the
    teacher-forced checks hold the kernels' outputs against. This is not
    the plain layer loop of ``encoder_impl="plain"``, which rounds bf16 at
    other places than tip_tpu's kernels."""

    def __enter__(self):
        from tip_tpu_torch.models import tip_model as M
        self.saved = M.encoder_layer_fwd, M.fused_rnn
        enc, rnn = self.saved
        M.encoder_layer_fwd = lambda *a, **kw: enc(*a, **dict(kw,
                                                             impl="plain"))
        M.fused_rnn = lambda *a, **kw: rnn(*a, **dict(kw, impl="plain"))

    def __exit__(self, *exc):
        from tip_tpu_torch.models import tip_model as M
        M.encoder_layer_fwd, M.fused_rnn = self.saved


class RecordCalls:
    """Within this context the model's K11 and K1 wrappers record every
    bf16 call they make: ``calls[kernel]`` holds (the call's arguments,
    its output) for "encoder_layer_fwd_bf16" and "fused_rnn_bf16"."""

    def __enter__(self):
        from tip_tpu_torch.models import tip_model as M
        self.saved = M.encoder_layer_fwd, M.fused_rnn
        self.calls = {"encoder_layer_fwd_bf16": [], "fused_rnn_bf16": []}

        def recording(fn, name):
            def call(*a, **kw):
                out = fn(*a, **kw)
                if a[0].dtype == torch.bfloat16:
                    self.calls[name].append((
                        (a[0].clone(),) + a[1:], out.clone()))
                return out
            return call

        M.encoder_layer_fwd = recording(self.saved[0],
                                        "encoder_layer_fwd_bf16")
        M.fused_rnn = recording(self.saved[1], "fused_rnn_bf16")
        return self

    def __exit__(self, *exc):
        from tip_tpu_torch.models import tip_model as M
        M.encoder_layer_fwd, M.fused_rnn = self.saved


def hold_calls(what, calls):
    """Every bf16 K11 and K1 call a path made (RecordCalls.calls), each on
    its own inputs against its plain version: the max error (K11's
    relative to the largest entry) within TOL_ENC_BF16 / TOL_RNN_BF16, and
    the rounding check (check_rounding) with the controls that need no
    library module beside the path's (K1's cuDNN RNN is made once). Returns
    {kernel: {calls, max_err, rounding}}."""
    from tip_tpu_torch.ops import encoder_train as ET
    from tip_tpu_torch.ops import fused_rnn as FR
    out = {}
    with torch.no_grad():
        share, controls, err = OffShare(), {}, 0.0
        for (x, ws, seed, nh, p, train, bt), y in calls[
                "encoder_layer_fwd_bf16"]:
            if train:
                raise AssertionError(f"{what}: K11 called with train on")
            yr = ET.encoder_layer_train_plain(x, ws, seed, nh, p, train, bt)
            share.add(y, yr)
            err = max(err, rel_err(y, yr))
            for c, yc in (
                    ("attention_unrounded",
                     encoder_attention_unrounded(x, ws, nh)),
                    ("f32_widened", ET.encoder_layer_train_plain(
                        x.float(), tuple(w.float() for w in ws), seed, nh, p,
                        train, bt).to(x.dtype))):
                controls.setdefault(c, OffShare()).add(yc, yr)
        check(f"{what} K11 bf16 calls", {"plain_vs_K11": (err,
                                                          TOL_ENC_BF16)})
        out["encoder_layer_fwd_bf16"] = dict(
            calls=len(calls["encoder_layer_fwd_bf16"]), max_err=err,
            rounding=check_rounding("encoder_layer_fwd_bf16", share,
                                    controls))
        share, controls, err, rnn = OffShare(), {}, 0.0, None
        for (xin, w), hs in calls["fused_rnn_bf16"]:
            if rnn is None:
                rnn = cudnn_rnn(w, w.shape[0], w.device)
            err = max(err, max_err(hs.float(),
                                   FR.fused_rnn_plain(xin, w).float()))
            share.add(hs, rnn_steps_plain(xin, w, hs))
            for c, hc in rnn_controls(xin, w, rnn).items():
                controls.setdefault(c, OffShare()).add(
                    hc, rnn_steps_plain(xin, w, hc))
        check(f"{what} K1 bf16 calls", {"plain_vs_K1": (err, TOL_RNN_BF16)})
        out["fused_rnn_bf16"] = dict(
            calls=len(calls["fused_rnn_bf16"]), max_err=err,
            rounding=check_rounding("fused_rnn_bf16", share, controls))
    log(f"  {what}: every K11 and K1 bf16 call on its own inputs: "
        f"{json.dumps(out)}")
    return out


def replay_path_a_bf16(model, cfg, skel, s_init, imu, dev):
    """Path A-bf16 teacher-forced: a free-running bf16 trajectory of a
    random model drifts from any other run chaotically, so each frame is
    held on its own. Step the runner, rebuild every frame's model window
    from the carries and read the output y_t it produced (K11 and K1 in
    bf16), recording every K11 and K1 call (hold_calls holds each against
    its plain version, rounding included); then push every window through
    the same model with K11's and K1's plain versions and compare row k-1
    with y_t. Returns the number of windows and hold_calls' readings."""
    with RecordCalls() as rec:
        records = model_windows(model, cfg, skel, s_init, imu, dev)
    n_calls = {k: len(v) for k, v in rec.calls.items()}
    want = {"encoder_layer_fwd_bf16": cfg.model.tf_layers * len(records),
            "fused_rnn_bf16": len(records)}
    if n_calls != want:
        raise AssertionError(f"path A-bf16 replay recorded {n_calls} calls "
                             f"for {len(records)} windows, expected {want}")
    calls = hold_calls("path A-bf16", rec.calls)
    err = 0.0
    with torch.no_grad(), PlainVersions():
        for x_imu, x_s, k, y_t in records:
            err = max(err, max_err(model(x_imu[None], x_s[None])[0, k], y_t))
    check("path A-bf16 replay", {"plain_vs_recorded_K11_K1":
                                 (err, TOL_FF["bfloat16"])})
    log(f"  path A-bf16 teacher-forced over {len(records)} windows: max "
        f"|plain versions - K11, K1 bf16| = {err:.3g}")
    return len(records), calls


def main_paths(dev):
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.ops import metrics
    from tip_tpu_torch.runtime import runner as R

    imu, s_init = load_motion()
    imu = imu[:MAIN_FRAMES + 1]
    skel = kin.amass_skeleton(device=dev)
    plain_enc = dict(encoder_impl="plain")
    cfgs = {
        # rnn_impl / tail_impl "auto"
        "A": R.RunnerConfig(model=M.ModelConfig(**plain_enc)),
        "A-enc": R.RunnerConfig(model=M.ModelConfig(encoder_impl="kernel")),
        # every setting at its default but the compute dtype
        "A-bf16": R.RunnerConfig(model=M.ModelConfig(
            compute_dtype="bfloat16")),
        "B": R.RunnerConfig(model=M.ModelConfig(forward_impl="fused")),
        "C": R.RunnerConfig(model=M.ModelConfig(forward_impl="fused",
                                                compute_dtype="float32",
                                                **plain_enc),
                            tail_impl="plain", fk_impl="kernel"),
        "plain": R.RunnerConfig(model=M.ModelConfig(rnn_impl="plain",
                                                    **plain_enc),
                                tail_impl="plain"),
        "D": R.RunnerConfig(model=M.ModelConfig(forward_impl="fused",
                                                compute_dtype="float32"),
                            serving_mode="kv_cache"),
        "E": R.RunnerConfig(model=M.ModelConfig(forward_impl="fused",
                                                compute_dtype="bfloat16"),
                            serving_mode="kv_cache_rnn_carry"),
        "F": R.RunnerConfig(model=M.ModelConfig(**plain_enc),
                            serving_mode="kv_cache"),
    }
    k7 = "fused_cached_forward_step"
    on_path = {"A": ("fused_rnn", "decode_fused", "tail_fused"),
               "A-enc": {"fused_rnn": 1, "decode_fused": 1, "tail_fused": 1,
                         "encoder_layer_fwd": 4},
               "A-bf16": {"fused_rnn_bf16": 1, "decode_fused": 1,
                          "tail_fused": 1, "encoder_layer_fwd_bf16": 4},
               "B": ("fused_forward_last", "decode_fused", "tail_fused"),
               "C": ("fused_forward_last", "fk_bullet_fused"),
               "plain": (),
               "D": (k7, "decode_fused", "tail_fused"),
               "E": (k7, "decode_fused", "tail_fused"),
               "F": ("decode_fused", "tail_fused")}
    models = {"A": M.TIPModel(cfgs["A"].model, device=dev,
                              generator=torch.Generator().manual_seed(0))}
    for name in ("A-enc", "A-bf16", "B", "C", "plain", "D", "E",
                 "F"):                                      # same weights
        models[name] = M.TIPModel(cfgs[name].model, device=dev)
        models[name].load_state_dict(models["A"].state_dict())

    runs, launches = {}, {}
    seconds = {}             # A-bf16's phases
    # the plain path is only ever compared over PATH_FRAMES frames, A-enc
    # and A-bf16 over ENC_FRAMES
    cut = {"plain": PATH_FRAMES + 1, "A-enc": ENC_FRAMES + 1,
           "A-bf16": ENC_FRAMES + 1}
    for name in ("A", "A-enc", "A-bf16", "plain", "C", "B", "D", "E", "F"):
        t0 = time.perf_counter()
        runs[name], launches[name] = run_path(
            name, models[name], cfgs[name], skel, s_init,
            imu[:cut.get(name, len(imu))], dev, on_path[name])
        seconds[f"{name} run"] = time.perf_counter() - t0
    launches["replay"] = {"fused_forward": replay_path_b(
        models["B"], cfgs["B"], skel, s_init, imu, dev)}
    t0 = time.perf_counter()
    n_abf, abf_calls = replay_path_a_bf16(
        models["A-bf16"], cfgs["A-bf16"], skel, s_init,
        imu[:ENC_FRAMES + 1], dev)
    seconds["A-bf16 replay"] = time.perf_counter() - t0
    if n_abf != launches["A-bf16"]["fused_rnn_bf16"]:
        raise AssertionError(f"path A-bf16 replay held {n_abf} windows, the "
                             f"run launched K1 "
                             f"{launches['A-bf16']['fused_rnn_bf16']} times")
    n_e = replay_path_e(models["E"], cfgs["E"], skel, s_init, imu, dev)
    if n_e != launches["E"][k7]:
        raise AssertionError(f"path E replay recorded {n_e} frames, the "
                             f"run launched K7 {launches['E'][k7]} times")

    # reference: the plain path in float64 on the CPU, first frames
    model_c = M.TIPModel(cfgs["plain"].model, device="cpu",
                         dtype=torch.float64)
    model_c.load_state_dict(models["A"].state_dict())
    runs_cpu = R.run_offline(model_c, cfgs["plain"],
                             kin.amass_skeleton(dtype=torch.float64),
                             s_init, imu[:CPU_FRAMES + 1], device="cpu")
    for name in ("A", "C"):
        compare_runs(f"path {name} vs plain (card)", runs[name],
                     runs["plain"], PATH_FRAMES, TOL_PATH)
        compare_runs(f"path {name} card f32 vs CPU f64", runs[name],
                     runs_cpu, CPU_FRAMES, TOL_PATH)
    compare_runs("path A-enc vs A (card)", runs["A-enc"], runs["A"],
                 ENC_FRAMES, TOL_PATH)
    # information, no tolerance: bf16 free-running against f32
    a = runs["A-bf16"][0][:ENC_FRAMES].double().cpu()
    b = runs["A-enc"][0][:ENC_FRAMES].double().cpu()
    log(json.dumps({"A-bf16_vs_A-enc_free_running": {
        "qdq_max_abs_diff": (a - b).abs().max().item(),
        "first_frame_over_1e-2": first_disagreement(a, b,
                                                    TOL_FF["bfloat16"]),
        "frames": ENC_FRAMES}}))

    # the cached modes: D against the plain cached step on the card, against
    # the windowed fused forward while the window grows (the cached step is
    # exact there), and against a float64 CPU run of F's configuration
    compare_runs("path D vs F (card)", runs["D"], runs["F"], PATH_FRAMES,
                 TOL_PATH)
    compare_runs("path D vs C while the window grows", runs["D"], runs["C"],
                 GROW_ROWS, TOL_PATH)
    model_c = M.TIPModel(cfgs["F"].model, device="cpu", dtype=torch.float64)
    model_c.load_state_dict(models["A"].state_dict())
    runs_cpu_f = R.run_offline(model_c, cfgs["F"],
                               kin.amass_skeleton(dtype=torch.float64),
                               s_init, imu[:CPU_FRAMES + 1], device="cpu")
    for name in ("D", "F"):
        compare_runs(f"path {name} card f32 vs CPU f64 (kv_cache)",
                     runs[name], runs_cpu_f, CPU_FRAMES, TOL_PATH)

    # information, no tolerance: bf16 free-running against f32 free-running,
    # and the serving modes against recompute (random weights)
    poses = {n: kin.our_pose_to_bullet(runs[n][0])
             for n in ("A", "B", "C", "D", "E")}

    def angle(a, b, rows=slice(None)):
        return metrics.loss_angle(poses[a][rows], poses[b][rows]).item()

    after = slice(GROW_ROWS, None)
    log(json.dumps({"joint_angle_err_deg": {
        "B_vs_A_all_frames": angle("A", "B"),
        "B_vs_A_first_120": angle("A", "B", slice(0, 120)),
        "C_vs_A_all_frames": angle("A", "C"),
        "D_vs_C_after_the_slide": angle("C", "D", after),
        "D_vs_A_after_the_slide": angle("A", "D", after),
        "E_vs_C_after_the_slide": angle("C", "E", after),
        "E_vs_A_after_the_slide": angle("A", "E", after),
        "E_vs_D_after_the_slide": angle("D", "E", after)}}))

    # per-frame time, eager, one pass each, in one call on one card
    frame_ms = {}
    for name in ("A", "A-enc", "A-bf16", "B", "C", "plain", "D", "E", "F"):
        t0 = time.perf_counter()
        frame_ms[name] = frame_times_ms(models[name], cfgs[name], skel,
                                        s_init, imu, dev)
        seconds[f"{name} frame timing"] = time.perf_counter() - t0
    log(f"per-frame median ms (eager, sync per frame): {frame_ms}")

    for name in ("A", "A-enc", "A-bf16", "B", "C", "D", "E", "F"):
        t0 = time.perf_counter()
        dev_ms, n_kernels, rows, prof_frame_ms = profile_frames(
            models[name], cfgs[name], skel, s_init, imu, dev)
        seconds[f"{name} profile"] = time.perf_counter() - t0
        # busy share of the profiled frames themselves: their device time
        # over their median host time (the profiler's own host cost
        # included)
        log(json.dumps({"profile": {
            "path": name, "device_ms_per_frame": dev_ms,
            "kernels_per_frame": n_kernels,
            "frame_ms_profiled": prof_frame_ms,
            "device_busy_share": dev_ms / prof_frame_ms,
            "top": [[k[:70], ms, c] for k, ms, c in rows[:8]]}}))
    t0 = time.perf_counter()
    syncs, kinds = host_syncs(models["A-bf16"], cfgs["A-bf16"], skel, s_init,
                              imu, dev)
    seconds["A-bf16 host syncs"] = time.perf_counter() - t0
    log(f"  host syncs a steady frame, path A-bf16: {syncs} {kinds}")
    log(json.dumps({"main_path_seconds": seconds}))
    if syncs:
        raise AssertionError(f"path A-bf16 syncs the host {syncs} times a "
                             f"frame: {kinds}")
    return launches, frame_ms, runs, models["A"].state_dict(), abf_calls


# ---------------------------------------------------------------------------
# 4b. the full runner (terrain + leg IK)
# ---------------------------------------------------------------------------

# path N-gt on the card against a float64 CPU playback: the played state is
# returned as given (qdq); the contact track goes through FK and the SBP
# residues (1/dt of a position difference, clipped, times dt)
TOL_GT_QDQ = 1e-5
TOL_GT_VIZ = 1e-4
# the terrain metrics' height MAE of N-gt, card against CPU, in m
TOL_GT_MAE = 1e-3
# path N-E: frames of the full runner in kv_cache_rnn_carry, fused, bf16
NE_FRAMES = 120
# paths N and N-gt (and N-gt's float64 CPU playback): the motion's first
# FULL_FRAMES frames, half of it, so that the script ends well inside its
# time limit on a slow host
FULL_FRAMES = 360


def load_gt():
    with open(MOTION, "rb") as f:     # in-tree motion written by data gen
        d = pickle.load(f)
    return d["nimble_qdq"], d["constrs"]


def run_full(name, model, cfg, skel, s_init, imu, dev, on_path, gt=None):
    """One full-runner path through run_offline_full with the launch
    counters set to 0 just before and read just after; on_path: {kernel:
    launches}, every other kernel 0; outputs finite of the expected
    shapes. gt: (s_gt, c_gt) for playback. Returns ((s_traj, c_traj, viz,
    upd), final carry, launches)."""
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.runtime import full_runner as FR
    T = imu.shape[0]
    kw = {} if gt is None else dict(s_gt=gt[0][:T], c_gt=gt[1][:T])
    K.reset_launch_counts()
    t0 = time.perf_counter()
    *outs, final = FR.run_offline_full(model, cfg, skel, s_init, imu,
                                       collect_updates=True, device=dev,
                                       **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    log(f"path {name}: {T - 1} frames in {wall:.3f} s "
        f"({wall / (T - 1) * 1e3:.3f} ms/frame, no per-frame sync); "
        f"launches {launches}")
    for k in KERNELS:
        if launches[k] != on_path.get(k, 0):
            raise AssertionError(f"path {name}: {k} launched {launches[k]} "
                                 f"times, expected {on_path.get(k, 0)}")
    for a, shape in zip(outs, [(T, 114), (T, 20), (T, 5, 3), (T, 3)]):
        if tuple(a.shape) != shape or (a.is_floating_point()
                                       and not torch.isfinite(a).all()):
            raise AssertionError(f"path {name}: output {tuple(a.shape)} is "
                                 f"not a finite {shape}")
    return outs, final, launches


def compare_terrain(what, a, b, upd_a, upd_b, tol_h=TOL_PATH):
    """Two runs' update tracks equal, final region maps equal and region
    heights within tol_h; a discrete flip (a grid rounding or a threshold)
    fails with the frame of the first differing update."""
    upd_a, upd_b = upd_a.cpu(), upd_b.cpu()
    n = min(len(upd_a), len(upd_b))
    diff = torch.nonzero((upd_a[:n] != upd_b[:n]).any(dim=1))
    flip = int(diff[0]) if diff.numel() else None
    same_map = torch.equal(a.region_map.cpu(), b.region_map.cpu())
    dh = (a.region_height.double().cpu()
          - b.region_height.double().cpu()).abs().max().item()
    log(f"  {what} terrain: {int(upd_a.sum())} updates, "
        f"{int(a.n_regions)} regions; region maps equal {same_map}, max "
        f"|height diff| {dh:.3g}, first update flip {flip}")
    if flip is not None or not same_map or not dh <= tol_h \
            or int(a.n_regions) != int(b.n_regions):
        raise AssertionError(f"{what}: terrain differs (first update flip at "
                             f"frame {flip}, maps equal {same_map}, height "
                             f"diff {dh:.3g})")


def full_runner_paths(dev, state_dict):
    """Paths N (bench.py's configuration of the full runner), N-gt (ground
    truth playback) and N-E (the full runner in kv_cache_rnn_carry, fused,
    bf16), and the host syncs of a steady frame of A and N. Returns
    (launches by path, summary)."""
    t0 = time.perf_counter()
    from tip_tpu_torch import eval_terrain as E
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import full_runner as FR
    from tip_tpu_torch.runtime import runner as R

    imu, s_init = load_motion()
    gt_qdq, gt_c = load_gt()
    imu, gt_qdq, gt_c = (a[:FULL_FRAMES + 1] for a in (imu, gt_qdq, gt_c))
    skel = kin.amass_skeleton(device=dev)
    plain_enc = dict(encoder_impl="plain")
    cfgs = {
        # bench.py: recompute, K1, the fused tail, multi_sbp, default
        # TerrainConfig, f32
        "N": FR.FullRunnerConfig(
            base=R.RunnerConfig(model=M.ModelConfig(**plain_enc)),
            multi_sbp=True),
        "N-plain": FR.FullRunnerConfig(
            base=R.RunnerConfig(model=M.ModelConfig(rnn_impl="plain",
                                                    **plain_enc),
                                tail_impl="plain"), multi_sbp=True),
        "N-gt": FR.FullRunnerConfig(
            base=R.RunnerConfig(model=M.ModelConfig(**plain_enc)),
            multi_sbp=True, playback_gt=True),
        "N-E": FR.FullRunnerConfig(
            base=R.RunnerConfig(model=M.ModelConfig(
                forward_impl="fused", compute_dtype="bfloat16"),
                serving_mode="kv_cache_rnn_carry"), multi_sbp=True),
        "A": R.RunnerConfig(model=M.ModelConfig(**plain_enc)),
    }
    models = {}
    for name, cfg in cfgs.items():
        models[name] = M.TIPModel(getattr(cfg, "base", cfg).model, device=dev)
        models[name].load_state_dict(state_dict)
    n_model = imu.shape[0] - 1 - cfgs["N"].base.imu_n_smooth
    k7 = "fused_cached_forward_step"
    three = ("fused_rnn", "decode_fused", "tail_fused")
    launches, summary = {}, {}

    # N: launches, then against the plain versions on the card, a float64
    # CPU run and the terrain at frame PATH_FRAMES
    outs, final, launches["N"] = run_full(
        "N", models["N"], cfgs["N"], skel, s_init, imu, dev,
        dict.fromkeys(three, n_model))
    cut = imu[:PATH_FRAMES + 1]
    outs_cut, final_cut, _ = run_full(
        "N (first frames)", models["N"], cfgs["N"], skel, s_init, cut, dev,
        dict.fromkeys(three, PATH_FRAMES - cfgs["N"].base.imu_n_smooth))
    plain, final_plain, _ = run_full("N-plain", models["N-plain"],
                                     cfgs["N-plain"], skel, s_init, cut, dev,
                                     {})
    compare_runs("path N vs plain (card)", outs, plain, PATH_FRAMES, TOL_PATH)
    compare_terrain(f"path N vs plain (card), frame {PATH_FRAMES}",
                    final_cut.terrain,
                    final_plain.terrain, outs_cut[3], plain[3])
    model_c = M.TIPModel(cfgs["N-plain"].base.model, device="cpu",
                         dtype=torch.float64)
    model_c.load_state_dict(state_dict)
    *cpu, final_cpu = FR.run_offline_full(
        model_c, cfgs["N-plain"], kin.amass_skeleton(dtype=torch.float64),
        s_init, imu[:CPU_FRAMES + 1], collect_updates=True, device="cpu")
    compare_runs("path N card f32 vs CPU f64", outs, cpu, CPU_FRAMES,
                 TOL_PATH)
    summary["N"] = dict(terrain_updates=int(outs[3].sum()),
                        regions=int(final.terrain.n_regions))

    # N-gt: the played motion through K3, against a float64 CPU playback.
    # Under playback the model's output reaches nothing the runner returns
    # or the terrain, so the CPU reference runs a small model
    outs_gt, final_gt, launches["N-gt"] = run_full(
        "N-gt", models["N-gt"], cfgs["N-gt"], skel, s_init, imu, dev,
        dict(fused_rnn=n_model, decode_fused=n_model,
             tail_fused=imu.shape[0] - 1), gt=(gt_qdq, gt_c))
    small = M.ModelConfig(**plain_enc, tf_in_dim=32, tf_hid_size=64,
                          n_heads=4, tf_layers=2, rnn_hid_size=24)
    cfg_c = FR.FullRunnerConfig(
        base=R.RunnerConfig(model=small, tail_impl="plain"), multi_sbp=True,
        playback_gt=True)
    skel_c = kin.amass_skeleton(dtype=torch.float64)
    *cpu_gt, final_cpu_gt = FR.run_offline_full(
        M.TIPModel(small, device="cpu", dtype=torch.float64), cfg_c, skel_c,
        s_init, imu, gt_qdq, gt_c, collect_updates=True, device="cpu")
    errs = {"qdq": ((outs_gt[0].double().cpu() - cpu_gt[0]).abs().max()
                    .item(), TOL_GT_QDQ),
            "viz": ((outs_gt[2].double().cpu() - cpu_gt[2]).abs().max()
                    .item(), TOL_GT_VIZ)}
    check("path N-gt card f32 vs CPU f64", errs)
    compare_terrain("path N-gt vs CPU f64 playback", final_gt.terrain,
                    final_cpu_gt.terrain, outs_gt[3], cpu_gt[3])
    tcfg = cfgs["N-gt"].terrain
    m_card = E.motion_terrain_metrics(
        skel, gt_qdq, gt_c, final_gt.terrain, tcfg,
        outs_gt[2].cpu().numpy(), outs_gt[3].cpu().numpy())
    m_cpu = E.motion_terrain_metrics(
        skel_c, gt_qdq, gt_c, final_cpu_gt.terrain, tcfg,
        cpu_gt[2].numpy(), cpu_gt[3].numpy())
    log(json.dumps({"terrain_metrics_N_gt": {"card": m_card,
                                             "cpu_f64": m_cpu}}))
    check("path N-gt terrain metrics", {"height_mae_m": (
        abs(m_card["height_mae_m"] - m_cpu["height_mae_m"]), TOL_GT_MAE)})
    summary["N-gt"] = dict(terrain_updates=int(outs_gt[3].sum()),
                           regions=int(final_gt.terrain.n_regions),
                           metrics=m_card, vs_cpu=errs)

    # N-E: 120 frames in kv_cache_rnn_carry, fused, bf16; held frame by
    # frame against K7's plain version, as path E
    ne = imu[:NE_FRAMES + 1]
    ne_model = NE_FRAMES - cfgs["N-E"].base.imu_n_smooth
    _, _, launches["N-E"] = run_full(
        "N-E", models["N-E"], cfgs["N-E"], skel, s_init, ne, dev,
        {k7: ne_model, "decode_fused": ne_model, "tail_fused": ne_model})
    n_rec = replay_path_e(models["N-E"], cfgs["N-E"], skel, s_init, ne, dev)
    if n_rec != ne_model:
        raise AssertionError(f"path N-E replay recorded {n_rec} frames")

    # per-frame time, device time by kernel, host syncs
    frame_ms = {n: frame_times_ms(models[n], cfgs[n], skel, s_init, imu, dev)
                for n in ("N", "N-E")}
    summary["frame_ms"] = frame_ms
    dev_ms, n_kernels, rows, prof_ms = profile_frames(
        models["N"], cfgs["N"], skel, s_init, imu, dev)
    summary["profile"] = {
        "device_ms_per_frame": dev_ms, "kernels_per_frame": n_kernels,
        "frame_ms_profiled": prof_ms, "device_busy_share": dev_ms / prof_ms,
        "top": [[k[:70], ms, c] for k, ms, c in rows[:8]]}
    summary["host_syncs_per_frame"] = {}
    for name in ("A", "N"):
        per_frame, kinds = host_syncs(models[name], cfgs[name], skel, s_init,
                                      imu, dev)
        summary["host_syncs_per_frame"][name] = per_frame
        log(f"  host syncs a steady frame, path {name}: {per_frame} {kinds}")
    if summary["host_syncs_per_frame"]["N"] > \
            summary["host_syncs_per_frame"]["A"]:
        raise AssertionError(f"path N syncs more than path A: "
                             f"{summary['host_syncs_per_frame']}")
    summary["seconds"] = time.perf_counter() - t0
    log(json.dumps({"full_runner": summary}))
    return launches, summary


# ---------------------------------------------------------------------------
# 5. the pool paths
# ---------------------------------------------------------------------------

def pool_schedule(n_ticks):
    """The pool's traffic over n_ticks: the IMU batch of every tick
    (n_ticks, capacity, 72), which slots hold a stream at each tick
    (n_ticks, capacity), the joins and removals by tick, and the s_init of
    every motion. A slot with no stream is fed zeros."""
    imus, s_inits = [], []
    for i in range(60):
        with open(CORPUS / f"freeform2_{i:04d}.pkl", "rb") as f:
            d = pickle.load(f)    # in-tree motions written by data gen
        imus.append(d["imu"])
        s_inits.append(d["nimble_qdq"][0])
    batch = torch.zeros(n_ticks, POOL_CAPACITY, 72)
    active = torch.zeros(n_ticks, POOL_CAPACITY, dtype=torch.bool)
    events = {0: [("add", slot, slot) for slot in range(60)]}
    spans = [(slot, slot, 0, n_ticks) for slot in range(60)
             if slot != POOL_REMOVE[1]]
    spans.append((POOL_REMOVE[1], POOL_REMOVE[1], 0, POOL_REMOVE[0]))
    events[POOL_REMOVE[0]] = [("remove", POOL_REMOVE[1], None)]
    for tick, (slot, motion) in list(POOL_JOINS.items()) + \
            [(POOL_READD[0], POOL_READD[1:])]:
        events.setdefault(tick, []).append(("add", slot, motion))
        spans.append((slot, motion, tick, n_ticks))
    for slot, motion, t0, t1 in spans:
        t1 = min(t1, n_ticks)
        if t1 > t0:
            batch[t0:t1, slot] = torch.as_tensor(imus[motion][:t1 - t0],
                                                 dtype=torch.float32)
            active[t0:t1, slot] = True
    return batch, active, events, s_inits


def run_pool_path(name, model, cfg, skel, sched, dev, on_path, n_ticks,
                  record=None):
    """Drive one pool path through StreamPool.step with the launch counters
    set to 0 just before and read just after, a synchronise after every
    tick (so that ticks can be timed). Every kernel in on_path must have
    been launched exactly once per tick (or as often as on_path says, a
    dict) and every other kernel not at all.
    Returns the pool, the stacked outputs by name, the launches, the median
    steady tick in ms and the peak memory."""
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.runtime.serving import StreamPool
    batch, active, events, s_inits = sched
    pool = StreamPool(model, cfg, skel, capacity=POOL_CAPACITY, device=dev)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    outs, times = [], []
    for t in range(n_ticks):
        for kind, slot, motion in events.get(t, ()):
            if kind == "remove":
                pool.remove_stream(slot)
            else:
                got = pool.add_stream(s_inits[motion])
                if got != slot:
                    raise AssertionError(f"path {name}: slot {got} handed "
                                         f"out at tick {t}, expected {slot}")
                if record is not None:
                    record.append(("reset", t, slot))
        t0 = time.perf_counter()
        out = pool.step(batch[t])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    mem = torch.cuda.max_memory_allocated()
    # steady ticks: every slot holds a stream whose window is full
    steady = times[max(POOL_READD[0] + 45, n_ticks // 2) if
                   n_ticks > POOL_READD[0] + 60 else n_ticks // 2:]
    tick_ms = statistics.median(steady)
    log(f"pool path {name}: {n_ticks} ticks of {POOL_CAPACITY} slots, steady "
        f"tick {tick_ms:.3f} ms (synced), "
        f"{POOL_CAPACITY / tick_ms * 1e3:.0f} stream-frames/s, peak memory "
        f"{mem / 2 ** 20:.1f} MiB; launches {launches}")
    per_tick = (on_path if isinstance(on_path, dict)
                else dict.fromkeys(on_path, 1))
    for k in KERNELS:
        want = n_ticks * per_tick.get(k, 0)
        if launches[k] != want:
            raise AssertionError(
                f"pool path {name}: {k} launched {launches[k]} times, "
                f"expected {want} ({n_ticks} ticks)")
    stacked = {n: torch.stack([o[n] for o in outs])
               for n in ("qdq", "ct", "viz_locs")}
    on = active[:n_ticks].to(dev)
    for n, a in stacked.items():
        if tuple(a.shape[:2]) != (n_ticks, POOL_CAPACITY) or \
                not torch.isfinite(a[on]).all():
            raise AssertionError(f"pool path {name}: {n} of the active "
                                 f"streams is not finite")
    return pool, stacked, launches, tick_ms, mem


def profile_pool(pool, batch, first, n=30):
    """Device time per tick by kernel over n further ticks (torch.profiler)
    and the median host time of those ticks (synchronised each tick,
    profiler on)."""
    from torch.profiler import ProfilerActivity, profile
    times = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(first, first + n):
            t0 = time.perf_counter()
            pool.step(batch[t])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return (sum(r[1] for r in rows), sum(r[2] for r in rows), rows,
            statistics.median(times))


def compare_pool(what, a, b, on, ticks, tol):
    """Max |a - b| of every output over the (tick, slot) pairs of `on`
    within the first `ticks` ticks."""
    worst = 0.0
    for n in ("qdq", "ct", "viz_locs"):
        m = on[:ticks]
        err = (a[n][:ticks][m].double() - b[n][:ticks][m].double()) \
            .abs().max().item()
        worst = max(worst, err)
        if not err <= tol:
            bad = ((a[n][:ticks] - b[n][:ticks]).abs().flatten(2).amax(2)
                   > tol) & m
            t_bad, s_bad = (int(v) for v in torch.nonzero(bad)[0])
            raise AssertionError(
                f"{what}: {n} differs by {err:.3g} > {tol:g}; first at tick "
                f"{t_bad}, slot {s_bad}")
    log(f"  {what}: max |diff| over {int(on[:ticks].sum())} stream-frames = "
        f"{worst:.3g}")
    return worst


def compare_with_single(what, pooled, single, n_ticks, tol):
    """The four checked streams of a pool path against a single-stream run
    of motion 0 (s_traj, c_traj, viz of run_offline), each from its own
    first frame: the pool's output at tick t of a stream that joined at
    tick j is the single stream's row t - j + 1."""
    for slot, j in POOL_CHECKED:
        n = n_ticks - j
        for name, ref in zip(("qdq", "ct", "viz_locs"), single):
            a = pooled[name][j:n_ticks, slot].double().cpu()
            b = ref[1:n + 1].double().cpu()
            err = (a - b).abs().max().item()
            if not err <= tol:
                f0 = first_disagreement(a, b, tol)
                raise AssertionError(
                    f"{what}: slot {slot} (joined at tick {j}) {name} "
                    f"differs from the single stream by {err:.3g} > {tol:g}, "
                    f"first at its frame {f0}")
        log(f"  {what}: slot {slot} (joined at tick {j}) equals the single "
            f"stream over {n} frames (qdq max |diff| = "
            f"{(pooled['qdq'][j:n_ticks, slot].double().cpu() - single[0][1:n + 1].double().cpu()).abs().max().item():.3g})")


def replay_path_g(packed, cfg, records, active, dev):
    """Path G teacher-forced: its bf16 free-running trajectories drift from
    any other run chaotically, so each tick is held on its own. Feed every
    recorded token batch, cursor and commit mask from a fresh pool cache
    through K8's plain version (a slot's cache zeroed where the pool wrote a
    fresh carry into it) and compare y_t of the streams that are active and
    committed, tick by tick."""
    from tip_tpu_torch.runtime import streaming_cache as SC
    cache = SC.cache_init(cfg.model, cfg.window, device=dev,
                          batch=POOL_CAPACITY)
    err, n_ticks = 0.0, 0
    with torch.no_grad():
        for rec in records:
            if rec[0] == "reset":
                for n in SC._LEAVES:
                    getattr(cache, n)[rec[2]].zero_()
                continue
            _, x, slot, commit, y_t = rec
            _, ref = SC.fused_cached_batch_plain(
                packed, cache, x, slot, commit, cfg.model, rnn_carry=True)
            m = commit & active[n_ticks].to(dev)
            if m.any():
                err = max(err, max_err(ref[m], y_t[m]))
            n_ticks += 1
    check("path G replay", {"plain_vs_recorded_K8": (err, TOL_FF["bfloat16"])})
    log(f"  path G teacher-forced over {n_ticks} ticks: max |plain - K8| = "
        f"{err:.3g}")
    return n_ticks


# the streams of path K-bf16 held teacher-forced against the single-stream
# model: (slot, tick it joined), each from its own first frame
POOL_CHECKED_BF16 = ((0, 0), (60, 7), (61, 50), (62, 100))


def replay_pool_bf16(single, cfg, records):
    """Path K-bf16 teacher-forced: every recorded window of the streams of
    POOL_CHECKED_BF16 (model input and the pooled forward's output, K11
    and K1 in bf16 at B 64) through A-bf16's single-stream model (the same
    kernels at B 1); the row the pool reads, the stream's last valid row
    (runner.py's counters: min(f - imu_n_smooth + 1, window) - 1 at its
    frame f), compared from the stream's first model frame on."""
    err, n = 0.0, 0
    with torch.no_grad():
        for t, (x_imu, x_s, y) in enumerate(records):
            for r, (slot, j) in enumerate(POOL_CHECKED_BF16):
                f = t - j
                if f < cfg.imu_n_smooth:
                    continue
                k = min(f - cfg.imu_n_smooth + 1, cfg.window) - 1
                ref = single(x_imu[r:r + 1], x_s[r:r + 1])[0, k]
                err = max(err, max_err(ref, y[r, k]))
                n += 1
    check("path K-bf16 vs the single-stream model", {
        "single_vs_pooled": (err, TOL_FF["bfloat16"])})
    log(f"  path K-bf16 teacher-forced: {n} windows of slots "
        f"{[s for s, _ in POOL_CHECKED_BF16]} through A-bf16's single-stream "
        f"model, max |diff| = {err:.3g}")
    return n


def pool_paths(dev, single_runs, state_dict):
    """Drive the pool paths G-K and K-bf16; `single_runs`: the
    single-stream paths' outputs on motion 0, `state_dict`: their
    weights."""
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import runner as R
    from tip_tpu_torch.runtime import streaming_cache as SC

    skel = kin.amass_skeleton(device=dev)
    n_prof = 30
    sched = pool_schedule(POOL_TICKS + n_prof)
    batch, active = sched[0], sched[1]
    f32 = dict(forward_impl="fused", compute_dtype="float32")
    cfgs = {
        "G": R.RunnerConfig(model=M.ModelConfig(forward_impl="fused",
                                                compute_dtype="bfloat16"),
                            serving_mode="kv_cache_rnn_carry"),
        "H": R.RunnerConfig(model=M.ModelConfig(**f32),
                            serving_mode="kv_cache"),
        "I": R.RunnerConfig(serving_mode="kv_cache"),
        "J": R.RunnerConfig(model=M.ModelConfig(**f32)),
        "K": R.RunnerConfig(model=M.ModelConfig(encoder_impl="plain"),
                            tail_impl="plain", fk_impl="kernel"),
        # A-bf16 pooled: every setting at its default but the compute dtype
        "K-bf16": R.RunnerConfig(model=M.ModelConfig(
            compute_dtype="bfloat16")),
    }
    k8, k9 = "fused_cached_batch", "fused_recompute_batch"
    on_path = {"G": (k8, "decode_fused", "tail_fused"),
               "H": (k8, "decode_fused", "tail_fused"),
               "I": ("decode_fused", "tail_fused"),
               "J": (k9, "decode_fused", "tail_fused"),
               "K": ("fused_rnn", "fk_bullet_fused"),
               "K-bf16": {"encoder_layer_fwd_bf16": 4, "fused_rnn_bf16": 1,
                          "decode_fused": 1, "tail_fused": 1}}
    ticks = {n: POOL_TICKS_K if n.startswith("K") else POOL_TICKS
             for n in cfgs}
    outs, launches, summary = {}, {}, {}
    records, bf16_windows = [], []
    checked = [slot for slot, _ in POOL_CHECKED_BF16]
    for name in ("G", "H", "I", "J", "K", "K-bf16"):
        t0 = time.perf_counter()
        model = M.TIPModel(cfgs[name].model, device=dev)
        model.load_state_dict(state_dict)
        if name == "K-bf16":
            def windows(x_imu, x_s, model=model):
                y = type(model).forward(model, x_imu, x_s)
                bf16_windows.append((x_imu[checked].clone(),
                                     x_s[checked].clone(),
                                     y[checked].clone()))
                return y
            model.forward = windows
        wrapper = SC.fused_cached_batch
        if name == "G":
            def recording(ws, cache, x, slot, commit, mcfg, **kw):
                out = wrapper(ws, cache, x, slot, commit, mcfg, **kw)
                records.append(("step", x.clone(), slot, commit.clone(),
                                out[1].clone()))
                return out
            SC.fused_cached_batch = recording
        try:
            pool, outs[name], launches[name], tick_ms, mem = run_pool_path(
                name, model, cfgs[name], skel, sched, dev, on_path[name],
                ticks[name], record=records if name == "G" else None)
        finally:
            SC.fused_cached_batch = wrapper
            model.__dict__.pop("forward", None)
        dev_ms, n_kernels, rows, prof_tick_ms = profile_pool(
            pool, batch.to(dev), ticks[name], n_prof)
        summary[name] = dict(
            path=name, capacity=POOL_CAPACITY, ticks=ticks[name],
            tick_ms=tick_ms,
            stream_frames_per_s=POOL_CAPACITY / tick_ms * 1e3,
            needed_stream_frames_per_s=60 * POOL_CAPACITY,
            kernels_per_tick=n_kernels, device_ms_per_tick=dev_ms,
            tick_ms_profiled=prof_tick_ms,
            device_busy_share=dev_ms / prof_tick_ms,
            max_memory_allocated=mem,
            top=[[k[:70], ms, c] for k, ms, c in rows[:6]])
        log(json.dumps({"pool": summary[name]}))
        if name == "G":
            n_g = replay_path_g(pool._packed, cfgs["G"], records, active, dev)
            if n_g != launches["G"][k8]:
                raise AssertionError(
                    f"path G replay saw {n_g} ticks, the run launched K8 "
                    f"{launches['G'][k8]} times")
            records.clear()
        if name == "K-bf16":
            single = M.TIPModel(cfgs[name].model, device=dev)
            single.load_state_dict(state_dict)
            summary[name]["teacher_forced_windows"] = replay_pool_bf16(
                single, cfgs[name], bf16_windows)
            bf16_windows.clear()
            # one more tick, its K11 and K1 calls held on their own inputs
            with torch.no_grad(), RecordCalls() as rec:
                pool.step(batch[ticks[name] + n_prof].to(dev))
            summary[name]["calls"] = hold_calls("path K-bf16, one tick",
                                                rec.calls)
        summary[name]["seconds"] = time.perf_counter() - t0
        log(f"  pool path {name}: {summary[name]['seconds']:.1f} s")
        del pool

    on = active.to(dev)
    compare_pool("pool path H vs I (card)", outs["H"], outs["I"], on,
                 POOL_TICKS, TOL_PATH)
    compare_with_single("pool path H vs single-stream path D", outs["H"],
                        single_runs["D"], POOL_TICKS, TOL_PATH)
    compare_with_single("pool path J vs single-stream path C", outs["J"],
                        single_runs["C"], POOL_TICKS, TOL_PATH)
    compare_pool("pool path K vs J while the window grows", outs["K"],
                 outs["J"], on, GROW_ROWS, TOL_PATH)
    # information: the same two over all of K's ticks
    d = (outs["K"]["qdq"] - outs["J"]["qdq"][:POOL_TICKS_K]).abs()
    log(f"  pool path K vs J over {POOL_TICKS_K} ticks: max |diff| = "
        f"{d[on[:POOL_TICKS_K]].max().item():.3g} (no tolerance)")
    return launches, summary


# ---------------------------------------------------------------------------
# training: kernels K10-K12 and paths L, M
# ---------------------------------------------------------------------------

# K10-K12 against their plain versions on the card: f32 products summed in
# another order, over up to B*T = 10240 rows for a weight gradient; held
# relative to each output's largest entry
TOL_TRAIN_K = {"fused_rnn_bwd": 1e-4, "encoder_layer_fwd": 1e-4,
               "encoder_layer_bwd": 1e-3}
# the training paths: the paper recipe at full width, one epoch over the 60
# in-tree motions packed at downsample 4 (39 steps of 256 windows)
TRAIN_RATE = 4
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_PROFILED = 5, 20, 10
# path L against a float64 step on the CPU: B = 16 windows
F64_BATCH = 16
F64_DRAWS = 8
TOL_F64_LOSS = 1e-4
TOL_F64_GRAD = 1e-3
TOL_F64_GRAD_FRO = 1e-2
# path L against path M (plain versions on the card) step by step
LM_STEPS = 10
TOL_LM_LOSS = 1e-3
# path L-bf16 against the plain versions' bf16 step on the CPU (B 16,
# TRAIN_BF16_DRAWS draws): the two runs round the same operands to bf16 but
# sum in another order, and a value at a bf16 rounding boundary moves by a
# bf16 step (2^-8 of it) and is carried on through the layers
# (tests/test_torch_bf16_train.py against tip_tpu on the CPU: gradients
# 2.5e-2 of their largest entry). On an H100 80GB HBM3: loss 5.6e-5
# relative, gradients 2.4e-2 to 4.1e-2 of their largest entry and 2.4e-2
# to 2.7e-2 of their norm, b_k 8e-7 of the largest entry of all. Against
# path M-bf16 over LM_STEPS steps the loss is held to TOL_LM_LOSS (4.2e-5
# measured)
TRAIN_BF16_DRAWS = 3
TOL_CPU_BF16_LOSS = 1e-2
TOL_CPU_BF16_GRAD = 5e-2
TOL_CPU_BF16_GRAD_FRO = 5e-2
TOL_CPU_BF16_B_K = 1e-3
# the ReLU of the encoder's feed-forward: where a pre-activation lies
# within f32 rounding (~1e-7) of 0, two f32 runs that sum in another order
# can take the two sides of the kink, and its derivative flips from 0 to 1
# for that entry: a gradient entry then differs by the whole term (the card
# showed 1.4e-2 of the largest dx entry at B = 256, p = 0.1, one flip in
# 10.5 M pre-activations). K12's check at the path's shape therefore
# centres the ff1 pre-activations at +2 (0.03% of them stay negative and
# exercise the other side); the small shapes keep the layer's own bias
K12_FF1_SHIFT = 2.0


def rel_err(a, b):
    """max |a - b| over the largest |b|."""
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max().clamp_min(1e-30)).item()


def rnn_bwd_work(B, T, H, itemsize=4):
    """Compulsory bytes (hs, g, W in; dxin, dW out; itemsize bytes an
    entry) and operations of K10: the recurrence da_{t+1} W^T for t < T-1
    and the tanh' update per entry, and dW over the steps t >= 1 (h_{-1} =
    0)."""
    nbytes = itemsize * (3 * B * T * H + 2 * H * H)
    ops = 2 * B * (T - 1) * H * H + 4 * B * T * H + 2 * B * (T - 1) * H * H
    return nbytes, ops


def library_rnn_bwd(w, x, g, dev):
    """Yardstick only, never called by the port: cuDNN's tanh RNN (W_ih =
    I, zero biases: the same function of xin as K1) run forward with grad
    on, then its backward to x and W_hh for the output gradient g. cuDNN
    also forms dW_ih (one more H x H x B T product), so it does about 1.5x
    K10's product work. Returns (forward + backward, forward alone,
    (dx, dW (in, out)))."""
    rnn = cudnn_rnn(w, w.shape[0], dev)
    xr = x.clone().requires_grad_(True)

    def fwd():
        return rnn(xr)[0]

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (xr, rnn.weight_hh_l0), g)

    dx, dw_t = fwd_bwd()
    return fwd_bwd, fwd, (dx, dw_t.T)


def check_fused_rnn_bwd_f32(dev, gen):
    """K10 against its plain version at (3, 7, 40) and at path L's (256,
    40, 512), two calls bit-equal; timed at path L's shape, split by
    kernel, beside cuDNN's RNN backward (library_rnn_bwd) on hidden states
    that its forward gives (the forward's time subtracted)."""
    from tip_tpu_torch.ops import fused_rnn as FR
    tol = TOL_TRAIN_K["fused_rnn_bwd"]
    errs = {}
    main = None
    for B, T, H in ((3, 7, 40), (256, 40, 512)):
        hs = torch.tanh(torch.randn(B, T, H, generator=gen, device=dev))
        w = torch.randn(H, H, generator=gen, device=dev) / math.sqrt(H)
        g = torch.randn(B, T, H, generator=gen, device=dev)
        dx, dw = FR.fused_rnn_bwd(hs, w, g, impl="kernel")
        dx2, dw2 = FR.fused_rnn_bwd(hs, w, g, impl="kernel")
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            raise AssertionError("fused_rnn_bwd: two calls differ")
        rx, rw = FR.fused_rnn_bwd_plain(hs, w, g)
        errs[f"dx_B{B}"] = (rel_err(dx, rx), tol)
        errs[f"dw_B{B}"] = (rel_err(dw, rw), tol)
        main = (hs, w, g)
    err = check("fused_rnn_bwd", errs)
    hs, w, g = main
    # the library's inputs: hidden states its own forward gives
    x = torch.randn(hs.shape, generator=gen, device=dev)
    lib_fb, lib_f, lib_out = library_rnn_bwd(w, x, g, dev)
    hs_lib = FR.fused_rnn_plain(x, w)
    lib_err = max(rel_err(a, b) for a, b in zip(
        lib_out, FR.fused_rnn_bwd_plain(hs_lib, w, g)))
    if not lib_err <= tol:
        raise AssertionError(f"cuDNN's RNN backward yardstick disagrees: "
                             f"{lib_err:.3g}")
    times = timings(lambda: FR.fused_rnn_bwd(hs, w, g, impl="kernel"),
                    lambda: FR.fused_rnn_bwd_plain(hs, w, g), light=True)
    fb = timings(lib_fb, lib_f, light=True)
    times.update(library_ms=fb["ms"] - fb["plain_ms"],
                 library_call_ms=fb["call_ms"] - fb["plain_call_ms"],
                 library_fwd_bwd_ms=fb["ms"], library_fwd_ms=fb["plain_ms"],
                 library_fwd_bwd_call_ms=fb["call_ms"],
                 library_fwd_call_ms=fb["plain_call_ms"])
    times["by_kernel"] = kernel_breakdown(
        lambda: FR.fused_rnn_bwd(hs, w, g, impl="kernel"))
    log(f"  K10 by kernel: {json.dumps(times['by_kernel'])}")
    log(f"  K10 {times['ms']:.4f} ms; cuDNN forward + backward "
        f"{fb['ms']:.4f}, forward {fb['plain_ms']:.4f}, backward "
        f"{times['library_ms']:.4f}")
    work = rnn_bwd_work(*hs.shape)
    b_ms, b_by = bound(*work)
    b3_ms, b3_by = bound(*work, peak_flop_s=PEAK_3XTF32_FLOP_S)
    return dict(name="fused_rnn_bwd", route="cuda",
                source="tip_tpu_torch/csrc/fused_rnn_bwd.cu",
                replaces="tip_tpu/ops/pallas_kernels.py:148",
                shape=list(hs.shape), max_abs_err=err, tol=tol,
                err_is="relative to the largest entry", bound_ms=b_ms,
                bound_by=b_by, bound_3xtf32_ms=b3_ms,
                bound_3xtf32_by=b3_by, library_err=lib_err,
                library="cuDNN nn.RNN backward (to x and W_hh; it also "
                        "forms dW_ih), forward + backward less forward",
                **times)


def encoder_layer_ops(B, T, d, ff, nh):
    """Operations of one training layer's forward: the four products, the
    causal half of attention (4 d per entry, 5 per softmax entry), 8 per
    LayerNorm element."""
    N = B * T
    causal = T * (T + 1) // 2
    return (2 * N * d * (3 * d + d + 2 * ff) + B * (4 * d + 5 * nh) * causal
            + 16 * N * d)


def encoder_layer_work(B, T, d, ff, nh, backward, itemsize=4):
    """Compulsory bytes and operations of K11 (x, 12 weights in, y out; x,
    y and the 8 matmul weights and biases itemsize bytes an entry, the
    LayerNorm vectors 4) or K12 (x, dy, 12 weights in, dx and 12 gradients
    out, itemsize bytes an entry but the LayerNorm vectors' and their
    gradients' 4; the forward it recomputes plus twice the products, the
    attention backward with 4 products per causal entry and 8 more per
    LayerNorm element)."""
    n_w = 3 * d * d + 3 * d + d * d + d + 2 * d * ff + ff + d + 4 * d
    N = B * T
    if not backward:
        return (itemsize * (2 * N * d + n_w - 4 * d) + 4 * 4 * d,
                encoder_layer_ops(B, T, d, ff, nh))
    causal = T * (T + 1) // 2
    ops = (encoder_layer_ops(B, T, d, ff, nh)
           + 4 * N * d * (3 * d + d + 2 * ff) + B * (8 * d + 4 * nh) * causal
           + 16 * N * d)
    return itemsize * (3 * N * d + 2 * (n_w - 4 * d)) + 4 * 2 * 4 * d, ops


def library_encoder_layer(ws, n_heads, dev):
    """Yardstick only, never called by the port: torch's post-norm
    TransformerEncoderLayer with dropout 0 and these weights, in the matmul
    weights' dtype."""
    w_qkv, b_qkv, w_o, b_o, w_f1, b_f1, w_f2, b_f2, g1, be1, g2, be2 = ws
    d, ff = w_o.shape[0], w_f1.shape[1]
    layer = torch.nn.TransformerEncoderLayer(
        d, n_heads, dim_feedforward=ff, dropout=0.0, batch_first=True).to(
            dev, w_qkv.dtype)
    with torch.no_grad():
        layer.self_attn.in_proj_weight.copy_(w_qkv.T)
        layer.self_attn.in_proj_bias.copy_(b_qkv)
        layer.self_attn.out_proj.weight.copy_(w_o.T)
        layer.self_attn.out_proj.bias.copy_(b_o)
        layer.linear1.weight.copy_(w_f1.T)
        layer.linear1.bias.copy_(b_f1)
        layer.linear2.weight.copy_(w_f2.T)
        layer.linear2.bias.copy_(b_f2)
        layer.norm1.weight.copy_(g1)
        layer.norm1.bias.copy_(be1)
        layer.norm2.weight.copy_(g2)
        layer.norm2.bias.copy_(be2)
    return layer


def check_encoder_train(dev, gen, model):
    """K11 and K12 against their plain versions at the path's shape (B 256,
    T 40, the model's layer 0, p 0.1 and 0) and at small widths (two
    tiles; a tile of 3), twice each bit-equal; times at the path's shape,
    and beside them at p = 0 torch's TransformerEncoderLayer (K11) and its
    autograd backward (K12)."""
    from tip_tpu_torch.ops import encoder_train as ET
    cfg = model.cfg
    p_layer = 0.1
    ws_full = tuple(w.detach().contiguous() for w in ET.pack_layer_weights(
        dict(model.named_parameters()), "layers.0."))
    ws_k12 = list(ws_full)
    ws_k12[5] = (ws_k12[5] + K12_FF1_SHIFT).contiguous()
    ws_k12 = tuple(ws_k12)
    small = small_model(dev)
    ws_small = tuple(w.detach().contiguous() for w in ET.pack_layer_weights(
        dict(small.named_parameters()), "layers.0."))
    cases = [("full_p0.1", 256, 40, ws_full, ws_k12, cfg.n_heads, p_layer, 8),
             ("full_p0", 256, 40, ws_full, ws_k12, cfg.n_heads, 0.0, 8),
             ("small_2tiles", 16, 10, ws_small, ws_small, small.cfg.n_heads,
              p_layer, 8),
             ("small_bt3", 6, 10, ws_small, ws_small, small.cfg.n_heads, 0.3,
              3)]
    e_fwd, e_bwd = {}, {}
    inputs = {}
    for name, B, T, ws, ws_b, nh, p, bt in cases:
        d = ws[2].shape[0]
        x = torch.randn(B, T, d, generator=gen, device=dev)
        dy = torch.randn(B, T, d, generator=gen, device=dev)
        seed = -123457 if name != "full_p0" else 99
        y = ET.encoder_layer_fwd(x, ws, seed, nh, p, True, bt, impl="kernel")
        y2 = ET.encoder_layer_fwd(x, ws, seed, nh, p, True, bt,
                                  impl="kernel")
        dx, dws = ET.encoder_layer_bwd(x, ws_b, seed, dy, nh, p, True, bt,
                                       impl="kernel")
        dx2, dws2 = ET.encoder_layer_bwd(x, ws_b, seed, dy, nh, p, True, bt,
                                         impl="kernel")
        if not (torch.equal(y, y2) and torch.equal(dx, dx2)
                and all(torch.equal(a, b) for a, b in zip(dws, dws2))):
            raise AssertionError(f"encoder layer {name}: two calls differ")
        yr = ET.encoder_layer_train_plain(x, ws, seed, nh, p, True, bt)
        rdx, rdws = ET.encoder_layer_bwd_plain(x, ws_b, seed, dy, nh, p,
                                               True, bt)
        e_fwd[name] = (rel_err(y, yr), TOL_TRAIN_K["encoder_layer_fwd"])
        e_bwd[f"{name}.dx"] = (rel_err(dx, rdx),
                               TOL_TRAIN_K["encoder_layer_bwd"])
        for wn, a, b in zip(ET.WEIGHT_NAMES, dws, rdws):
            e_bwd[f"{name}.{wn}"] = (rel_err(a, b),
                                     TOL_TRAIN_K["encoder_layer_bwd"])
        inputs[name] = (x, dy, seed)
    err_f = check("encoder_layer_fwd", e_fwd)
    err_b = check("encoder_layer_bwd", e_bwd)
    log(f"  encoder layer: K11 vs plain {e_fwd}; K12 worst "
        f"{max(e_bwd.items(), key=lambda kv: kv[1][0])}")

    nh = cfg.n_heads
    out = {}
    for p, key in ((p_layer, "full_p0.1"), (0.0, "full_p0")):
        x, dy, seed = inputs[key]
        lib_f = lib_b = None
        if p == 0.0:
            layer = library_encoder_layer(ws_full, nh, dev)
            mask = torch.nn.Transformer.generate_square_subsequent_mask(
                40, device=dev)
            with torch.no_grad():
                lib_y = layer(x, src_mask=mask, is_causal=True)
            lib_err = rel_err(lib_y, ET.encoder_layer_train_plain(
                x, ws_full, seed, nh, 0.0, True, 8))
            if not lib_err <= TOL_TRAIN_K["encoder_layer_fwd"]:
                raise AssertionError(f"TransformerEncoderLayer yardstick "
                                     f"disagrees: {lib_err:.3g}")
            xr = x.clone().requires_grad_(True)
            params = [xr] + list(layer.parameters())

            def lib_f():
                with torch.no_grad():
                    layer(x, src_mask=mask, is_causal=True)

            def lib_b():
                torch.autograd.grad(layer(xr, src_mask=mask, is_causal=True),
                                    params, dy)
        t_f = timings(
            lambda: ET.encoder_layer_fwd(x, ws_full, seed, nh, p, True, 8,
                                         impl="kernel"),
            lambda: ET.encoder_layer_train_plain(x, ws_full, seed, nh, p,
                                                 True, 8),
            lib_f, light=True)
        t_b = timings(
            lambda: ET.encoder_layer_bwd(x, ws_k12, seed, dy, nh, p, True, 8,
                                         impl="kernel"),
            lambda: ET.encoder_layer_bwd_plain(x, ws_k12, seed, dy, nh, p,
                                               True, 8),
            lib_b, light=True)
        if p == p_layer:
            t_b["by_kernel"] = kernel_breakdown(
                lambda: ET.encoder_layer_bwd(x, ws_k12, seed, dy, nh, p,
                                             True, 8, impl="kernel"))
            log(f"  K12 by kernel, p {p}: {json.dumps(t_b['by_kernel'])}")
        log(f"  encoder layer p {p}: K11 {t_f['ms']:.4f} ms; K12 "
            f"{t_b['ms']:.4f} ms; library fwd {t_f['library_ms']}, fwd+bwd "
            f"{t_b['library_ms']}")
        out[p] = (t_f, t_b)
    d, ff = cfg.tf_in_dim, cfg.tf_hid_size
    entries = []
    for name, backward, err, src_line in (
            ("encoder_layer_fwd", False, err_f, 290),
            ("encoder_layer_bwd", True, err_b, 327)):
        work = encoder_layer_work(256, 40, d, ff, nh, backward)
        b_ms, b_by = bound(*work)
        b3_ms, b3_by = bound(*work, peak_flop_s=PEAK_3XTF32_FLOP_S)
        t_main, t_p0 = out[p_layer][backward], out[0.0][backward]
        entries.append(dict(
            name=name, route="cuda",
            source="tip_tpu_torch/csrc/encoder_train.cu",
            replaces=f"tip_tpu/ops/pallas_encoder.py:{src_line}",
            shape=[256, 40, d], p=p_layer, max_abs_err=err,
            tol=TOL_TRAIN_K[name], err_is="relative to the largest entry",
            bound_ms=b_ms, bound_by=b_by, bound_3xtf32_ms=b3_ms,
            bound_3xtf32_by=b3_by, **t_main,
            at_p0={k: t_p0[k] for k in ("ms", "call_ms", "plain_ms",
                                         "library_ms", "library_call_ms")},
            library="torch.nn.TransformerEncoderLayer (p = 0 only)"
                    + (", its autograd backward" if backward else "")))
    return entries


# K11 in bf16 against its plain version in bf16 (relative to the largest
# entry): both round every product's operands to bf16 and y to bf16, but
# sum in another order, so an activation that lies at a bf16 rounding
# boundary rounds the other way before the next product, and an entry of y
# moves by a bf16 step (2^-8 to 2^-7 of it); held within 2^-6 of the
# largest entry
TOL_ENC_BF16 = 2.0 ** -6
ENC_BF16_B = (1, 64, 256)       # A-bf16's frame, K-bf16's tick, training's


def encoder_attention_unrounded(x, ws, n_heads):
    """Control: K11's bf16 layer at p 0 with the attention's q, k, p and v
    kept in f32 (their rounding to bf16 left out); the dense products round
    both operands to bf16 as the plain version does. y in x's dtype."""
    from tip_tpu_torch.ops import encoder_train as ET
    (w_qkv, b_qkv, w_o, b_o, w_f1, b_f1, w_f2, b_f2, g1, be1, g2, be2) = (
        w.float() for w in ws)

    def r(t):
        return t.to(torch.bfloat16).float()

    B, T, d = x.shape
    hd = d // n_heads
    xf = x.float().reshape(B * T, d)
    qkv = r(xf) @ w_qkv + b_qkv
    q, k, v = (qkv[:, i * d:(i + 1) * d].reshape(B, T, n_heads, hd)
               .transpose(1, 2) for i in range(3))
    causal = torch.triu(torch.full((T, T), -1e30, device=x.device),
                        diagonal=1)
    p = torch.softmax((q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
                      + causal, dim=-1)
    att = (p @ v).transpose(1, 2).reshape(B * T, d)
    y1 = ET._ln_fwd(xf + (r(att) @ w_o + b_o), g1, be1)[0]
    f1 = torch.clamp_min(r(y1) @ w_f1 + b_f1, 0.0)
    y2 = ET._ln_fwd(y1 + (r(f1) @ w_f2 + b_f2), g2, be2)[0]
    return y2.reshape(B, T, d).to(x.dtype)


def small_bf16_cases(dev, gen):
    """The bf16 encoder layer at the CPU tests' small widths (8-wide heads,
    d 32, ff 64) and T 10, which no tile divides: [(tag, x, ws, n_heads,
    bt, p)], two batch tiles of 8 and three of 2."""
    from tip_tpu_torch.ops import encoder_train as ET
    bf = torch.bfloat16
    small = small_model(dev)
    ws = tuple(w.detach().contiguous() for w in ET.pack_layer_weights(
        {k: v.to(bf) for k, v in small.named_parameters()}, "layers.0.", bf))
    d, nh = small.cfg.tf_in_dim, small.cfg.n_heads
    return [(tag, torch.randn(B, 10, d, generator=gen, device=dev).to(bf),
             ws, nh, bt, p)
            for tag, B, bt, p in (("small_2tiles", 16, 8, 0.1),
                                  ("small_bt2", 6, 2, 0.3))]


def random_layer_weights(d, ff, gen, dev):
    """A layer's 12 weights at (d, ff): the eight matmul weights and
    biases in bf16 (fan-in scaled), the LayerNorm vectors in f32."""
    bf = torch.bfloat16
    ws = []
    for shape in ((d, 3 * d), (3 * d,), (d, d), (d,), (d, ff), (ff,),
                  (ff, d), (d,)):
        fan = shape[0] if len(shape) == 2 else 16
        ws.append((torch.randn(*shape, generator=gen, device=dev)
                   / math.sqrt(fan)).to(bf))
    for base in (1.0, 0.0, 1.0, 0.0):
        ws.append(base + 0.1 * torch.randn(d, generator=gen, device=dev))
    return tuple(w.contiguous() for w in ws)


# Shapes past the full-width layer's that the bf16 attention takes in
# passes of 64 keys and 64 head columns: windows of 65-133 (up to 9 row
# tiles, one head a block), heads 128 and 832 wide (d 832, one head), and
# T 1: (tag, B, T, d, n_heads, ff, bt, p)
LONG_BF16 = (("T100", 4, 100, 256, 16, 1024, 2, 0.1),
             ("T100_hd64", 2, 100, 256, 4, 256, 2, 0.0),
             ("T133", 2, 133, 256, 16, 256, 1, 0.1),
             ("T65_hd64", 2, 65, 256, 4, 256, 2, 0.1),
             ("T40_hd128", 4, 40, 256, 2, 512, 2, 0.1),
             ("T17_d832", 2, 17, 832, 1, 64, 1, 0.0),
             ("T1", 3, 1, 32, 4, 64, 3, 0.0))


def long_bf16_cases(dev, gen):
    """LONG_BF16 as small_bf16_cases gives its cases, random weights."""
    bf = torch.bfloat16
    return [(tag, torch.randn(B, T, d, generator=gen, device=dev).to(bf),
             random_layer_weights(d, ff, gen, dev), nh, bt, p)
            for tag, B, T, d, nh, ff, bt, p in LONG_BF16]


def encoder_bf16_plans(B, T, d, ff):
    """The launch plan of K11 bf16's and K12 bf16's twelve products at B
    (ops/encoder_train.py's encoder_bf16_plan), logged once a B: {name,
    tiles of 64 x bn, splits, blocks}, and the reason for fewer than 132
    blocks where the shapes give fewer."""
    from tip_tpu_torch.ops import encoder_train as ET
    out = [dict(name=p.name, layout=p.layout, mnk=[p.M, p.N, p.K],
                tile=[p.bm, p.bn], tiles=p.tiles, splits=p.splits,
                ctas=p.ctas, **({"why": p.reason} if p.reason else {}))
           for p in ET.encoder_bf16_plan(B, T, d, ff)]
    log(f"  bf16 encoder layer plan B {B}: " + "; ".join(
        f"{q['name']} {q['tiles']} tiles of {q['tile'][0]}x{q['tile'][1]} x "
        f"{q['splits']} splits = {q['ctas']} CTAs" for q in out))
    return out


def encoder_controls(x, ws, n_heads, layer):
    """The controls of K11 bf16's rounding check on x at p 0: {name: their
    y in bf16}. layer: TransformerEncoderLayer in bf16
    (library_encoder_layer)."""
    from tip_tpu_torch.ops import encoder_train as ET
    T = x.shape[1]
    mask = torch.nn.Transformer.generate_square_subsequent_mask(
        T, device=x.device, dtype=x.dtype)
    with torch.no_grad():
        return {"attention_unrounded": encoder_attention_unrounded(
                    x, ws, n_heads),
                "library_bf16": layer(x, src_mask=mask, is_causal=True),
                "f32_widened": ET.encoder_layer_train_plain(
                    x.float(), tuple(w.float() for w in ws), 0, n_heads,
                    0.0, False, 8).to(x.dtype)}


def check_encoder_fwd_bf16(dev, gen, model):
    """K11's bf16 variant against its bf16 plain version at (B, 40, 256)
    for B in ENC_BF16_B (the model's layer 0 in bf16), p 0 and p 0.1
    train, twice each bit-equal, and its share of entries off the plain
    version against the controls' (check_rounding); at the small widths
    and LONG_BF16's shapes, twice bit-equal; timed at p 0 beside
    torch's TransformerEncoderLayer in bf16. The entry's own numbers are
    B 1's (A-bf16's shape), the other Bs are its variants."""
    from tip_tpu_torch.ops import encoder_train as ET
    cfg = model.cfg
    nh, d, ff, T = cfg.n_heads, cfg.tf_in_dim, cfg.tf_hid_size, 40
    bf = torch.bfloat16
    ws = tuple(w.detach().contiguous() for w in ET.pack_layer_weights(
        {k: v.to(bf) for k, v in model.named_parameters()}, "layers.0.", bf))
    layer = library_encoder_layer(ws, nh, dev)
    plans = {B: encoder_bf16_plans(B, T, d, ff) for B in ENC_BF16_B}
    errs, inputs = {}, {}
    share, controls = OffShare(), {}
    for B in ENC_BF16_B:
        for p in (0.0, 0.1):
            x = torch.randn(B, T, d, generator=gen, device=dev).to(bf)
            seed = -123457 if p else 99
            y = ET.encoder_layer_fwd(x, ws, seed, nh, p, True, 8,
                                     impl="kernel")
            if y.dtype != bf or not torch.equal(y, ET.encoder_layer_fwd(
                    x, ws, seed, nh, p, True, 8, impl="kernel")):
                raise AssertionError(f"encoder_layer_fwd_bf16 B {B} p {p}: "
                                     f"two calls differ, or y is {y.dtype}")
            yr = ET.encoder_layer_train_plain(x, ws, seed, nh, p, True, 8)
            errs[f"B{B}_p{p}"] = (rel_err(y, yr), TOL_ENC_BF16)
            share.add(y, yr)
            if not p:
                for c, yc in encoder_controls(x, ws, nh, layer).items():
                    controls.setdefault(c, OffShare()).add(yc, yr)
            inputs[B] = (x, seed)
    for tag, x, ws_s, nh_s, bt, p in (small_bf16_cases(dev, gen)
                                      + long_bf16_cases(dev, gen)):
        y = ET.encoder_layer_fwd(x, ws_s, 7, nh_s, p, True, bt,
                                 impl="kernel")
        if not torch.equal(y, ET.encoder_layer_fwd(x, ws_s, 7, nh_s, p, True,
                                                   bt, impl="kernel")):
            raise AssertionError(f"encoder_layer_fwd_bf16 {tag}: two calls "
                                 f"differ")
        errs[tag] = (rel_err(y, ET.encoder_layer_train_plain(
            x, ws_s, 7, nh_s, p, True, bt)), TOL_ENC_BF16)
    err = check("encoder_layer_fwd_bf16", errs)
    log(f"  K11 bf16 vs plain: {errs}")
    rounding = check_rounding("encoder_layer_fwd_bf16", share, controls)
    mask = torch.nn.Transformer.generate_square_subsequent_mask(
        T, device=dev, dtype=bf)
    variants = []
    for B in ENC_BF16_B:
        x = inputs[B][0]

        def lib_f(x=x):
            with torch.no_grad():
                return layer(x, src_mask=mask, is_causal=True)

        lib_err = rel_err(lib_f(), ET.encoder_layer_train_plain(
            x, ws, 0, nh, 0.0, False, 8))
        if not lib_err <= TOL_LIB_BF16:
            raise AssertionError(f"TransformerEncoderLayer bf16 yardstick "
                                 f"disagrees at B {B}: {lib_err:.3g}")
        t = timings(
            lambda x=x: ET.encoder_layer_fwd(x, ws, 0, nh, 0.0, False, 8,
                                             impl="kernel"),
            lambda x=x: ET.encoder_layer_train_plain(x, ws, 0, nh, 0.0,
                                                     False, 8),
            lib_f, light=True)
        b_ms, b_by = bound(*encoder_layer_work(B, T, d, ff, nh, False, 2),
                           PEAK_BF16_FLOP_S)
        t["by_kernel"] = kernel_breakdown(
            lambda x=x: ET.encoder_layer_fwd(x, ws, 0, nh, 0.0, False, 8,
                                             impl="kernel"))
        log(f"  K11 bf16 B {B} by kernel: {json.dumps(t['by_kernel'])}")
        variants.append(dict(B=B, p=0.0, bound_ms=b_ms, bound_by=b_by,
                             library_err=lib_err, plan=plans[B][:4], **t))
        log(f"  K11 bf16 B {B} p 0: device {t['ms']:.4f} ms (eager "
            f"{t['call_ms']:.4f}), plain {t['plain_ms']:.4f}, library "
            f"{t['library_ms']:.4f} (rel err {lib_err:.3g}), bound "
            f"{b_ms:.2e} ({b_by})")
    own = {k: v for k, v in variants[0].items() if k != "B"}
    return dict(name="encoder_layer_fwd_bf16", route="cuda",
                source="tip_tpu_torch/csrc/encoder_train.cu",
                replaces="tip_tpu/ops/pallas_encoder.py:290",
                shape=[ENC_BF16_B[0], T, d], dtype="bfloat16",
                max_abs_err=err, tol=TOL_ENC_BF16,
                err_is="relative to the largest entry",
                library="torch.nn.TransformerEncoderLayer, bf16, p = 0",
                rounding=rounding, **own, variants=variants[1:])


# ---------------------------------------------------------------------------
# bf16 training: the bf16 variants of K10 and K12, paths L-bf16 and M-bf16
# ---------------------------------------------------------------------------

# K10 and K12 in bf16 against their plain versions in bf16, relative to
# each output's largest entry: both round the same operands to bf16 and sum
# in f32, but in another order, so a value that ends at a bf16 rounding
# boundary rounds the other way and moves by a bf16 step (2^-8 of it); the
# recurrence (K10) and the chain of products (K12) carry such a step on
# into later roundings. Held within 2^-6 of the largest entry
TOL_RNN_BWD_BF16 = 2.0 ** -6
TOL_ENC_BWD_BF16 = 2.0 ** -6
RNN_BWD_BF16_B = (1, 3, 64, 256)     # one stream, a partial tile, 64, L's
ENC_BWD_BF16_B = (1, 64, 256)


def rnn_bwd_steps_plain(hs, w, g, dx):
    """K10 bf16's plain version step by step from the kernel's own output:
    each dx_t from dx_{t+1} in place of the plain version's own (dx_t =
    bf16((g_t + dx_{t+1} W^T)(1 - h_t^2)) in f32, dx_T = 0), and dW =
    bf16(sum over t of h_{t-1}^T dx_t) summed in f32 from that dx: what
    K10 rounds, without the flips the recurrence would carry on."""
    f = torch.float32
    B, T, H = hs.shape
    h = hs.to(f)
    nxt = torch.cat([dx[:, 1:], torch.zeros_like(dx[:, :1])], dim=1).to(f)
    steps = ((g.to(f) + nxt @ w.to(f).T) * (1.0 - h * h)).to(dx.dtype)
    prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    dw = prev.reshape(-1, H).T @ dx.to(f).reshape(-1, H)
    return steps, dw.to(w.dtype)


def rnn_bwd_da_unrounded(hs, w, g):
    """Control: K10 bf16's recurrence with da carried into the next step's
    product and into dW in f32 (its rounding to bf16 left out; dx is still
    written in bf16)."""
    f = torch.float32
    B, T, H = hs.shape
    wt = w.to(f).T
    da = hs.new_zeros((B, H), dtype=f)
    dw = hs.new_zeros((H, H), dtype=f)
    dx = torch.empty_like(hs)
    for t in range(T - 1, -1, -1):
        h_t = hs[:, t].to(f)
        da = (g[:, t].to(f) + da @ wt) * (1.0 - h_t * h_t)
        dx[:, t] = da
        if t > 0:
            dw = dw + hs[:, t - 1].to(f).T @ da
    return dx, dw.to(w.dtype)


def rnn_bwd_dw_split_rounded(hs, dx, plan):
    """Control: dW = hs^T shifted (fused_rnn.shifted_rows of dx, K10 bf16's
    product) with each of the plan's split partial products over its rows
    rounded to bf16 before they are added."""
    from tip_tpu_torch.ops import fused_rnn as FR
    f = torch.float32
    H = hs.shape[2]
    a = hs.to(f).reshape(-1, H)
    d = FR.shifted_rows(dx).to(f).reshape(-1, H)
    dw = torch.zeros((H, H), dtype=f, device=hs.device)
    for s in range(plan.dw_splits):
        r = slice(s * plan.dw_rows, (s + 1) * plan.dw_rows)
        dw = dw + (a[r].T @ d[r]).to(torch.bfloat16).to(f)
    return dw.to(torch.bfloat16)


def hold_rnn_bwd_steps(share, hs, w, g, dx, dw):
    """Add K10 bf16's (or a control's) dx and dW to share against the plain
    version's steps from its own dx (rnn_bwd_steps_plain)."""
    steps, dw_plain = rnn_bwd_steps_plain(hs, w, g, dx)
    share.add(dx, steps)
    share.add(dw, dw_plain)


def check_fused_rnn_bwd(dev, gen, dtype=torch.float32):
    """K10 in dtype: float32 (check_fused_rnn_bwd_f32) or its bf16 variant
    (check_fused_rnn_bwd_bf16)."""
    if dtype == torch.bfloat16:
        return check_fused_rnn_bwd_bf16(dev, gen)
    return check_fused_rnn_bwd_f32(dev, gen)


def check_fused_rnn_bwd_bf16(dev, gen):
    """K10's bf16 variant against its bf16 plain version at (B, 40, 512)
    for B in RNN_BWD_BF16_B on hidden states that K1 bf16 gives, two calls
    bit-equal; its share of dx and dW entries off the plain version step by
    step (rnn_bwd_steps_plain) against controls that round elsewhere
    (check_rounding) and cuDNN's bf16 RNN backward (read only); timed at
    RNN_TIMED_B beside cuDNN's bf16 backward (forward + backward less
    forward), by kernel at B 256. The entry's own numbers are B 256's (path
    L-bf16's shape), the other Bs are its variants."""
    from tip_tpu_torch.ops import fused_rnn as FR
    bf = torch.bfloat16
    name = "fused_rnn_bwd_bf16"
    H, T = 512, 40
    w = ((torch.rand(H, H, generator=gen, device=dev) * 2 - 1)
         / math.sqrt(H)).to(bf)
    errs, share, controls, inputs = {}, OffShare(), {}, {}
    for B in RNN_BWD_BF16_B:
        xin = (torch.randn(B, T, H, generator=gen, device=dev) * 0.5).to(bf)
        hs = FR.fused_rnn(xin, w, impl="kernel")
        g = torch.randn(B, T, H, generator=gen, device=dev).to(bf)
        dx, dw = FR.fused_rnn_bwd(hs, w, g, impl="kernel")
        dx2, dw2 = FR.fused_rnn_bwd(hs, w, g, impl="kernel")
        if (dx.dtype, dw.dtype) != (bf, bf) or not (
                torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            raise AssertionError(f"{name} B {B}: two calls differ, or the "
                                 f"outputs are {dx.dtype}, {dw.dtype}")
        rx, rw = FR.fused_rnn_bwd_plain(hs, w, g)
        errs[f"dx_B{B}"] = (rel_err(dx, rx), TOL_RNN_BWD_BF16)
        errs[f"dw_B{B}"] = (rel_err(dw, rw), TOL_RNN_BWD_BF16)
        hold_rnn_bwd_steps(share, hs, w, g, dx, dw)
        fx, fw = FR.fused_rnn_bwd(hs.float(), w.float(), g.float(),
                                  impl="kernel")
        ctl = {"da_unrounded": rnn_bwd_da_unrounded(hs, w, g),
               "f32_kernel_widened": (fx.to(bf), fw.to(bf))}
        plan = FR.fused_rnn_bwd_plan(B, T, H, 2)
        if plan.dw_splits > 1:
            ctl["dw_split_rounded"] = (dx, rnn_bwd_dw_split_rounded(
                hs, dx, plan))
        x_lib = (torch.randn(B, T, H, generator=gen, device=dev) * 0.5).to(bf)
        _, lib_f, (lx, lw) = library_rnn_bwd(w, x_lib, g, dev)
        with torch.no_grad():
            hs_lib = lib_f()
        hold_rnn_bwd_steps(controls.setdefault("cudnn_bf16", OffShare()),
                           hs_lib, w, g, lx, lw)
        for c, (cx, cw) in ctl.items():
            hold_rnn_bwd_steps(controls.setdefault(c, OffShare()), hs, w, g,
                               cx, cw)
        inputs[B] = (hs, g, x_lib)
    err = check(name, errs)
    log(f"  {name} vs plain: {errs}")
    rounding = check_rounding(name, share, controls)
    cpn = sm_cycles_per_ns(dev)
    variants = []
    for B in RNN_TIMED_B:
        hs, g, x_lib = inputs[B]
        plan = FR.fused_rnn_bwd_plan(B, T, H, 2)
        log(f"  {name} B {B} plan: {plan}")
        clock = rnn_step_clock(lambda c, hs=hs, g=g: FR.fused_rnn_bwd(
            hs, w, g, impl="kernel", clock=c), dev, T, cpn)
        log(f"  {name} B {B} step by phase (ns): "
            f"{json.dumps({k: round(v, 1) for k, v in clock.items()})}")
        lib_fb, lib_f, lib_out = library_rnn_bwd(w, x_lib, g, dev)
        with torch.no_grad():
            hs_lib = lib_f()
        lib_err = max(rel_err(a, b) for a, b in zip(
            lib_out, FR.fused_rnn_bwd_plain(hs_lib, w, g)))
        if not lib_err <= TOL_LIB_BF16:
            raise AssertionError(f"cuDNN's bf16 RNN backward yardstick "
                                 f"disagrees at B {B}: {lib_err:.3g}")
        t = timings(lambda hs=hs, g=g: FR.fused_rnn_bwd(hs, w, g,
                                                        impl="kernel"),
                    lambda hs=hs, g=g: FR.fused_rnn_bwd_plain(hs, w, g),
                    light=True)
        fb = timings(lib_fb, lib_f, light=True)
        t.update(library_ms=fb["ms"] - fb["plain_ms"],
                 library_call_ms=fb["call_ms"] - fb["plain_call_ms"],
                 library_fwd_bwd_ms=fb["ms"], library_fwd_ms=fb["plain_ms"])
        if B == RNN_BWD_BF16_B[-1]:
            t["by_kernel"] = kernel_breakdown(
                lambda: FR.fused_rnn_bwd(hs, w, g, impl="kernel"))
            log(f"  K10 bf16 B {B} by kernel: {json.dumps(t['by_kernel'])}")
            # the walk on the tensor cores and dW on wgmma, at most one
            # launch each a call (the profiler can miss one of its window's)
            kinds = sorted(("tc_walk_kernel" in r[0], "gemm_kernel" in r[0])
                           for r in t["by_kernel"])
            if kinds != [(False, True), (True, False)] or any(
                    r[2] > 1 for r in t["by_kernel"]):
                raise AssertionError(f"{name}: expected the walk and dW, one "
                                     f"launch each, got {t['by_kernel']}")
        b_ms, b_by = bound(*rnn_bwd_work(B, T, H, 2), PEAK_BF16_FLOP_S)
        variants.append(dict(
            B=B, bound_ms=b_ms, bound_by=b_by, library_err=lib_err,
            plan=dataclasses.asdict(plan), step_ns=clock, **t))
        log(f"  {name} B {B}: device {t['ms']:.4f} ms (eager "
            f"{t['call_ms']:.4f}), cuDNN backward {t['library_ms']:.4f} "
            f"(rel err {lib_err:.3g}), plain {t['plain_ms']:.4f}, bound "
            f"{b_ms:.2e} ({b_by})")
    own = {k: v for k, v in variants[-1].items() if k != "B"}
    return dict(name=name, route="cuda",
                source="tip_tpu_torch/csrc/fused_rnn_bwd.cu",
                replaces="tip_tpu/ops/pallas_kernels.py:148",
                shape=[RNN_TIMED_B[-1], T, H], dtype="bfloat16",
                max_abs_err=err, tol=TOL_RNN_BWD_BF16,
                err_is="relative to the largest entry",
                library="cuDNN nn.RNN backward in bf16 (to x and W_hh; it "
                        "also forms dW_ih), forward + backward less forward",
                rounding_step_by_step=rounding, **own,
                variants=variants[:-1])


def attention_bwd_plain(qkv, datt, masks, n_heads, B, T, rnd, rnd_ops):
    """The attention backward of K12's plain version from qkv and datt (N,
    ·): the probabilities from rnd(q) rnd(k)^T as the forward forms them,
    the four products' operands through rnd_ops. dqkv (N, 3 d)."""
    from tip_tpu_torch.ops import encoder_train as ET
    qkv, datt = qkv.float(), datt.float()
    d = datt.shape[1]
    hd = d // n_heads

    def heads(t):
        return t.reshape(B, T, n_heads, hd).transpose(1, 2)

    def flat(t):
        return t.transpose(1, 2).reshape(B * T, d)

    q, k, v = heads(qkv[:, :d]), heads(qkv[:, d:2 * d]), heads(qkv[:, 2 * d:])
    scale = 1.0 / math.sqrt(hd)
    causal = torch.triu(torch.full((T, T), -1e30, device=qkv.device),
                        diagonal=1)
    p = torch.softmax((rnd(q) @ rnd(k).transpose(-1, -2)) * scale + causal,
                      dim=-1)
    dq, dk, dv = ET.attention_bwd(
        p, masks.attention(n_heads) if masks.on else None, q, k, v,
        heads(datt), scale, rnd_ops)
    return torch.cat([flat(dq), flat(dk), flat(dv)], dim=1)


def k12_stages_plain(v, x, ws, seed, n_heads, p, B, T, rnd, rnd_attn=None,
                     bt=8):
    """K12's backward stage by stage, each stage (a product with its
    epilogue, or a bias gradient's column sum) computed plainly from the
    kernel's own inputs to it (v: the views of the scratch it ran in,
    ``ET.k12_scratch``), the products' operands through rnd (bf16
    rounding, or none), the attention's four through rnd_attn (default
    rnd): {stage: f32}. What K12 rounds, without the flips that later
    stages would carry on. A bias gradient sums the f32 values of its
    stage: df2 and da from the kernel's dr2 and dr1, dh1 and dqkv as this
    function forms them (the bf16 variant keeps them in bf16 only)."""
    from tip_tpu_torch.ops import encoder_train as ET
    rnd_attn = rnd if rnd_attn is None else rnd_attn
    N, d, ff = B * T, ws[2].shape[0], ws[4].shape[1]
    xf, masks = ET._prepare(x, ws, seed, p, True, bt)
    w_qkv, _, w_o, _, w_f1, _, w_f2, _ = (w.float() for w in ws[:8])

    def mask(site, n):
        return masks.rows(site, n).reshape(N, n) if masks.on else 1.0

    df2, dh1, da, dqkv = (v[k].float() for k in ("df2", "dh1", "da", "dqkv"))
    pos = v["pos"].bool() if "pos" in v else v["f1"] > 0
    out = {
        "w_f2": rnd(v["f1d"].float()).T @ rnd(df2),
        "b_f2": (v["dr2"] * mask(ET.SITE_POST_FF, d)).sum(0),
        "dh1": (rnd(df2) @ w_f2.T) * mask(ET.SITE_FF_MID, ff) * pos.float(),
        "w_f1": rnd(v["y1"]).T @ rnd(dh1),
        "dy1": v["dr2"] + rnd(dh1) @ w_f1.T,
        "w_o": rnd(v["att"].float()).T @ rnd(da),
        "b_o": (v["dr1"] * mask(ET.SITE_POST_ATTN, d)).sum(0),
        "datt": rnd(da) @ w_o.T,
        "dqkv": attention_bwd_plain(v["qkv"], v["datt"], masks, n_heads, B,
                                    T, rnd, rnd_attn),
        "w_qkv": rnd(xf.reshape(N, d)).T @ rnd(dqkv),
        "dx": v["dr1"] + rnd(dqkv) @ w_qkv.T}
    out["b_f1"] = out["dh1"].sum(0)
    out["b_qkv"] = out["dqkv"].sum(0)
    return out


def k12_stages_kernel(v, dx, grads):
    """The same stages as K12 left them: the activation gradients in its
    scratch (v), dx and the eight matmul-weight and bias gradients."""
    from tip_tpu_torch.ops import encoder_train as ET
    out = {k: v[k] for k in ("dh1", "dy1", "datt", "dqkv")}
    out["dx"] = dx.reshape(v["dr1"].shape)
    for name, g in zip(ET.WEIGHT_NAMES[:8], grads):
        out[name] = g
    return out


def hold_k12_stages(share, got, want):
    """Add each stage of got to share against want's, both rounded to
    bf16 (the roundings that the kernel should share with the plain
    version)."""
    for k, a in got.items():
        share.add(a.to(torch.bfloat16), want[k].to(torch.bfloat16))


def library_encoder_grads(layer, x, dy):
    """TransformerEncoderLayer's autograd backward (p 0, causal) of y = layer
    (x) for the output gradient dy: dx and the eight matmul-weight and bias
    gradients in the port's layout (the read-only control of K12 bf16)."""
    mask = torch.nn.Transformer.generate_square_subsequent_mask(
        x.shape[1], device=x.device, dtype=x.dtype)
    xr = x.clone().requires_grad_(True)
    a = layer.self_attn
    params = [a.in_proj_weight, a.in_proj_bias, a.out_proj.weight,
              a.out_proj.bias, layer.linear1.weight, layer.linear1.bias,
              layer.linear2.weight, layer.linear2.bias]
    out = torch.autograd.grad(layer(xr, src_mask=mask, is_causal=True),
                              [xr] + params, dy)
    return out[0], [g.T if g.dim() == 2 else g for g in out[1:]]


def check_encoder_bwd_bf16(dev, gen, model):
    """K12's bf16 variant against its bf16 plain version at (B, 40, 256)
    for B in ENC_BWD_BF16_B (the model's layer 0 in bf16, ff1 shifted by
    K12_FF1_SHIFT), p 0 and p 0.1 train, twice each bit-equal, the
    forward it recomputes (its scratch's y) bit-equal to K11 bf16's y on
    the same inputs; stage by
    stage (k12_stages_plain, from the kernel's own scratch) its share of
    entries off the plain version against controls that round elsewhere
    (the attention backward's operands unrounded, f32 K12 on widened
    inputs; TransformerEncoderLayer bf16's autograd, read only, on its
    outputs); at the small widths and LONG_BF16's shapes end to end (dx
    and the 12 gradients) and stage by stage, twice bit-equal, its y K11
    bf16's; timed at p 0 beside TransformerEncoderLayer bf16's autograd
    forward + backward, by kernel at B 256. The entry's own numbers are
    B 256's (path L-bf16's shape), the other Bs are its variants."""
    from tip_tpu_torch.ops import encoder_train as ET
    name = "encoder_layer_bwd_bf16"
    cfg = model.cfg
    nh, d, ff, T = cfg.n_heads, cfg.tf_in_dim, cfg.tf_hid_size, 40
    bf = torch.bfloat16
    ws = list(ET.pack_layer_weights(
        {k: v.detach().to(bf) for k, v in model.named_parameters()},
        "layers.0.", bf))
    ws[5] = ws[5] + K12_FF1_SHIFT
    ws = tuple(w.contiguous() for w in ws)
    ws32 = tuple(w.float() for w in ws)
    layer = library_encoder_layer(ws, nh, dev)

    def r16(t):
        return t.to(bf).float()

    errs, share, controls, out_share, inputs = {}, OffShare(), {}, \
        OffShare(), {}
    recompute_equal = {}
    for B in ENC_BWD_BF16_B:
        x0 = torch.empty(B, T, d, device=dev)
        lay16, buf16 = ET.k12_scratch(x0.to(bf), ws, nh)
        lay32, buf32 = ET.k12_scratch(x0, ws32, nh)
        for p in (0.0, 0.1):
            x = torch.randn(B, T, d, generator=gen, device=dev).to(bf)
            dy = torch.randn(B, T, d, generator=gen, device=dev).to(bf)
            seed = -123457 if p else 99
            dx, dws = ET._launch_bwd(x, ws, seed, dy, nh, p, True, 8,
                                     scratch=buf16)
            dx2, dws2 = ET.encoder_layer_bwd(x, ws, seed, dy, nh, p, True, 8,
                                             impl="kernel")
            if dx.dtype != bf or [g.dtype for g in dws] != [
                    w.dtype for w in ws] or not (torch.equal(dx, dx2) and all(
                        torch.equal(a, b) for a, b in zip(dws, dws2))):
                raise AssertionError(f"{name} B {B} p {p}: two calls differ, "
                                     f"or the dtypes are not the weights'")
            rdx, rdws = ET.encoder_layer_bwd_plain(x, ws, seed, dy, nh, p,
                                                   True, 8)
            errs[f"B{B}_p{p}.dx"] = (rel_err(dx, rdx), TOL_ENC_BWD_BF16)
            for wn, a, b in zip(ET.WEIGHT_NAMES, dws, rdws):
                errs[f"B{B}_p{p}.{wn}"] = (rel_err(a, b), TOL_ENC_BWD_BF16)
            for a, b in zip((dx, *dws[:8]), (rdx, *rdws[:8])):
                out_share.add(a, b)
            v = lay16.views(buf16)
            y11 = ET.encoder_layer_fwd(x, ws, seed, nh, p, True, 8,
                                       impl="kernel")
            if not torch.equal(v["y"], y11.reshape(B * T, d)):
                raise AssertionError(f"{name} B {B} p {p}: the forward K12 "
                                     f"recomputes differs from K11 bf16's y")
            recompute_equal[f"B{B}_p{p}"] = True
            want = k12_stages_plain(v, x, ws, seed, nh, p, B, T, r16)
            got = k12_stages_kernel(v, dx, dws)
            hold_k12_stages(share, got, want)
            stage_errs = {k: rel_err(got[k], want[k]) for k in got}
            hold_k12_stages(controls.setdefault("attention_unrounded",
                                                OffShare()),
                            k12_stages_plain(v, x, ws, seed, nh, p, B, T,
                                             r16, lambda t: t), want)
            fdx, fdws = ET._launch_bwd(x.float(), ws32, seed, dy.float(), nh,
                                       p, True, 8, scratch=buf32)
            fv = lay32.views(buf32)
            hold_k12_stages(controls.setdefault("f32_widened", OffShare()),
                            k12_stages_kernel(fv, fdx, fdws),
                            k12_stages_plain(fv, x, ws, seed, nh, p, B, T,
                                             r16))
            if not p:
                ldx, lgs = library_encoder_grads(layer, x, dy)
                lib = controls.setdefault("library_bf16", OffShare())
                for a, b in zip((ldx, *lgs), (rdx, *rdws[:8])):
                    lib.add(a, b)
                inputs[B] = (x, dy, seed)
        del buf16, buf32
    log(f"  K12 bf16's recomputed y bit-equal to K11 bf16's: "
        f"{recompute_equal}")
    for tag, x, ws_s, nh_s, bt, p in (small_bf16_cases(dev, gen)
                                      + long_bf16_cases(dev, gen)):
        # ff1 shifted as at full width: no ReLU input within a rounding
        # of 0. End to end (dx and the 12 gradients), and stage by stage,
        # each stage from the kernel's own inputs
        ws_s = list(ws_s)
        ws_s[5] = (ws_s[5] + K12_FF1_SHIFT).contiguous()
        ws_s = tuple(ws_s)
        B_s, T_s, d_s = x.shape
        dy = torch.randn(x.shape, generator=gen, device=dev).to(bf)
        lay, buf = ET.k12_scratch(x, ws_s, nh_s)
        dx, dws = ET._launch_bwd(x, ws_s, 7, dy, nh_s, p, True, bt,
                                 scratch=buf)
        dx2, dws2 = ET._launch_bwd(x, ws_s, 7, dy, nh_s, p, True, bt)
        if not (torch.equal(dx, dx2)
                and all(torch.equal(a, b) for a, b in zip(dws, dws2))):
            raise AssertionError(f"{name} {tag}: two calls differ")
        v = lay.views(buf)
        if not torch.equal(v["y"], ET.encoder_layer_fwd(
                x, ws_s, 7, nh_s, p, True, bt,
                impl="kernel").reshape(B_s * T_s, d_s)):
            raise AssertionError(f"{name} {tag}: the forward K12 recomputes "
                                 f"differs from K11 bf16's y")
        recompute_equal[tag] = True
        rdx, rdws = ET.encoder_layer_bwd_plain(x, ws_s, 7, dy, nh_s, p, True,
                                               bt)
        errs[f"{tag}.dx"] = (rel_err(dx, rdx), TOL_ENC_BWD_BF16)
        for wn, a, b in zip(ET.WEIGHT_NAMES, dws, rdws):
            errs[f"{tag}.{wn}"] = (rel_err(a, b), TOL_ENC_BWD_BF16)
        got = k12_stages_kernel(v, dx, dws)
        want = k12_stages_plain(v, x, ws_s, 7, nh_s, p, B_s, T_s, r16, bt=bt)
        errs[f"{tag}.stages"] = (max(rel_err(got[k], want[k]) for k in got),
                                 TOL_ENC_BWD_BF16)
    err = check(name, errs)
    log(f"  K12 bf16 vs plain: worst "
        f"{max(errs.items(), key=lambda kv: kv[1][0])}")
    for B in ENC_BWD_BF16_B:
        log(f"  K12 bf16 B {B} end to end by output: " + ", ".join(
            f"{k[len(f'B{B}_p0.0.'):]} {v[0]:.3g}" for k, v in errs.items()
            if k.startswith(f"B{B}_p0.0.")))
    log(f"  K12 bf16 B {ENC_BWD_BF16_B[-1]} p 0.1 stage by stage from its "
        f"own inputs: " + ", ".join(f"{k} {v:.3g}"
                                    for k, v in stage_errs.items()))
    rounding = check_rounding(name, share, controls)
    rounding["outputs_share"] = out_share.share()
    log(f"  K12 bf16 share of dx and the bf16 gradients off the plain "
        f"version end to end (read only): {out_share.share():.4g}")
    variants = []
    for B in ENC_BWD_BF16_B:
        x, dy, _ = inputs[B]
        xr = x.clone().requires_grad_(True)
        mask = torch.nn.Transformer.generate_square_subsequent_mask(
            T, device=dev, dtype=bf)
        params = [xr] + list(layer.parameters())

        def lib_b(xr=xr, params=params, dy=dy):
            torch.autograd.grad(layer(xr, src_mask=mask, is_causal=True),
                                params, dy)

        t = timings(
            lambda x=x, dy=dy: ET.encoder_layer_bwd(x, ws, 0, dy, nh, 0.0,
                                                    False, 8, impl="kernel"),
            lambda x=x, dy=dy: ET.encoder_layer_bwd_plain(x, ws, 0, dy, nh,
                                                          0.0, False, 8),
            lib_b, light=True)
        if B == ENC_BWD_BF16_B[-1]:
            t["by_kernel"] = kernel_breakdown(
                lambda: ET.encoder_layer_bwd(x, ws, 0, dy, nh, 0.0, False, 8,
                                             impl="kernel"))
            log(f"  K12 bf16 B {B} by kernel: {json.dumps(t['by_kernel'])}")
        b_ms, b_by = bound(*encoder_layer_work(B, T, d, ff, nh, True, 2),
                           PEAK_BF16_FLOP_S)
        variants.append(dict(B=B, p=0.0, bound_ms=b_ms, bound_by=b_by,
                             plan=[dict(name=q.name, bm=q.bm, bn=q.bn,
                                        splits=q.splits, ctas=q.ctas)
                                   for q in ET.encoder_bf16_plan(B, T, d,
                                                                 ff)],
                             **t))
        log(f"  K12 bf16 B {B} p 0: device {t['ms']:.4f} ms (eager "
            f"{t['call_ms']:.4f}), plain {t['plain_ms']:.4f}, library "
            f"forward + backward {t['library_ms']:.4f}, bound {b_ms:.2e} "
            f"({b_by})")
    own = {k: v for k, v in variants[-1].items() if k != "B"}
    return dict(name=name, route="cuda",
                source="tip_tpu_torch/csrc/encoder_train.cu",
                replaces="tip_tpu/ops/pallas_encoder.py:327",
                shape=[ENC_BWD_BF16_B[-1], T, d], dtype="bfloat16",
                max_abs_err=err, tol=TOL_ENC_BWD_BF16,
                err_is="relative to the largest entry",
                library="torch.nn.TransformerEncoderLayer, bf16, p = 0, its "
                        "autograd forward + backward",
                rounding_stage_by_stage=rounding,
                recompute_bit_equal=recompute_equal, **own,
                variants=variants[:-1])


def pack_training_blobs():
    """The 60 in-tree motions packed by the port's combine into output/."""
    from tip_tpu_torch.data_gen import combine as TC
    from tip_tpu_torch.train import data as TD
    prefix = ROOT / "output" / "chip_smoke_train"
    t0 = time.perf_counter()
    TC.combine([str(CORPUS)], [TRAIN_RATE], str(prefix), seed=42)
    log(f"  packed the in-tree motions in {time.perf_counter() - t0:.1f} s")
    return TD.PackedDataset.from_prefix(str(prefix))


def train_config(**model_kw):
    """The paper recipe (tip_tpu/cli/train.py's paper run) at full width."""
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.train import train as TT
    return TT.TrainConfig(model=M.ModelConfig(**model_kw), batch_size=256,
                          seq_len=40, lr=1e-4, optimizer="AdamW",
                          weight_decay=1e-4, clip=5.0, epochs=1100,
                          cosine_lr=True, noise_input_hist=0.15, seed=5104,
                          log_interval=1)


def step_batches(ds, n, B, dev, seed):
    """n batches of B windows drawn with numpy, gathered on the device."""
    from tip_tpu_torch.train import data as TD
    import numpy as np
    rng = torch.Generator().manual_seed(seed)
    dds = TD.to_device(ds, dev)
    idx = torch.as_tensor(TD.sample_epoch_indices(
        ds.info, 40, np.random.default_rng(seed)))
    out = []
    for i in range(n):
        pick = torch.randperm(len(idx), generator=rng)[:B]
        out.append(TD.device_gather(dds, idx[pick].to(dev), 40))
    return out


def time_train_steps(state, cfg, batches):
    """Median synced step time after TRAIN_WARMUP steps, peak memory, then
    device time and kernels per step over TRAIN_PROFILED steps
    (torch.profiler) against those steps' own host time."""
    from torch.profiler import ProfilerActivity, profile
    from tip_tpu_torch.train import train as TT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        t0 = time.perf_counter()
        TT.train_step(state, batches[i % len(batches)], cfg)
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    prof_times = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(TRAIN_PROFILED):
            t0 = time.perf_counter()
            TT.train_step(state, batches[i % len(batches)], cfg)
            torch.cuda.synchronize()
            prof_times.append((time.perf_counter() - t0) * 1e3)
    n = TRAIN_PROFILED
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return dict(step_ms=statistics.median(times),
                step_ms_all=times,
                windows_per_s=cfg.batch_size / statistics.median(times) * 1e3,
                device_ms_per_step=sum(r[1] for r in rows),
                kernels_per_step=sum(r[2] for r in rows),
                step_ms_profiled=statistics.median(prof_times),
                device_busy_share=sum(r[1] for r in rows)
                / statistics.median(prof_times),
                peak_mib=peak,
                top=[[k[:70], ms, c] for k, ms, c in rows[:8]])


def grads_of(model, batch, noise, seeds, cfg):
    """Loss, its terms, the gradient of every parameter and their global
    norm: the part of a train step before the optimizer."""
    from tip_tpu_torch.train import train as TT
    for p in model.parameters():
        p.grad = None
    total, aux = TT.loss_fn(model, *batch, noise, seeds, cfg)
    total.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    return ({k: v.item() for k, v in aux.items()}, grads, norm.item())


def check_l_against_f64(state, cfg, ds, dev):
    """Path L's step (kernels, f32, on the card) against the same step run
    plain in float64 on the CPU, from the same parameters, batch, noise and
    seeds. Loss and grad_norm within 1e-4 and every gradient within 1e-2 of
    its norm in every draw; every gradient within 1e-3 of its largest
    entry in at least one draw. A draw whose two runs fall on two sides of
    a ReLU kink or of a dropout threshold (the f64 run compares its layer
    masks in f64, as tip_tpu's f64 run does) moves a few entries by a
    whole term (see K12_FF1_SHIFT): such draws are counted and shown.
    b_k's gradient is 0 in exact arithmetic (softmax ignores a constant
    per row): it is held to 1e-6 of the largest gradient entry."""
    import copy
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.train import train as TT
    ref = M.TIPModel(dataclasses.replace(cfg.model, rnn_impl="plain",
                                         encoder_impl="plain"),
                     device="cpu", dtype=torch.float64)
    ref.load_state_dict({k: v.detach().double().cpu()
                         for k, v in state.model.state_dict().items()})
    ref.requires_grad_(True)
    card = copy.deepcopy(state.model)
    gen = torch.Generator().manual_seed(77)
    batches = step_batches(ds, F64_DRAWS, F64_BATCH, dev, 11)
    clean, rows = 0, []
    for i, batch in enumerate(batches):
        noise = (torch.rand(batch[1].shape, generator=gen,
                            dtype=torch.float64) - 0.5) * 0.3
        seeds = torch.randint(-2 ** 31, 2 ** 31, (1 + cfg.model.tf_layers,),
                              generator=gen).tolist()
        seeds = (seeds[0], seeds[1:])
        a_c, g_c, n_c = grads_of(card, batch, noise.float().to(dev), seeds,
                                 cfg)
        a_r, g_r, n_r = grads_of(ref, tuple(t.double().cpu() for t in batch),
                                 noise, seeds, cfg)
        scale = max(g.abs().max().item() for g in g_r.values())
        worst, worst_fro = 0.0, 0.0
        for k in g_r:
            a, b = g_c[k].double().cpu(), g_r[k]
            if k.endswith("b_k"):
                e = (a - b).abs().max().item() / scale
                if not e <= 1e-6:
                    raise AssertionError(f"path L vs f64: {k} {e:.3g}")
                continue
            worst = max(worst, rel_err(a, b))
            worst_fro = max(worst_fro, ((a - b).norm() / b.norm()).item())
        e_loss = abs(a_c["loss"] - a_r["loss"]) / abs(a_r["loss"])
        e_norm = abs(n_c - n_r) / n_r
        rows.append(dict(draw=i, loss=e_loss, grad_norm=e_norm,
                         grad_max=worst, grad_fro=worst_fro))
        if not (e_loss <= TOL_F64_LOSS and e_norm <= TOL_F64_LOSS
                and worst_fro <= TOL_F64_GRAD_FRO):
            raise AssertionError(f"path L vs f64, draw {i}: {rows[-1]}")
        clean += worst <= TOL_F64_GRAD
    log(f"  path L vs a float64 CPU step (B {F64_BATCH}): {rows}")
    if clean == 0:
        raise AssertionError("path L vs f64: no draw within "
                             f"{TOL_F64_GRAD:g} of the largest entries")
    return dict(draws=rows, clean=clean)


def check_trained_model_serves(model, dev):
    """Fault C1 repaired: path L's restored model, whose parameters require
    grad, runs the warm-up and one model frame of paths A and F outside
    torch.no_grad(), through K1 and four K11 (A: its config's encoder_impl
    "auto" takes K11 on the card) and K2, K3 (A, F), and gives the frames
    of the same weights with requires_grad(False). The runner steps its
    model under no_grad, so K12 is not launched there: one forward of a
    window with grad on, and its backward, go through K1, K10 and four K11
    and K12."""
    import copy
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import runner as R
    if not (torch.is_grad_enabled()
            and all(p.requires_grad for p in model.parameters())):
        raise AssertionError("C1: the restored model should require grad")
    frozen = copy.deepcopy(model).requires_grad_(False)
    imu, s_init = load_motion()
    skel = kin.amass_skeleton(device=dev)
    out = {}
    for name, cfg, on in (
            ("A", R.RunnerConfig(), {"fused_rnn": 1, "decode_fused": 1,
                                     "tail_fused": 1,
                                     "encoder_layer_fwd": 4}),
            ("F", R.RunnerConfig(serving_mode="kv_cache"),
             {"decode_fused": 1, "tail_fused": 1})):
        if model.cfg != cfg.model:
            raise AssertionError(f"C1: path {name}'s model config differs")
        frames = torch.as_tensor(imu[:cfg.imu_n_smooth + 1],
                                 dtype=torch.float32, device=dev)
        runs = []
        for m in (model, frozen):
            carry = R.runner_init(cfg, skel, s_init, device=dev)
            K.reset_launch_counts()
            rows = []
            for t in range(frames.shape[0]):
                carry, o = R.runner_step(m, carry, frames[t], cfg, skel)
                rows.append(torch.cat([o["qdq"], o["ct"],
                                       o["viz_locs"].reshape(-1)]))
            torch.cuda.synchronize()
            runs.append((torch.stack(rows), {k: v for k, v in
                                             K.launch_counts.items() if v}))
        (a, launches), (b, _) = runs
        if launches != on:
            raise AssertionError(f"C1 path {name}: launches {launches}, "
                                 f"expected {on}")
        if a.requires_grad or not torch.isfinite(a).all():
            raise AssertionError(f"C1 path {name}: the frames require grad "
                                 f"or are not finite")
        err = max_err(a, b)
        if not err <= TOL_PATH:
            raise AssertionError(f"C1 path {name}: {err:.3g} from the "
                                 f"detached model's frames")
        out[name] = dict(launches=launches, max_abs_err=err)
    cfg = model.cfg
    x_imu = torch.randn(2, 40, cfg.input_dim - cfg.size_s, device=dev)
    x_s = torch.randn(2, 40, cfg.size_s, device=dev)
    K.reset_launch_counts()
    model(x_imu, x_s).square().sum().backward()
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts.items() if v}
    want = {"fused_rnn": 1, "fused_rnn_bwd": 1, "encoder_layer_fwd": 4,
            "encoder_layer_bwd": 4}
    if launches != want or not all(
            p.grad is not None and torch.isfinite(p.grad).all()
            for p in model.parameters()):
        raise AssertionError(f"C1 with grad on: launches {launches}, "
                             f"expected {want}, or a gradient not finite")
    model.zero_grad(set_to_none=True)
    out["grad_on"] = dict(launches=launches)
    log(f"  C1: path L's restored model serves paths A (K1, K11 x4, K2, K3) "
        f"and F outside no_grad; with grad on a window's forward and "
        f"backward take K1, K10 and K11 x4, K12 x4: {out}")
    return out


def train_epoch_path(name, cfg, ds, dev, per_step):
    """One epoch of train_loop on ds under cfg with the launch counters set
    to 0 just before and read just after: per_step {kernel: launches a
    step}, every other kernel none; the loss finite and falling over the
    epoch; a checkpoint (under output/chip_smoke_ckpt_<name>/) restored
    bit-equal, with float32 parameters and moments and cfg's compute
    dtype, and stepping as the live state does. Returns (the state, the
    restored state, launches, a summary)."""
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.train import train as TT
    ckpt = ROOT / "output" / f"chip_smoke_ckpt_{name}"
    if ckpt.exists():
        for f in ckpt.iterdir():
            f.unlink()
    records = []
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state = TT.train_loop(cfg, ds, ckpt_dir=str(ckpt), log_fn=records.append,
                          max_epochs=1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    losses = [r["loss"] for r in records if "loss" in r]
    steps = len(losses)
    log(f"path {name}: one epoch, {steps} steps of {cfg.batch_size} in "
        f"{wall:.2f} s; launches {launches}")
    for k in KERNELS:
        if launches[k] != steps * per_step.get(k, 0):
            raise AssertionError(f"path {name}: {k} launched {launches[k]} "
                                 f"times, expected "
                                 f"{steps * per_step.get(k, 0)} ({steps} "
                                 f"steps)")
    if not 30 <= steps <= 60:
        raise AssertionError(f"path {name}: {steps} steps in the epoch")
    if any(r.get("event") for r in records) or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"path {name}: a non-finite loss: "
                             f"{records[:3]}")
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    log(f"  path {name} losses: first 10 {first:.4f}, last 10 {last:.4f}; "
        f"{losses}")
    if not last < first:
        raise AssertionError(f"path {name}: the loss did not fall over the "
                             f"epoch")
    # the checkpoint round trip: the restored state is the live one, and it
    # steps as the live one does
    back = TT.restore_checkpoint(str(ckpt), cfg, device=dev)
    if back.step != state.step:
        raise AssertionError(f"path {name} checkpoint: step differs")
    for k, p in state.model.state_dict().items():
        if not (torch.equal(back.model.state_dict()[k], p)
                and torch.equal(back.mu[k], state.mu[k])
                and torch.equal(back.nu[k], state.nu[k])
                and p.dtype == back.mu[k].dtype == back.nu[k].dtype
                == torch.float32):
            raise AssertionError(f"path {name} checkpoint: {k} differs or "
                                 f"is not float32")
    if back.model.cfg.compute_dtype != cfg.model.compute_dtype:
        raise AssertionError(f"path {name} checkpoint: compute dtype")
    batches = step_batches(ds, 4, cfg.batch_size, dev, 5)
    a = TT.train_step(state, batches[0], cfg)
    b = TT.train_step(back, batches[0], cfg)
    if a != b:
        raise AssertionError(f"path {name} checkpoint: the restored state "
                             f"steps otherwise: {a} vs {b}")
    log(f"  path {name} checkpoint: written and restored bit-equal, the "
        f"next step equal ({a['loss']:.6f})")
    return state, back, launches, dict(
        path=name, steps_in_epoch=steps, epoch_s=wall, loss_first10=first,
        loss_last10=last, batches=batches)


def timed_train_steps(name, state, cfg, batches):
    """time_train_steps, with the launches a step of those steps."""
    from tip_tpu_torch.ops import _kernels as K
    K.reset_launch_counts()
    summary = time_train_steps(state, cfg, batches)
    summary["launches_per_step"] = {
        k: v / (TRAIN_WARMUP + TRAIN_TIMED + TRAIN_PROFILED)
        for k, v in K.launch_counts.items() if v}
    summary["path"] = name
    return summary


def against_plain_on_card(name, plain_name, model_kw, ds, dev, tol):
    """LM_STEPS steps of the path (model_kw: its ModelConfig settings) and
    of the same training with the plain versions on the card, from the same
    initial state and batches: the loss within tol relative at every step,
    and no kernel launched by the plain one. Returns the largest relative
    difference."""
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.train import train as TT
    lm = {}
    lm_batches = step_batches(ds, LM_STEPS, 256, dev, 6)
    for run, kw in ((name, model_kw),
                    (plain_name, dict(model_kw, rnn_impl="plain",
                                      encoder_impl="plain"))):
        c = train_config(**kw)
        st = TT.init_state(c, dev)
        K.reset_launch_counts()
        lm[run] = [TT.train_step(st, bt, c)["loss"] for bt in lm_batches]
        lm[run + "_launches"] = dict(K.launch_counts)
        del st
    if lm[plain_name + "_launches"]:
        raise AssertionError(f"path {plain_name} launched kernels: "
                             f"{lm[plain_name + '_launches']}")
    errs = [abs(a - b) / abs(b) for a, b in zip(lm[name], lm[plain_name])]
    log(f"  path {name} vs path {plain_name} over {LM_STEPS} steps: loss "
        f"rel diff {max(errs):.3g}; {name} {lm[name]}; {plain_name} "
        f"{lm[plain_name]}")
    if not max(errs) <= tol:
        raise AssertionError(f"path {name} vs {plain_name}: {errs}")
    return max(errs)


def training_paths(dev):
    """Path L: one epoch of train_loop at the paper recipe, full width, on
    the packed in-tree motions, with the kernels K1, K10, K11, K12; a
    checkpoint written and restored; step timing and a profile; held
    against a float64 CPU step and, ten steps, against path M (the same
    training with the plain versions on the card). Then path L-bf16 (and
    M-bf16): the same in bf16 compute (training_paths_bf16)."""
    ds = pack_training_blobs()
    cfg = train_config()
    state, back, launches, summary = train_epoch_path(
        "L", cfg, ds, dev, {"fused_rnn": 1, "fused_rnn_bwd": 1,
                            "encoder_layer_fwd": 4, "encoder_layer_bwd": 4})
    batches = summary.pop("batches")
    c1 = check_trained_model_serves(back.model, dev)
    del back
    summary.update(timed_train_steps("L", state, cfg, batches), c1=c1)
    log(json.dumps({"train": summary}))
    summary["f64"] = check_l_against_f64(state, cfg, ds, dev)
    del state
    summary["vs_M_max_rel"] = against_plain_on_card("L", "M", {}, ds, dev,
                                                    TOL_LM_LOSS)
    t0 = time.perf_counter()
    launches_bf16, summary_bf16 = training_paths_bf16(dev, ds)
    log(f"  paths L-bf16 and M-bf16 in {time.perf_counter() - t0:.1f} s")
    return {"L": launches, "L-bf16": launches_bf16}, {
        "L": summary, "L-bf16": summary_bf16}


def check_l_bf16_against_cpu(state, cfg, ds, dev):
    """Path L-bf16's step (the bf16 kernels on the card) against the same
    bf16 step of the plain versions on the CPU, from the same float32
    parameters, batch, noise and seeds, in TRAIN_BF16_DRAWS draws: the loss
    within TOL_CPU_BF16_LOSS relative and every gradient within
    TOL_CPU_BF16_GRAD_FRO of its norm in every draw; every gradient within
    TOL_CPU_BF16_GRAD of its largest entry in at least one draw (a draw
    whose two runs fall on two sides of a ReLU kink moves a few entries by
    a whole term, K12_FF1_SHIFT). b_k's gradient is 0 in exact arithmetic:
    it is held within TOL_CPU_BF16_B_K of the largest gradient entry."""
    import copy
    from tip_tpu_torch.models import tip_model as M
    ref = M.TIPModel(dataclasses.replace(cfg.model, rnn_impl="plain",
                                         encoder_impl="plain"),
                     device="cpu")
    ref.load_state_dict({k: v.detach().cpu()
                         for k, v in state.model.state_dict().items()})
    ref.requires_grad_(True)
    card = copy.deepcopy(state.model)
    gen = torch.Generator().manual_seed(78)
    batches = step_batches(ds, TRAIN_BF16_DRAWS, F64_BATCH, dev, 12)
    clean, rows = 0, []
    for i, batch in enumerate(batches):
        noise = (torch.rand(batch[1].shape, generator=gen) - 0.5) * 0.3
        seeds = torch.randint(-2 ** 31, 2 ** 31, (1 + cfg.model.tf_layers,),
                              generator=gen).tolist()
        seeds = (seeds[0], seeds[1:])
        a_c, g_c, n_c = grads_of(card, batch, noise.to(dev), seeds, cfg)
        a_r, g_r, n_r = grads_of(ref, tuple(t.cpu() for t in batch), noise,
                                 seeds, cfg)
        top = max(g.abs().max().item() for g in g_r.values())
        worst, worst_fro, b_k = 0.0, 0.0, 0.0
        for k in g_r:
            a, b = g_c[k].double().cpu(), g_r[k].double()
            if g_c[k].dtype != torch.float32:
                raise AssertionError(f"path L-bf16: {k}'s gradient is "
                                     f"{g_c[k].dtype}")
            if k.endswith("b_k"):
                b_k = max(b_k, (a - b).abs().max().item() / top)
                continue
            worst = max(worst, rel_err(a, b))
            worst_fro = max(worst_fro, ((a - b).norm() / b.norm()).item())
        e_loss = abs(a_c["loss"] - a_r["loss"]) / abs(a_r["loss"])
        e_norm = abs(n_c - n_r) / n_r
        rows.append(dict(draw=i, loss=e_loss, grad_norm=e_norm,
                         grad_max=worst, grad_fro=worst_fro, b_k=b_k))
        if not (e_loss <= TOL_CPU_BF16_LOSS and b_k <= TOL_CPU_BF16_B_K
                and worst_fro <= TOL_CPU_BF16_GRAD_FRO):
            raise AssertionError(f"path L-bf16 vs the CPU, draw {i}: "
                                 f"{rows[-1]}")
        clean += worst <= TOL_CPU_BF16_GRAD
    log(f"  path L-bf16 vs the plain versions' bf16 step on the CPU (B "
        f"{F64_BATCH}): {rows}")
    if clean == 0:
        raise AssertionError(f"path L-bf16 vs the CPU: no draw within "
                             f"{TOL_CPU_BF16_GRAD:g} of the largest entries")
    return dict(draws=rows, clean=clean)


def check_bf16_model_serves_with_grad(model, dev):
    """Path L-bf16's restored model, whose parameters require grad, runs a
    window's forward with grad on through four K11 bf16 and K1 bf16, giving
    the bits of the same forward under torch.no_grad(), and its backward
    through four K12 bf16 and K10 bf16 (float32 gradients)."""
    from tip_tpu_torch.ops import _kernels as K
    cfg = model.cfg
    if not (cfg.compute_dtype == "bfloat16" and all(
            p.requires_grad for p in model.parameters())):
        raise AssertionError("the restored bf16 model should require grad")
    x_imu = torch.randn(2, 40, cfg.input_dim - cfg.size_s, device=dev)
    x_s = torch.randn(2, 40, cfg.size_s, device=dev)
    K.reset_launch_counts()
    out = model(x_imu, x_s)
    out.square().sum().backward()
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts.items() if v}
    with torch.no_grad():
        ref = model(x_imu, x_s)
    want = {"fused_rnn_bf16": 1, "fused_rnn_bwd_bf16": 1,
            "encoder_layer_fwd_bf16": 4, "encoder_layer_bwd_bf16": 4}
    if launches != want or not torch.equal(out.detach(), ref) or not all(
            p.grad is not None and p.grad.dtype == torch.float32
            and torch.isfinite(p.grad).all() for p in model.parameters()):
        raise AssertionError(f"bf16 with grad on: launches {launches}, "
                             f"expected {want}; or the forward differs from "
                             f"no_grad's, or a gradient is not a finite f32")
    model.zero_grad(set_to_none=True)
    log(f"  path L-bf16's restored model with grad on: the forward equals "
        f"no_grad's bit for bit, launches {launches}")
    return dict(launches=launches, equal_to_no_grad=True)


def training_paths_bf16(dev, ds):
    """Path L-bf16: path L's epoch with compute_dtype="bfloat16" (one
    launch of K1 bf16 and K10 bf16 and four of K11 bf16 and K12 bf16 a
    step, no f32 K1, K10, K11 or K12); its checkpoint; its restored model
    with grad on; step timing; held against the plain versions' bf16 step
    on the CPU and, ten steps, against path M-bf16 (the plain versions in
    bf16 on the card)."""
    cfg = train_config(compute_dtype="bfloat16")
    state, back, launches, summary = train_epoch_path(
        "L-bf16", cfg, ds, dev,
        {"fused_rnn_bf16": 1, "fused_rnn_bwd_bf16": 1,
         "encoder_layer_fwd_bf16": 4, "encoder_layer_bwd_bf16": 4})
    batches = summary.pop("batches")
    summary["grad_on"] = check_bf16_model_serves_with_grad(back.model, dev)
    del back
    summary.update(timed_train_steps("L-bf16", state, cfg, batches))
    log(json.dumps({"train": summary}))
    summary["cpu_bf16"] = check_l_bf16_against_cpu(state, cfg, ds, dev)
    del state
    summary["vs_M_bf16_max_rel"] = against_plain_on_card(
        "L-bf16", "M-bf16", dict(compute_dtype="bfloat16"), ds, dev,
        TOL_LM_LOSS)
    return launches, summary


def tail_inputs(B, dev, gen, skel):
    """Random inputs of K2, K3 and K6 for B streams (B 1: no stream axis),
    as check_decode_fused, check_tail_fused and check_fk_bullet_fused make
    them; the pool's filter flags differ by stream."""
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.ops import rotations as rot
    lead = () if B == 1 else (B,)
    coeff = torch.tensor([0.6 ** i for i in range(5, -1, -1)],
                         dtype=torch.float32, device=dev)
    local9 = rot.aa_to_matrix(torch.randn(lead + (3,), generator=gen,
                                          device=dev)).reshape(lead + (9,))
    s = torch.randn(lead + (114,), generator=gen, device=dev) * 0.4
    s[..., 2] += 0.9
    ct = torch.randn(lead + (5, 4), generator=gen, device=dev)
    ct[..., 0] = (ct[..., 0] > 0).float()
    ct[..., 1:] *= 0.05
    prev = kin.fk_our_state(
        skel, s + 0.01 * torch.randn(lead + (114,), generator=gen,
                                     device=dev)).contiguous()
    return dict(coeff=coeff, local9=local9.contiguous(),
                y_t=torch.randn(lead + (131,), generator=gen, device=dev),
                filt=torch.randn(lead + (6, 131), generator=gen, device=dev),
                flags=True if B == 1 else torch.arange(B, device=dev) % 3 != 0,
                s=s, ct=ct.reshape(lead + (20,)), prev=prev,
                pose=kin.our_pose_to_bullet(s).contiguous())


def tail_calls(x, skel):
    """{name: (kernel(clock=None, **input), plain(), clock phases, the name
    of the per-frame input a producer op writes)} over tail_inputs x."""
    from tip_tpu_torch.ops import fused_tail as FT
    from tip_tpu_torch.ops import kinematics as kin
    return {
        "decode_fused": (
            lambda clock=None, filt=x["filt"]: FT.decode_fused(
                x["y_t"], filt, x["coeff"], x["flags"], x["local9"],
                impl="fused", clock=clock),
            lambda filt=x["filt"]: FT.decode_fused_plain(
                x["y_t"], filt, x["coeff"], x["flags"], x["local9"]),
            FT.K2_PHASES, "filt"),
        "tail_fused": (
            lambda clock=None, s=x["s"]: FT.tail_fused(
                skel, s, x["ct"], x["prev"], impl="fused", clock=clock),
            lambda s=x["s"]: FT.tail_fused_plain(skel, s, x["ct"], x["prev"]),
            FT.K3_PHASES, "s"),
        "fk_bullet_fused": (
            lambda clock=None, pose=x["pose"]: kin.fk_bullet_fused(
                skel, pose, impl="kernel", clock=clock),
            lambda pose=x["pose"]: kin.fk_bullet_fused_plain(skel, pose),
            kin.K6_PHASES, "pose"),
    }


def flat(out):
    """A kernel's outputs as one vector, NaN (an inactive SBP's residue)
    as 0."""
    return torch.nan_to_num(torch.cat([t.reshape(-1) for t in out]))


def hold_on_skeleton(what, skel, dev, gen):
    """K3 and K6 on another skeleton of the pose layout, at B 1 and 64 on
    tail_inputs, each output against the plain version (check_tail_fused's
    tolerances). Returns {kernel: max err}."""
    tols = dict(pq_com=TOL, pq_jf=TOL, hist_sixd=TOL, c_locs=TOL,
                active=0.0, vel_res=TOL_RES, raw_res=TOL_RES)
    errs = {"tail_fused": {}, "fk_bullet_fused": {}}
    for B in (1, POOL_CAPACITY):
        x = tail_inputs(B, dev, gen, skel)
        calls = tail_calls(x, skel)
        for name, e in errs.items():
            kernel, plain, _, _ = calls[name]
            out, ref = kernel(), plain()
            fields = getattr(out, "_fields", ("pq_com", "pq_jf"))
            for f, a, b in zip(fields, out, ref):
                e[f] = (max(max_err(a, b), e.get(f, (0.0,))[0]), tols[f])
    res = {name: check(f"{name} {what}", e) for name, e in errs.items()}
    log(f"  {what}, B 1 and {POOL_CAPACITY}: max |kernel - plain| "
        f"{json.dumps(res)}")
    return res


def check_children_first(dev, gen):
    """K3 and K6 on a skeleton whose children are listed before their
    parents, with a fixed joint inside a chain: the AMASS tree with the
    left leg reversed (lankle off the root, lknee off it, lhip off lknee)
    and the left arm reversed through the fixed lwrist (lwrist off the
    chest, then lelbow, lshoulder, lclavicle); the pose layout is AMASS's.
    Returns {kernel: max err}."""
    from tip_tpu_torch.ops import kinematics as kin
    base = kin.amass_skeleton()
    p = base.parent
    parent = (1, 2, -1) + p[3:11] + (12, 13, 14, 8) + p[15:]
    assert any(q > j for j, q in enumerate(parent)) and base.is_fixed[14]
    skel = kin.make_skeleton(parent, base.is_fixed, base.joint_offset,
                             base.com_offset, base.link_mass, device=dev)
    return hold_on_skeleton("children-first skeleton with a fixed joint "
                            "inside a chain", skel, dev, gen)


# skeletons of the pose layout whose chains are deeper than a pass of the
# FK walk (kinematics.K_MAX_DEPTH): the right arm hung off the left wrist
# (11 joints deep), and every joint off the one before it (19)
DEEP_CHAINS = {"deep_11": 11, "line_19": 19}


def check_deep_chains(dev, gen):
    """K3 and K6 on the skeletons of DEEP_CHAINS (their second and third
    passes). Returns {kernel: max err over both}."""
    from tip_tpu_torch.ops import kinematics as kin
    base = kin.amass_skeleton()
    parents = {"deep_11": base.parent[:15] + (14,) + base.parent[16:],
               "line_19": (-1,) + tuple(range(18))}
    res = {}
    for name, depth in DEEP_CHAINS.items():
        skel = kin.make_skeleton(parents[name], base.is_fixed,
                                 base.joint_offset, base.com_offset,
                                 base.link_mass, device=dev)
        if max(len(c) for c in kin.fk_plan(skel.parent)) != depth:
            raise AssertionError(f"{name} is not {depth} joints deep")
        for k, e in hold_on_skeleton(f"{depth}-deep chain", skel, dev,
                                     gen).items():
            res[k] = max(res.get(k, 0.0), e)
    return res


# filter lengths past one chunk of K2's filter sum (16 rows)
LONG_FILTERS = (17, 20)


def check_long_filter(dev, gen, skel):
    """K2 at the filter lengths of LONG_FILTERS, at B 1 and 64, filtering
    and not, against decode_fused_plain. Returns the max err."""
    from tip_tpu_torch.ops import fused_tail as FT
    errs = {}
    for nf in LONG_FILTERS:
        coeff = torch.tensor([0.6 ** i for i in range(nf - 1, -1, -1)],
                             dtype=torch.float32, device=dev)
        for B in (1, POOL_CAPACITY):
            x = tail_inputs(B, dev, gen, skel)
            lead = () if B == 1 else (B,)
            filt = torch.randn(lead + (nf, 131), generator=gen, device=dev)
            for use_filter in (x["flags"], False):
                out = FT.decode_fused(x["y_t"], filt, coeff, use_filter,
                                      x["local9"], filter_len=nf,
                                      impl="fused")
                ref = FT.decode_fused_plain(x["y_t"], filt, coeff,
                                            use_filter, x["local9"])
                for f in out._fields:
                    key = f"nf{nf}_B{B}_{f}"
                    e = max_err(getattr(out, f), getattr(ref, f))
                    errs[key] = (max(e, errs.get(key, (0.0,))[0]), TOL)
    err = check("decode_fused long filter", errs)
    log(f"  decode_fused at filter_len {LONG_FILTERS}, B 1 and "
        f"{POOL_CAPACITY}: max |kernel - plain| {err:.3g}")
    return err


def phase_clock(kernel, phases, dev, cycles_per_ns, n=21, warm=5):
    """A tail kernel's time by phase (its per-phase clock, cycle stamps of
    block 0 converted with the SM's cycles per ns): the median ns of each
    phase over n clocked launches after `warm`; the clocked launch's outputs
    must equal an unclocked one's (TOL_SAME)."""
    from tip_tpu_torch.ops import fused_tail as FT
    rows = torch.zeros((n + warm, 1 + len(phases)), dtype=torch.int64,
                       device=dev)
    for i in range(n + warm):
        out = kernel(clock=rows[i])
    check("clocked launch", {"out": (max_err(flat(out), flat(kernel())),
                                     TOL_SAME)})
    splits = [FT.phase_ns(r, phases, cycles_per_ns)
              for r in rows.tolist()[warm:]]
    return {k: statistics.median(s[k] for s in splits) for k in splits[0]}


def tail_floor_and_clocks(dev, gen, skel):
    """The launch floor (an empty kernel of B blocks of 32 threads that
    writes a float a block, timed as the kernels are) at B 1 and the pool's
    64, %globaltimer's step and the SM's cycles per ns (the timer probe),
    and K2's, K3's and K6's device and eager ms at B 64 and per-phase
    clocks at B 1 and 64. Returns {kernel: fields for its kernels entry}."""
    from tip_tpu_torch.ops import fused_tail as FT
    FT.timer_probe(dev)
    probe = FT.timer_probe(dev)
    log(f"  timers: {json.dumps(probe)}")
    res = {}
    for B in (1, POOL_CAPACITY):
        out = torch.empty(B, device=dev)
        floor = dict(floor_ms=graph_ms(lambda: FT.floor_launch(out)),
                     floor_call_ms=time_ms(lambda: FT.floor_launch(out)),
                     floor_host_us=host_us(lambda: FT.floor_launch(out)))
        x = tail_inputs(B, dev, gen, skel)
        for name, (kernel, _, phases, _) in tail_calls(x, skel).items():
            r = res.setdefault(name, {}) if B == 1 else \
                res[name].setdefault("pool", {})
            r.update(floor)
            r["phases_ns"] = phase_clock(kernel, phases, dev,
                                         probe["cycles_per_ns"])
            r["call_host_us"] = host_us(kernel)
            if B > 1:
                r["call_ms"] = time_ms(kernel)
            split = {k: round(v, 1) for k, v in r["phases_ns"].items()}
            log(f"  {name} B {B}: floor {floor}, host us a call "
                f"{r['call_host_us']:.2f}, by phase (ns) {json.dumps(split)}")
    for r in res.values():
        r["timers"] = probe
    return res


def race_check(dev, gen, skel, pairs=20, replays=4):
    """K2 and K3 each right after the op that writes their per-frame input
    (a copy of a source scaled by 1), `pairs` such pairs in one CUDA graph.
    Before each replay the sources change; after it every pair's outputs
    are held against the plain version on that pair's input. A kernel that
    read its input, or wrote its outputs, before the op before it had
    finished would show the old values. Returns the largest error."""
    err = 0.0
    for name, arg, tol in (("decode_fused", "filt", TOL),
                           ("tail_fused", "s", TOL_RES)):
        xs = [tail_inputs(1, dev, gen, skel) for _ in range(pairs)]
        calls = [tail_calls(x, skel)[name] for x in xs]
        src = [x[arg].clone() for x in xs]
        captured = {}

        def run():
            for i, (kernel, _, _, _) in enumerate(calls):
                inp = src[i] * 1.0
                captured[i] = (inp, kernel(**{arg: inp}))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        for _ in range(replays):
            for s in src:
                s.copy_(torch.randn(s.shape, generator=gen, device=dev)
                        * (0.4 if arg == "s" else 1.0))
                if arg == "s":
                    s[2] += 0.9
            g.replay()
            torch.cuda.synchronize()
            for i, (_, plain, _, _) in enumerate(calls):
                inp, out = captured[i]
                err = max(err, check(f"{name} after a producer op", {
                    "out": (max_err(flat(out), flat(plain(**{arg: inp}))),
                            tol)}))
    log(f"  race check: {pairs} (producer -> K2) and (producer -> K3) pairs "
        f"in a graph, {replays} replays with new sources: max |kernel - "
        f"plain| {err:.3g}")
    return err


# ROADMAP C12: K1 and K10 at the RNN widths off the model's 512 that
# tip_tpu's kernels take, so that every instantiation of the walk and of
# K10's dW runs: 24 (the CPU tests' width: one block of the cluster), 384
# (two column tiles a block), rows not a multiple of 16 bytes (the walk
# reads a value at a time and K10 pads dW's operands: bf16 20 and 516, f32
# 42 on dW's narrow tile and 514 on its wide one) and 96 columns a block
# (f32 514 and 516, whose tile shrinks to 2 rows at B 64; bf16 516 and 768
# on the deeper instantiation, 768's tile shrinking too)
RNN_WIDTHS = {"float32": (20, 24, 42, 384, 514, 516),
              "bfloat16": (20, 24, 384, 516, 768)}
RNN_WIDTH_B = (1, 64)
# ROADMAP C13: the whole-model kernels past 64 window rows, 63 ring slots
# and heads 64 wide. LONG_T rows (slots) at full width, through a wrap of
# the ring; 2 heads of 128 (d 256); and WIDEST rows (slots), the least
# each kernel must take, at full width in f32
LONG_T = 80
WIDEST = 256
WRAP_SLOTS = (LONG_T - 2, LONG_T - 1, 0, 1)


def check_rnn_widths(dev, gen):
    """K1 and K10 (f32 and bf16) against their plain versions at
    RNN_WIDTHS and RNN_WIDTH_B (K10 on K1's own hidden states), each plan
    logged; timed at B 64. Returns {case: {max errs, plan, ms}}."""
    from tip_tpu_torch.ops import fused_rnn as FR
    T = 40
    errs, out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        bf = dtype == torch.bfloat16
        tol_f = TOL_RNN_BF16 if bf else TOL
        tol_b = TOL_RNN_BWD_BF16 if bf else TOL_TRAIN_K["fused_rnn_bwd"]
        size = 2 if bf else 4
        for H in RNN_WIDTHS[dn]:
            w = ((torch.rand(H, H, generator=gen, device=dev) * 2 - 1)
                 / math.sqrt(H)).to(dtype)
            for B in RNN_WIDTH_B:
                xin = (torch.randn(B, T, H, generator=gen, device=dev)
                       * 0.5).to(dtype)
                g = torch.randn(B, T, H, generator=gen, device=dev).to(dtype)
                hs = FR.fused_rnn(xin, w, impl="kernel")
                e_f = max_err(hs.float(), FR.fused_rnn_plain(xin, w).float())
                dx, dw = FR.fused_rnn_bwd(hs, w, g, impl="kernel")
                rx, rw = FR.fused_rnn_bwd_plain(hs, w, g)
                key = f"{dn}_H{H}_B{B}"
                errs[f"K1_{key}"] = (e_f, tol_f)
                errs[f"K10_dx_{key}"] = (rel_err(dx, rx), tol_b)
                errs[f"K10_dw_{key}"] = (rel_err(dw, rw), tol_b)
                case = dict(
                    K1_max_abs_err=e_f, K10_dx_rel_err=rel_err(dx, rx),
                    K10_dw_rel_err=rel_err(dw, rw),
                    K1_plan=dataclasses.asdict(FR.fused_rnn_plan(B, H,
                                                                 size)),
                    K10_plan=dataclasses.asdict(
                        FR.fused_rnn_bwd_plan(B, T, H, size).walk))
                if B == RNN_WIDTH_B[-1]:
                    t1 = timings(lambda: FR.fused_rnn(xin, w, impl="kernel"),
                                 lambda: FR.fused_rnn_plain(xin, w),
                                 light=True)
                    t10 = timings(
                        lambda: FR.fused_rnn_bwd(hs, w, g, impl="kernel"),
                        lambda: FR.fused_rnn_bwd_plain(hs, w, g), light=True)
                    peak = PEAK_BF16_FLOP_S if bf else PEAK_F32_FLOP_S
                    b1 = bound(*rnn_work(B, T, H, size), peak)
                    b10 = bound(*rnn_bwd_work(B, T, H, size), peak)
                    case.update(K1_ms=t1["ms"], K1_plain_ms=t1["plain_ms"],
                                K1_bound_ms=b1[0], K1_bound_by=b1[1],
                                K10_ms=t10["ms"],
                                K10_plain_ms=t10["plain_ms"],
                                K10_bound_ms=b10[0], K10_bound_by=b10[1])
                out[key] = case
                log(f"  rnn widths {key}: {json.dumps(case)}")
    check("rnn widths", errs)
    return out


# the kernels line's entry of each kernel that the width checks hold
KERNEL_OF = {"K1": "fused_rnn", "K4": "fused_forward_last",
             "K5": "fused_forward", "K7": "fused_cached_forward_step",
             "K8": "fused_cached_batch", "K9": "fused_recompute_batch",
             "K10": "fused_rnn_bwd"}


def widths_by_kernel(cases):
    """{case: {"K<n>_<field>": value}} -> {kernel name: {case: {field:
    value}}}, the case's own name dropped from the field; K1's and K10's
    bf16 cases under their bf16 entries."""
    out = {}
    for case, fields in cases.items():
        for key, value in fields.items():
            kn, field = key.split("_", 1)
            name = KERNEL_OF[kn]
            if kn in ("K1", "K10") and "bfloat16" in case:
                name += "_bf16"
            field = field.replace(case, "").strip("_") or "max_abs_err"
            out.setdefault(name, {}).setdefault(case, {})[field] = value
    return out


def long_model(dev, **kw):
    """ModelConfig()'s full width (d 256, ff 1024, 4 layers, RNN 512) with
    the given changes, K4/K5 on."""
    from tip_tpu_torch.models import tip_model as M
    return M.TIPModel(M.ModelConfig(forward_impl="fused", **kw), device=dev,
                      generator=torch.Generator().manual_seed(4))


def full_ring(SC, cfg, W, gen, dev, batch=None):
    """Rings of random rows, every slot valid but slot 3 (of each
    stream)."""
    c = SC.cache_init(cfg, W, device=dev, batch=batch)
    for n in ("k", "v", "enc", "h"):
        getattr(c, n).copy_(torch.randn(getattr(c, n).shape, generator=gen,
                                        device=dev) * 0.5)
    c.valid.fill_(True)
    c.valid[..., 3] = False
    return c


def hold_rings(key, ck, cp, name, errs):
    for n in ("k", "v", "enc", "h"):
        a, b = getattr(ck, n).float(), getattr(cp, n).float()
        if n != "h":
            m = cp.valid[..., None] if n == "enc" else \
                cp.valid[..., None, :, None]
            a, b = a * m, b * m
        tol = TOL_FF[name] if name == "float32" else \
            TOL_RING_BF16_REL * max(1.0, b.abs().max().item())
        errs[f"{key}_{n}"] = (max_err(a, b), tol)
    if not torch.equal(ck.valid, cp.valid):
        raise AssertionError(f"{key}: validity bits differ")


def check_whole_model_widths(dev, gen):
    """K4/K5 and K9 at T LONG_T (K9 at B 64), K7 and K8 (B 64) at W LONG_T
    through a wrap of full rings, replay and carry, and all five with 2
    heads of 128, both packings, against their plain versions; then each at
    T or W WIDEST in f32 (K8, K9 at B 8). Times at LONG_T (f32, replay),
    and each kernel's shared memory at WIDEST. Returns {case: ...}."""
    from tip_tpu_torch.ops import fused_forward as FF
    from tip_tpu_torch.runtime import streaming_cache as SC
    long, wide = long_model(dev), long_model(dev, n_heads=2)
    errs, out = {}, {}
    for tag, mdl, T in (("T80", long, LONG_T), ("heads128", wide, 12),
                        ("T256", long, WIDEST)):
        for dt in ((torch.float32,) if tag == "T256" else
                   (torch.float32, torch.bfloat16)):
            name = str(dt).split(".")[1]
            cfg = dataclasses.replace(mdl.cfg, compute_dtype=name)
            ws = mdl.packed_weights(dt)
            key = f"{tag}_{name}"
            tol = TOL_FF[name]
            # K4/K5
            x = torch.randn(T, cfg.input_dim, generator=gen, device=dev)
            x[::3, 100] = float("nan")
            x[:, 90 + 108:90 + 111] = 5.0
            y5 = FF.fused_forward(ws, x, cfg, impl="fused")
            errs[f"K5_{key}"] = (max_err(y5, FF.fused_forward_plain(
                ws, x, cfg)), tol)
            y4 = FF.fused_forward_last(ws, x, T - 1, cfg, impl="fused")
            errs[f"K4_{key}"] = (max_err(y4, FF.fused_forward_last_plain(
                ws, x, T - 1, cfg)), tol)
            # K9
            B9 = 8 if tag == "T256" else POOL_CAPACITY
            xb = torch.randn(B9, T, cfg.input_dim, generator=gen, device=dev)
            xb[:, :, 90 + 108:90 + 111] = 5.0
            ks = [(T - 1, T // 2, 3, 0)[b % 4] for b in range(B9)]
            y9 = FF.fused_recompute_batch(ws, xb, ks, cfg, impl="fused")
            errs[f"K9_{key}"] = (max_err(y9, FF.fused_recompute_batch_plain(
                ws, xb, ks, cfg)), tol)
            # K7 and K8 on rings of T slots, the cursor across the wrap
            slots = (T - 2, T - 1, 0, 1)
            for rnn_carry in (False, True):
                var = "carry" if rnn_carry else "replay"
                ck, cp = full_ring(SC, cfg, T, gen, dev), None
                cp = ck.clone()
                bk = full_ring(SC, cfg, T, gen, dev, batch=B9)
                bp = bk.clone()
                e7 = e8 = 0.0
                for i, slot in enumerate(slots):
                    xt = torch.randn(cfg.input_dim, generator=gen,
                                     device=dev)
                    _, y7 = SC.fused_cached_step_slot(
                        ws, ck, xt, slot, True, cfg, rnn_carry=rnn_carry,
                        impl="fused")
                    _, r7 = SC.fused_cached_forward_step_plain(
                        ws, cp, xt, slot, True, cfg, rnn_carry=rnn_carry)
                    e7 = max(e7, max_err(y7, r7))
                    xs = torch.randn(B9, cfg.input_dim, generator=gen,
                                     device=dev)
                    commit = torch.arange(B9, device=dev) % 3 != i % 3
                    _, y8 = SC.fused_cached_batch(ws, bk, xs, slot, commit,
                                                  cfg, rnn_carry=rnn_carry,
                                                  impl="fused")
                    _, r8 = SC.fused_cached_batch_plain(
                        ws, bp, xs, slot, commit, cfg, rnn_carry=rnn_carry)
                    e8 = max(e8, max_err(y8[commit], r8[commit]))
                errs[f"K7_{key}_{var}_y"] = (e7, tol)
                errs[f"K8_{key}_{var}_y"] = (e8, tol)
                hold_rings(f"K7_{key}_{var}", ck, cp, name, errs)
                hold_rings(f"K8_{key}_{var}", bk, bp, name, errs)
            case = {k: v[0] for k, v in errs.items() if key in k}
            if tag == "T80" and name == "float32":
                k_dev = torch.full((B9,), T - 1, dtype=torch.int32,
                                   device=dev)
                for kern, run, plain in (
                        ("K4", lambda: FF.fused_forward_last(
                            ws, x, T - 1, cfg, impl="fused"),
                         lambda: FF.fused_forward_last_plain(
                             ws, x, T - 1, cfg)),
                        ("K9", lambda: FF._launch_batch(ws, xb, k_dev, cfg),
                         lambda: FF._recompute_batch_rows(ws, xb, k_dev,
                                                          cfg)),
                        ("K7", lambda: SC.fused_cached_step_slot(
                            ws, ck, xt, 7, False, cfg, impl="fused"),
                         lambda: SC.fused_cached_forward_step_plain(
                             ws, cp, xt, 7, False, cfg)),
                        ("K8", lambda: SC.fused_cached_batch(
                            ws, bk, xs, 7, torch.zeros_like(commit), cfg,
                            impl="fused"),
                         lambda: SC.fused_cached_batch_plain(
                             ws, bp, xs, 7, torch.zeros_like(commit),
                             cfg))):
                    t = timings(run, plain, light=True)
                    case[f"{kern}_ms"] = t["ms"]
                    case[f"{kern}_plain_ms"] = t["plain_ms"]
                b4 = bound(*fused_forward_work(cfg, T, 1, 4))
                b9 = bound(*fused_recompute_batch_work(cfg, T, [T - 1] * B9,
                                                       4))
                b7 = bound(*fused_cached_work(cfg, T, 4, False,
                                              int(ck.valid.sum().item())))
                b8 = bound(*fused_cached_work(cfg, T, 4, False,
                                              int(bk.valid.sum().item()),
                                              B=B9))
                case.update(K4_bound_ms=b4[0], K4_bound_by=b4[1],
                            K9_bound_ms=b9[0], K9_bound_by=b9[1],
                            K7_bound_ms=b7[0], K7_bound_by=b7[1],
                            K8_bound_ms=b8[0], K8_bound_by=b8[1])
            out[key] = case
            log(f"  whole-model widths {key}: {json.dumps(case)}")
    check("whole-model widths", errs)
    return out


# the widened paths: the small model's default route (K1 at H 24, K11 at
# d 32) over PATH_FRAMES, and a window of LONG_T rows (recompute through K4,
# kv_cache through K7) over WIDE_FRAMES frames, each against its plain path
WIDE_FRAMES = 120
# path O: the evaluation harness on the card (ModelConfig() at full width,
# seeded random weights) over EVAL_MOTIONS in-tree motions at EVAL_LEN
# frames, the minimal and the full runner, against the same harness through
# the plain versions on the card: each metric within TOL_EVAL relative, each
# SBP channel's predicted flag within EVAL_FLAG_FRAMES frames of the plain
# run's (so each of its TP/FP/FN/TN counts too)
EVAL_MOTIONS = 2
EVAL_LEN = 300
TOL_EVAL = 1e-3
EVAL_FLAG_FRAMES = 2


def widened_paths(dev, state_dict):
    """Runner paths at the widths ROADMAP C12 and C13 opened, each against
    its plain path on the card (TOL_PATH): S, the small model (TINY
    widths: H 24, d 32) through the default route (K1 and 2 x K11 a frame,
    K2, K3); W80, RunnerConfig(window=LONG_T, with_acc_sum=False) with
    forward_impl="fused" in f32 (K4 over up to LONG_T rows, K2, K3); W80-kv
    the same window in kv_cache (K7 over LONG_T slots). Returns launches by
    path."""
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import runner as R

    imu, s_init = load_motion()
    skel = kin.amass_skeleton(device=dev)
    tiny = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
                rnn_hid_size=24)
    no_sum = dict(with_acc_sum=False)
    plain = dict(rnn_impl="plain", encoder_impl="plain")
    f32 = dict(forward_impl="fused", compute_dtype="float32")
    cfgs = {
        "S": R.RunnerConfig(model=M.ModelConfig(**tiny)),
        "S-plain": R.RunnerConfig(model=M.ModelConfig(**tiny, **plain),
                                  tail_impl="plain"),
        "W80": R.RunnerConfig(model=M.ModelConfig(**no_sum, **f32),
                              window=LONG_T, **no_sum),
        "W80-kv": R.RunnerConfig(model=M.ModelConfig(**no_sum, **f32),
                                 window=LONG_T, serving_mode="kv_cache",
                                 **no_sum),
        "W80-plain": R.RunnerConfig(model=M.ModelConfig(**no_sum, **plain),
                                    window=LONG_T, tail_impl="plain",
                                    **no_sum),
        "W80-kv-plain": R.RunnerConfig(
            model=M.ModelConfig(**no_sum, **plain), window=LONG_T,
            serving_mode="kv_cache", tail_impl="plain", **no_sum),
    }
    k7 = "fused_cached_forward_step"
    on_path = {"S": {"fused_rnn": 1, "encoder_layer_fwd": 2,
                     "decode_fused": 1, "tail_fused": 1},
               "W80": ("fused_forward_last", "decode_fused", "tail_fused"),
               "W80-kv": (k7, "decode_fused", "tail_fused")}
    models = {}
    for name, cfg in cfgs.items():
        seed = 5 if name.startswith("S") else 6
        models[name] = M.TIPModel(cfg.model, device=dev,
                                  generator=torch.Generator().manual_seed(
                                      seed))
    runs, launches = {}, {}
    frames = {"S": PATH_FRAMES, "W80": WIDE_FRAMES, "W80-kv": WIDE_FRAMES}
    for name, n in frames.items():
        runs[name], launches[name] = run_path(
            name, models[name], cfgs[name], skel, s_init, imu[:n + 1], dev,
            on_path[name])
        runs[f"{name}-plain"], _ = run_path(
            f"{name}-plain", models[f"{name}-plain"], cfgs[f"{name}-plain"],
            skel, s_init, imu[:n + 1], dev, ())
        compare_runs(f"path {name} vs its plain path (card)", runs[name],
                     runs[f"{name}-plain"], n, TOL_PATH)
    return launches


def eval_path(dev):
    """Path O: tip_tpu_torch.eval_harness.evaluate on the card, ModelConfig()
    at full width with seeded random weights, over EVAL_MOTIONS in-tree
    motions at test_len EVAL_LEN with extras_out, in the minimal runner
    (recompute, the default route: 4 x K11, K1, K2, K3) and the full runner
    with multi_sbp (path N's model: K1, K2, K3), each with its launch
    counters set to 0 before and read after; against the same harness
    through the plain versions on the card (TOL_EVAL a metric,
    EVAL_FLAG_FRAMES a channel's flags). Returns (launches by path,
    summary)."""
    from tip_tpu_torch import eval_harness as H
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.runtime import runner as R

    files = [str(CORPUS / f"freeform2_{i:04d}.pkl")
             for i in range(EVAL_MOTIONS)]
    plain = dict(rnn_impl="plain", encoder_impl="plain")
    runners = {
        "O": (R.RunnerConfig(model=M.ModelConfig()), False,
              {"encoder_layer_fwd": 4, "fused_rnn": 1, "decode_fused": 1,
               "tail_fused": 1}),
        "O-full": (R.RunnerConfig(model=M.ModelConfig(encoder_impl="plain")),
                   True, {"fused_rnn": 1, "decode_fused": 1,
                          "tail_fused": 1}),
    }
    plains = {
        "O": R.RunnerConfig(model=M.ModelConfig(**plain), tail_impl="plain"),
        "O-full": R.RunnerConfig(model=M.ModelConfig(**plain),
                                 tail_impl="plain"),
    }
    launches, summary = {}, {}
    for name, (rcfg, full, per_frame) in runners.items():
        res = {}
        for side, cfg in (("kernels", rcfg), ("plain", plains[name])):
            model = M.TIPModel(cfg.model, device=dev,
                               generator=torch.Generator().manual_seed(0))
            ecfg = H.EvalConfig(runner=cfg, use_full_runner=full,
                                multi_sbp=full, test_len=EVAL_LEN)
            flags, extras = [], {}

            def hook(f, gt, pred, info):
                lo, hi = ecfg.crop_head, len(gt) - ecfg.crop_tail
                flags.append(info["c_traj"][lo:hi, 0::4] > 0.5)
            K.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = H.evaluate(model, ecfg, files, log=lambda *_: None,
                             viz_hook=hook, extras_out=extras, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: K.launch_counts.get(k, 0) for k in KERNELS}
            res[side] = dict(out=out, flags=flags, extras=extras, wall=wall,
                             launches=counts)
        n_model = EVAL_MOTIONS * (EVAL_LEN - 1 - rcfg.imu_n_smooth)
        got = res["kernels"]["launches"]
        for k in KERNELS:
            if got[k] != n_model * per_frame.get(k, 0):
                raise AssertionError(f"path {name}: {k} launched {got[k]} "
                                     f"times, expected "
                                     f"{n_model * per_frame.get(k, 0)}")
        if any(res["plain"]["launches"].values()):
            raise AssertionError(f"path {name}'s plain run launched "
                                 f"{res['plain']['launches']}")
        (km, kmeans, _), (pm, pmeans, _) = (res["kernels"]["out"],
                                            res["plain"]["out"])
        if len(km) != EVAL_MOTIONS or len(pm) != EVAL_MOTIONS:
            raise AssertionError(f"path {name}: {len(km)} and {len(pm)} "
                                 f"motions evaluated")
        rel = {}
        for k in H.METRIC_NAMES:
            for a, b in zip(km, pm):
                if not math.isfinite(a[k]):
                    raise AssertionError(f"path {name}: {k} = {a[k]}")
                rel[k] = max(rel.get(k, 0.0),
                             abs(a[k] - b[k]) / max(abs(b[k]), 1e-12))
        flips = [int((a != b).sum(0).max()) for a, b in
                 zip(res["kernels"]["flags"], res["plain"]["flags"])]
        check(f"path {name} vs its plain run",
              {**{k: (v, TOL_EVAL) for k, v in rel.items()},
               "sbp_flag_frames": (max(flips), EVAL_FLAG_FRAMES)})
        wall = res["kernels"]["wall"]
        summary[name] = dict(
            means=kmeans, plain_means=pmeans, max_rel_diff=rel,
            sbp_flag_frames_off=flips, sbp=res["kernels"]["extras"]["sbp"],
            s_per_motion=wall / EVAL_MOTIONS,
            frames_per_s=EVAL_MOTIONS * EVAL_LEN / wall,
            plain_s_per_motion=res["plain"]["wall"] / EVAL_MOTIONS,
            launches={k: v for k, v in got.items() if v})
        if full:
            summary[name]["terrain"] = res["kernels"]["extras"]["terrain"]
        launches[name] = got
        log(json.dumps({"eval_path": {name: summary[name]}}))
    return launches, summary


# ---------------------------------------------------------------------------
# serving: the daemon (paths P, P-2), the live demo (Q), data generation (R)
# ---------------------------------------------------------------------------

# path P: cli/serve's --five_sbp --with_acc_sum --serving_mode
# kv_cache_rnn_carry --forward_impl fused --bf16 (path G's configuration)
# at capacity 64, one socket client a slot, each replaying an in-tree
# motion (the 60, then 0-3 again). (a) in lockstep: at SERVE_REJOIN[0] the
# client of slot SERVE_REJOIN[1] leaves and a new one takes the recycled
# slot with motion SERVE_REJOIN[2] from its first frame; (b) free-running
# under ServeDaemon.run at 60 Hz, the client SERVE_SLOW stopping to read
# halfway, its socket buffers capped so that its lines are dropped
SERVE_CLIENTS = 64
SERVE_LOCKSTEP = 120
SERVE_REJOIN = (60, 7, 10)
# the free run lasts SERVE_FREE_S, and longer (up to SERVE_FREE_MAX_S) until
# SERVE_FREE_TICKS ticks have served every client: the daemon's tick rate
# at 64 clients varies by a factor of ten between hosts (ROADMAP C15)
SERVE_FREE_S = 10.0
SERVE_FREE_TICKS = 60
SERVE_FREE_MAX_S = 120.0
# the slow client reads SERVE_SLOW_LINES lines, then stops; its socket
# buffers (both ends) and the daemon's per-client line buffer are cut
# small, so that its lines are dropped after ~20 ticks
SERVE_SLOW = 13
SERVE_SLOW_LINES = 2
SERVE_SOCKBUF = 4096
SERVE_OUTBUF = 8192
# path P-2: cli/serve's defaults (2 SBPs, no acc-sum, recompute, the plain
# forward, tail_impl auto) with 16 clients, against the plain route
P2_CLIENTS = 16
# path Q: cli/live_demo's loop over a 60 Hz replay of motion 0
LIVE_FRAMES = 200
# path R: amass_syn.synthesize of a procedural SMPL motion at 60 Hz
SYN_FRAMES = 600
TOL_SYN_IMU = 1e-9


def wire_helper():
    """tests/torch_wire.py: the wire protocol's peers (numpy, scipy and the
    standard library)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_wire
    return torch_wire


def corpus_wire_frames(W):
    """The 60 in-tree motions as wire frames, (720, 42) each."""
    out = []
    for i in range(60):
        with open(CORPUS / f"freeform2_{i:04d}.pkl", "rb") as f:
            d = pickle.load(f)    # in-tree motions written by data gen
        out.append(W.wire_frames(d["imu"]))
    return out


def random_checkpoint(name, n_sbps, with_acc_sum, dev):
    """A checkpoint directory of this package under output/ holding the
    seeded random weights of a full-width model (cli/train's format)."""
    import shutil
    from tip_tpu_torch import constants as cst
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.train import train as TT
    path = ROOT / "output" / f"chip_smoke_serve_{name}"
    shutil.rmtree(path, ignore_errors=True)
    cfg = M.ModelConfig(size_s=cst.state_dim(n_sbps),
                        with_acc_sum=with_acc_sum)
    TT.save_checkpoint(str(path), TT.init_state(
        TT.TrainConfig(model=cfg, n_sbps=n_sbps), dev), 0)
    return str(path)


def twin_pool(daemon, dev, model=None, cfg=None):
    """A StreamPool of the daemon pool's configuration (or of ``cfg`` with
    ``model``), stepped directly."""
    from tip_tpu_torch.runtime.serving import StreamPool
    pool = daemon.pool
    return StreamPool(model or pool.model, cfg or pool.cfg,
                      capacity=pool.capacity, device=dev, chunk=pool.chunk)


def lockstep_serve(name, W, daemon, ref, frames, n_clients, ticks,
                   rejoin=None):
    """Drive the daemon in lockstep with n_clients socket clients (client i
    replays frames[i]), and step the pool ``ref`` directly on the same
    parsed batches. Returns the streams: slot, join tick, the frames fed
    (parsed), the lines received and ref's qdq of the slot, per tick."""
    import numpy as np
    from tip_tpu_torch.runtime.imu_client import parse_wire_frame

    accept = W.start_accepting(daemon)
    clients, streams = [], []
    batch = np.tile(daemon._idle, (ref.capacity, 1))
    try:
        for i in range(n_clients):
            clients.append(W.LineClient(daemon.port))
            slot = ref.add_stream(daemon.s_init)
            if not clients[-1].slot == slot == i:
                raise AssertionError(f"path {name}: client {i} got slot "
                                     f"{clients[-1].slot}, the twin pool "
                                     f"{slot}")
            streams.append(dict(slot=i, motion=i, join=0, fed=[], lines=[],
                                ref=[]))
        live = list(streams)
        for t in range(ticks):
            if rejoin is not None and t == rejoin[0]:
                slot = rejoin[1]
                clients[slot].close()
                W.wait_dropped(daemon, daemon.pool, slot)
                ref.remove_stream(slot)
                batch[slot] = daemon._idle
                clients[slot] = W.LineClient(daemon.port)
                if not clients[slot].slot == ref.add_stream(daemon.s_init) \
                        == slot:
                    raise AssertionError(f"path {name}: the rejoining "
                                         f"client did not get slot {slot}")
                live[slot] = dict(slot=slot, motion=rejoin[2], join=t,
                                  fed=[], lines=[], ref=[])
                streams.append(live[slot])
            sends = []
            for st in live:
                frame = frames[st["motion"]][t - st["join"]]
                parsed = parse_wire_frame(
                    np.array(W.wire_text(frame).split(), dtype=float))
                batch[st["slot"]] = parsed
                st["fed"].append(parsed)
                sends.append((clients[st["slot"]], frame))
            lines = W.lockstep_tick(daemon, parse_wire_frame, sends)
            qdq = ref.step(batch)["qdq"].cpu().numpy()
            for st, line in zip(live, lines):
                if line["t"] != t:
                    raise AssertionError(f"path {name}: slot {st['slot']} "
                                         f"got tick {line['t']} at {t}")
                st["lines"].append(line["qdq"])
                st["ref"].append(qdq[st["slot"]])
    finally:
        for c in clients:
            c.close()
        W.stop_accepting(daemon, accept)
    return streams


def serve_lockstep_p(W, dev, ckpt, frames):
    """Path P (a): the daemon's lines equal a twin pool's poses rounded and
    written as the daemon writes them; the schedule's streams against the
    single-stream runner (single_stream_f32)."""
    import numpy as np
    from tip_tpu_torch.cli import serve as TSV
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import kinematics as kin

    daemon = TSV.build_daemon(TSV.parse_args(P_ARGS + [
        "--ckpt", ckpt, "--port", "0"]), log=lambda *_: None)
    ref = twin_pool(daemon, dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    streams = lockstep_serve("P", W, daemon, ref, frames, SERVE_CLIENTS,
                             SERVE_LOCKSTEP, rejoin=SERVE_REJOIN)
    wall = time.perf_counter() - t0
    counts = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    want = {"fused_cached_batch": 2 * SERVE_LOCKSTEP,
            "decode_fused": 2 * SERVE_LOCKSTEP,
            "tail_fused": 2 * SERVE_LOCKSTEP}
    if counts != {k: want.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"path P lockstep (daemon and twin pool): "
                             f"launches {counts}, expected {want}")
    n_lines = 0
    for st in streams:
        got = np.array(st["lines"])
        # rounded to 5 places in the poses' float32 (tip_tpu's rounding),
        # then written with 5 decimals (encode_lines): each value reads
        # back as the double nearest to its 5-place decimal
        want_lines = np.round(np.round(np.array(st["ref"]), 5)
                              .astype(np.float64), 5)
        n_lines += len(got)
        if not np.isfinite(got).all() or not np.array_equal(got,
                                                           want_lines):
            raise AssertionError(
                f"path P: slot {st['slot']} (joined at tick {st['join']}): "
                f"the daemon's lines differ from the twin pool's poses by "
                f"{np.abs(got - want_lines).max():.3g}")
    log(f"  path P lockstep: {len(streams)} streams, {n_lines} lines over "
        f"{SERVE_LOCKSTEP} ticks, each equal to the twin pool's poses "
        f"rounded to 5 places ({wall:.1f} s)")
    f32 = single_stream_f32(streams, daemon.pool.model,
                            kin.amass_skeleton(device=dev), daemon.s_init,
                            dev)
    log(f"  path P's schedule in f32 vs the single-stream runner: max "
        f"|diff| {f32:.3g} over {len(streams)} streams")
    return dict(lines=n_lines, wall_s=wall, single_f32_max_abs_diff=f32)


def single_stream_diff(model, cfg, skel, s_init, st, dev, pooled):
    """Max |pooled - the single-stream runner's qdq| of one stream over its
    fed frames from its join tick."""
    import numpy as np
    from tip_tpu_torch.runtime import runner as R
    fed = np.array(st["fed"] + st["fed"][-1:])
    single = R.run_offline(model, cfg, skel, s_init, fed,
                           device=dev)[0][1:].double().cpu()
    a = torch.as_tensor(np.array(pooled), dtype=torch.float64)
    return (a - single).abs().max().item()


def single_stream_f32(streams, model, skel, s_init, dev):
    """Path P's schedule (every stream's fed frames from its join tick, the
    rejoin on a recycled slot) through a pool of P's serving mode in f32,
    each stream held against the single-stream runner within TOL_PATH, as
    H against D. In bf16 the pooled and the single-stream products round
    apart (one bf16 step, 2^-8 relative), and with random weights the
    decode's Shepperd near-ties (ROADMAP C4) turn that into a joint's
    flip (P's bf16 streams read up to 5.5 off the single-stream runner on
    an H100), so P's own configuration is held against its twin pool,
    not against the single-stream runner."""
    import numpy as np
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.runtime import runner as R
    from tip_tpu_torch.runtime.serving import StreamPool

    cfg = R.RunnerConfig(model=M.ModelConfig(forward_impl="fused",
                                             compute_dtype="float32"),
                         serving_mode="kv_cache_rnn_carry")
    f32 = M.TIPModel(cfg.model, device=dev)
    f32.load_state_dict(model.state_dict())
    pool = StreamPool(f32, cfg, capacity=POOL_CAPACITY, device=dev)
    idle = np.zeros(72, np.float32)
    idle[[0, 4, 8]] = 1.0
    batch = np.tile(idle, (POOL_CAPACITY, 1))
    ticks = max(st["join"] + len(st["fed"]) for st in streams)
    outs = {id(st): [] for st in streams}
    for t in range(ticks):
        for st in streams:
            if st["join"] == t:
                if t > 0:
                    pool.remove_stream(st["slot"])
                if pool.add_stream(s_init) != st["slot"]:
                    raise AssertionError("path P (f32): slot mismatch")
        live = [st for st in streams
                if st["join"] <= t < st["join"] + len(st["fed"])]
        for st in live:
            batch[st["slot"]] = st["fed"][t - st["join"]]
        qdq = pool.step(batch)["qdq"].cpu().numpy()
        for st in live:
            outs[id(st)].append(qdq[st["slot"]])
    worst = max(single_stream_diff(f32, cfg, skel, s_init, st, dev,
                                   outs[id(st)]) for st in streams)
    check(f"path P's schedule in f32 ({len(streams)} streams) vs the "
          f"single-stream runner", {"qdq": (worst, TOL_PATH)})
    return worst


P_ARGS = ["--five_sbp", "--with_acc_sum", "--serving_mode",
          "kv_cache_rnn_carry", "--forward_impl", "fused", "--bf16"]


def serve_load_script():
    """scripts/torch_serve_load.py as a module: the free run's harness."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_serve_load", ROOT / "scripts" / "torch_serve_load.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serve_free_p(W, dev, ckpt, frames, card):
    """Path P (b): ServeDaemon.run at 60 Hz with 64 clients pushing at 60
    Hz from another process, for SERVE_FREE_S or until SERVE_FREE_TICKS
    ticks have served every client; the client SERVE_SLOW stops reading
    early (scripts/torch_serve_load.py's free_run: each part of the tick
    timed from outside the daemon, the pool step synchronised). Before it,
    the bare pool step over 64 streams. The times are printed, not held
    to a limit: hosts differ 2-3x between calls."""
    from tip_tpu_torch.cli import serve as TSV
    from tip_tpu_torch.ops import _kernels as K

    harness = serve_load_script()
    logged = []
    daemon = TSV.build_daemon(TSV.parse_args(P_ARGS + [
        "--ckpt", ckpt, "--port", "0"]), log=logged.append)
    sync = torch.cuda.synchronize
    bare, bare_add = harness.bare_step_ms(daemon.pool, W, frames, sync)
    K.reset_launch_counts()
    summary, served, slot_of, n_lines, bad = harness.free_run(
        daemon, W, frames, SERVE_FREE_S, sync, min_ticks=SERVE_FREE_TICKS,
        max_seconds=SERVE_FREE_MAX_S, slow=SERVE_SLOW,
        slow_sockbuf=SERVE_SOCKBUF, slow_lines=SERVE_SLOW_LINES,
        outbuf=SERVE_OUTBUF)
    if len(served) != SERVE_CLIENTS:
        raise AssertionError(f"path P free run: {len(served)} clients "
                             f"registered, expected {SERVE_CLIENTS}")
    counts = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    ticks = daemon.ticks
    want = {"fused_cached_batch": ticks, "decode_fused": ticks,
            "tail_fused": ticks}
    if counts != {k: want.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"path P free run: launches {counts}, "
                             f"expected one of K8, K2, K3 a tick ({ticks})")
    failed = [m for m in logged if "failed" in m]
    dropped = {c.slot: c.dropped for c in served.values()}
    slow_slot = slot_of[SERVE_SLOW]
    summary.update(
        bare_step_ms_p50=bare, bare_add_stream_ms_p50=bare_add,
        step_over_bare=summary["pool_step_ms_p50"] / bare,
        slow_slot=slow_slot, failed_ticks=len(failed),
        launches={k: v for k, v in counts.items() if v}, card=card)
    log(json.dumps({"serve_free_run": summary}))
    if failed or bad:
        raise AssertionError(f"path P free run: {len(failed)} failed ticks "
                             f"({failed[:2]}), non-finite lines {bad[:4]}")
    if any(v for k, v in dropped.items() if k != slow_slot) or \
            not dropped.get(slow_slot):
        raise AssertionError(f"path P free run: lines dropped {dropped}; "
                             f"expected drops for slot {slow_slot} only")
    if not min(n for i, n in enumerate(n_lines) if i != SERVE_SLOW):
        raise AssertionError(f"path P free run: a client got no line "
                             f"({n_lines})")
    return summary, counts


def serve_defaults_p2(W, dev, ckpt, frames):
    """Path P-2: cli/serve at its defaults (2 SBPs: ROADMAP C14's route,
    the plain versions of K2 and K3 under tail_impl "auto") in lockstep
    with P2_CLIENTS clients, against a twin pool of the plain route on the
    card; then cli/evaluate without --five_sbp over one motion."""
    import numpy as np
    from tip_tpu_torch import constants as cst
    from tip_tpu_torch.cli import evaluate as TCE
    from tip_tpu_torch.cli import serve as TSV
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.runtime import runner as R

    daemon = TSV.build_daemon(TSV.parse_args(["--ckpt", ckpt, "--port",
                                              "0"]), log=lambda *_: None)
    cfg = daemon.pool.cfg
    if cfg.n_sbps != 2 or cfg.resolved_tail_impl("cuda") != "plain":
        raise AssertionError(f"path P-2: n_sbps {cfg.n_sbps}, tail route "
                             f"{cfg.resolved_tail_impl('cuda')}")
    plain_cfg = R.RunnerConfig(
        model=M.ModelConfig(size_s=cst.state_dim(2), with_acc_sum=False,
                            rnn_impl="plain", encoder_impl="plain"),
        n_sbps=2, with_acc_sum=False, tail_impl="plain")
    plain = M.TIPModel(plain_cfg.model, device=dev)
    plain.load_state_dict(daemon.pool.model.state_dict())
    ref = twin_pool(daemon, dev, plain, plain_cfg)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    streams = lockstep_serve("P-2", W, daemon, ref, frames, P2_CLIENTS,
                             SERVE_LOCKSTEP)
    wall = time.perf_counter() - t0
    counts = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    want = {"encoder_layer_fwd": 4 * SERVE_LOCKSTEP,
            "fused_rnn": SERVE_LOCKSTEP}
    if counts != {k: want.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"path P-2: launches {counts}, expected "
                             f"{want} (the plain decode and tail)")
    got = np.array([st["lines"] for st in streams])
    ref_q = np.array([st["ref"] for st in streams])
    if not np.isfinite(got).all():
        raise AssertionError("path P-2: a line is not finite")
    # the lines are rounded to 5 places
    err = np.abs(got - ref_q).max()
    check("path P-2 (cli/serve defaults) vs the plain route on the card",
          {"qdq": (err, TOL_PATH + 5e-6)})
    log(f"  path P-2: {P2_CLIENTS} clients x {SERVE_LOCKSTEP} ticks, max "
        f"|line - plain| {err:.3g} ({wall:.1f} s)")

    # cli/evaluate without --five_sbp (2 SBPs) over one in-tree motion
    root = ROOT / "output" / "chip_smoke_serve_eval" / "syn_AMASS_CMU_v0"
    root.mkdir(parents=True, exist_ok=True)
    (root / MOTION.name).write_bytes(MOTION.read_bytes())
    K.reset_launch_counts()
    _, means, _ = TCE.main(["--ckpt", ckpt, "--data_root", str(root.parent),
                            "--name_contains", "freeform2", "--test_len",
                            "300"])
    ev = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    if not (ev["fused_rnn"] > 0 and ev["encoder_layer_fwd"] > 0
            and ev["tail_fused"] == ev["decode_fused"] == 0) or \
            not all(math.isfinite(v) for v in means.values()):
        raise AssertionError(f"path P-2 cli/evaluate: launches {ev}, "
                             f"means {means}")
    return counts, dict(lines=int(got.size // 114), max_abs_diff=float(err),
                        wall_s=wall, evaluate_means=means,
                        evaluate_launches={k: v for k, v in ev.items() if v})


def all_latencies():
    """A LatencyHistogram that also keeps every record in ``all``."""
    from tip_tpu_torch.utils.observability import LatencyHistogram

    class AllLatencies(LatencyHistogram):
        def __init__(self):
            super().__init__()
            self.all = []

        def record(self, seconds):
            super().record(seconds)
            self.all.append(seconds)
    return AllLatencies()


def live_demo_q(W, dev, ckpt, frames, card):
    """Path Q: cli/live_demo's loop (run_loop) through IMUClient, fed by a
    60 Hz replay server of motion 0, in the CLI's --five_sbp --with_acc_sum
    --multi_sbp_correction configuration (bench.py's full runner; the
    encoder through K11), LIVE_FRAMES frames with --out, --record and
    --metrics; the recorded frames through run_offline_full give --out's
    poses, and through the plain versions on the card, frame by frame
    from the kernels' own carry, agree within TOL_PATH."""
    import numpy as np
    from tip_tpu_torch.cli import live_demo as TLD
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.runtime import calibration as cal
    from tip_tpu_torch.runtime import full_runner as FR
    from tip_tpu_torch.runtime import runner as R
    from tip_tpu_torch.runtime.imu_client import IMUClient

    out_dir = ROOT / "output" / "chip_smoke_live"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {k: str(out_dir / n) for k, n in (
        ("out", "poses.jsonl"), ("record", "frames.f32"),
        ("metrics", "metrics.jsonl"))}
    args = TLD.parse_args(["--ckpt", ckpt, "--five_sbp", "--with_acc_sum",
                           "--multi_sbp_correction", "--skip_calibration"])
    model, cfg, skel, _ = TLD.build_runner(args)
    server = W.ReplayServer(frames[0], hz=60.0)
    client = IMUClient(port=server.port)
    hist = all_latencies()
    try:
        client.start()
        W.wait_until(lambda: client.current_reading() is not None,
                     "the first frame", 30.0)
        K.reset_launch_counts()
        n, summ = TLD.run_loop(model, cfg, skel, client, None, dev,
                               max_frames=LIVE_FRAMES, out_path=paths["out"],
                               record_path=paths["record"],
                               metrics_path=paths["metrics"], hist=hist,
                               log=log)
        counts = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    finally:
        client.stop()
        server.stop()
    # run_loop's warm-up makes one model frame, the loop one a frame past
    # the smoothing warm-up
    model_frames = 1 + LIVE_FRAMES - cfg.base.imu_n_smooth
    want = {"encoder_layer_fwd": 4 * model_frames, "fused_rnn": model_frames,
            "decode_fused": model_frames, "tail_fused": model_frames}
    if n != LIVE_FRAMES or counts != {k: want.get(k, 0) for k in KERNELS}:
        raise AssertionError(f"path Q: {n} frames, launches {counts}, "
                             f"expected {want}")
    poses = np.array([json.loads(ln)["qdq"] for ln in
                      Path(paths["out"]).read_text().splitlines()])
    fed = np.fromfile(paths["record"], np.float32).reshape(-1, 72)
    metrics = [json.loads(ln) for ln in
               Path(paths["metrics"]).read_text().splitlines()]
    if not (len(poses) == len(fed) == LIVE_FRAMES and np.isfinite(poses).all()
            and metrics[-1]["kind"] == "final"
            and metrics[-1]["frames"] == LIVE_FRAMES):
        raise AssertionError(f"path Q: {len(poses)} poses, {len(fed)} "
                             f"frames recorded, metrics {metrics[-1]}")
    frames_in = np.concatenate([fed, fed[-1:]])
    s_init = cal.t_pose_init_state()
    again = FR.run_offline_full(model, cfg, skel, s_init, frames_in,
                                device=dev)[0][1:].double().cpu().numpy()
    plain_model = M.TIPModel(dataclasses.replace(
        cfg.base.model, rnn_impl="plain", encoder_impl="plain"), device=dev)
    plain_model.load_state_dict(model.state_dict())
    plain_cfg = dataclasses.replace(cfg, base=dataclasses.replace(
        cfg.base, model=plain_model.cfg, tail_impl="plain"))
    errs = {"rerun of --record": (np.abs(poses - again).max(), TOL_SAME),
            "plain versions, teacher-forced": (teacher_forced_full(
                model, cfg, plain_model, plain_cfg, skel, s_init, fed, dev),
                TOL_PATH)}
    check("path Q (cli/live_demo) --out against", errs)
    lat = sorted(1e3 * x for x in hist.all)
    summary = dict(frames=n, p50_ms=summ["p50_ms"], p99_ms=summ["p99_ms"],
                   max_ms=summ["max_ms"],
                   over_16_7_ms=sum(x > 1e3 / 60 for x in lat),
                   rerun_max_abs_diff=float(errs["rerun of --record"][0]),
                   plain_teacher_forced_max_abs_diff=float(
                       errs["plain versions, teacher-forced"][0]),
                   launches={k: v for k, v in counts.items() if v},
                   card=card)
    log(json.dumps({"live_demo": summary}))
    return counts, summary


def teacher_forced_full(model, cfg, plain, plain_cfg, skel, s_init, frames,
                        dev):
    """Max |qdq| between the full runner's step through the kernels and
    through the plain versions, each frame from the kernels' run's own
    carry (a step leaves the carry it is given as it was). Free-running,
    a random model's decode meets Shepperd near-ties (ROADMAP C4) where a
    1e-6 difference turns a joint; the live feed, sampled latest-wins, is
    another sequence in every run (measured on one H100: 3.6 free-running
    at one such tie)."""
    from tip_tpu_torch.runtime import full_runner as FR
    from tip_tpu_torch.runtime import runner as R
    packed = R.pack_fused_weights(model, cfg.base, torch.float32)
    carry = FR.full_runner_init(cfg, skel, s_init, device=dev)
    worst = 0.0
    for x in torch.as_tensor(frames, dtype=torch.float32, device=dev):
        nxt, out = FR.full_runner_step(model, carry, x, cfg, skel,
                                       packed_ws=packed)
        _, ref = FR.full_runner_step(plain, carry, x, plain_cfg, skel)
        worst = max(worst, (out["qdq"] - ref["qdq"]).abs().max().item())
        carry = nxt
    return worst


def procedural_motion(T, fps, seed=17):
    """A procedural SMPL motion (scripts/e2e_synthetic_demo.py's): a
    randomised swing of 14 joints and a drifting, bobbing root."""
    import numpy as np
    from tip_tpu_torch.data_gen import smpl
    rng = np.random.default_rng(seed)
    t = np.arange(T) / fps
    poses = np.zeros((T, 24, 3))
    poses[:, 0] = [1.20919958, 1.20919958, 1.20919958]
    for j in (1, 2, 4, 5, 7, 8, 3, 6, 12, 15, 16, 17, 18, 19):
        amp, f = rng.uniform(0.05, 0.45), rng.uniform(0.3, 1.2)
        ph = rng.uniform(0, 2 * np.pi)
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        poses[:, j] = np.outer(amp * np.sin(2 * np.pi * f * t + ph), ax)
    trans = np.zeros((T, 3))
    trans[:, 2] = 0.95 + 0.03 * np.sin(2 * np.pi * 0.9 * t)
    trans[:, 0] = rng.uniform(-0.5, 0.5) * t
    trans[:, 1] = rng.uniform(-0.3, 0.3) * t
    return smpl.SmplMotion(poses=poses, trans=trans, fps=fps)


def datagen_r(dev, card):
    """Path R: amass_syn.synthesize of a SYN_FRAMES-frame procedural motion
    at 60 Hz in float64 on the card equals the same on the CPU (imu
    TOL_SYN_IMU, the SBP flags equal); its stages timed on the card."""
    import numpy as np
    from tip_tpu_torch.data_gen import amass_syn as S
    from tip_tpu_torch.data_gen import smpl

    motion = procedural_motion(SYN_FRAMES, 60.0)
    S.synthesize(procedural_motion(120, 60.0, seed=3), height=1.7,
                 device=dev)                      # first use on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_out = S.synthesize(motion, height=1.7, device=dev)
    card_s = time.perf_counter() - t0
    cpu_out = S.synthesize(motion, height=1.7, device="cpu")
    T = len(card_out["imu"])
    errs = {"imu": (np.abs(card_out["imu"] - cpu_out["imu"]).max(),
                    TOL_SYN_IMU),
            "nimble_qdq": (np.abs(card_out["nimble_qdq"]
                                  - cpu_out["nimble_qdq"]).max(), TOL_SYN_IMU),
            "sbp_flags_off": (int((card_out["constrs"][:, 0::4]
                                   != cpu_out["constrs"][:, 0::4]).sum()), 0),
            "constrs": (np.abs(card_out["constrs"]
                               - cpu_out["constrs"]).max(), TOL_SYN_IMU)}
    check(f"path R (synthesize, {T} frames) card vs CPU", errs)
    # the stages one by one, each ended by a synchronise
    split = {}

    def timed(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        split[name] = (time.perf_counter() - t0) * 1e3 / T
        return out
    aa60, trans60, _ = timed("resample", smpl.resample_motion, motion)
    fk = timed("fk", S.fk_motion, aa60, trans60, 1.7, device=dev)
    timed("imu", S.imu_from_fk, fk["pq_imu"])
    timed("labels", S.sbp_labels, fk["pq_sbp"])
    timed("qdq", S.nimble_qdq, aa60, trans60, device=dev)
    summary = dict(frames=T, s_per_1000_frames=card_s * 1e3 / T,
                   s_per_1000_frames_by_stage=split,
                   sbp_active_share=float(card_out["constrs"][:, 0::4]
                                          .mean()), card=card)
    log(json.dumps({"datagen": summary}))
    return summary


def serving_paths(dev, card):
    """Paths P, P-2, Q and R. Returns (launches by path, summary)."""
    W = wire_helper()
    frames = corpus_wire_frames(W)
    clients = [frames[i % 60] for i in range(SERVE_CLIENTS)]
    ck5 = random_checkpoint("5sbp", 5, True, dev)
    ck2 = random_checkpoint("2sbp", 2, False, dev)
    launches, summary = {}, {}
    t0 = time.perf_counter()
    summary["P"] = serve_lockstep_p(W, dev, ck5, clients)
    summary["P"]["free_run"], launches["P"] = serve_free_p(
        W, dev, ck5, clients, card)
    launches["P-2"], summary["P-2"] = serve_defaults_p2(W, dev, ck2, frames)
    launches["Q"], summary["Q"] = live_demo_q(W, dev, ck5, frames, card)
    summary["R"] = datagen_r(dev, card)
    log(f"  serving paths P, P-2, Q, R: {time.perf_counter() - t0:.1f} s")
    return launches, summary


# ---------------------------------------------------------------------------
# 6b. the convergence recipe: paths T, U, V
# ---------------------------------------------------------------------------

# path T: the recipe's corpus phase (4 training motions, seed 100; 1
# held-out motion, seed 900, 12.5 s) on the card and on the CPU, f64
RECIPE_TRAIN, RECIPE_TEST = 4, 1
# path U: the recipe's two epochs; its eval over the held-out motion's
# first RECIPE_EVAL_LEN frames in the script's four serving modes
RECIPE_EPOCHS = 2
RECIPE_EVAL_LEN = 300
# path V: the epoch function in the kernel configuration over V_BATCHES
# batches of given ends of the packed in-tree motions
V_BATCHES = 8


def recipe_script():
    """scripts/torch_train_convergence.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_train_convergence",
        ROOT / "scripts" / "torch_train_convergence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fresh_dir(name):
    import shutil
    d = ROOT / "output" / name
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    return d


def corpus_t(dev, TTC):
    """Path T: the recipe's corpus phase in float64 on the card, then the
    same on the CPU: the same file names, the payloads within path R's
    tolerance and the SBP flags equal. Returns (the card's directory, a
    summary)."""
    import numpy as np
    card_dir, cpu_dir = fresh_dir("chip_smoke_recipe"), fresh_dir(
        "chip_smoke_recipe_cpu")
    quiet = lambda *a: None  # noqa: E731
    t0 = time.perf_counter()
    TTC.phase_corpus(str(card_dir), RECIPE_TRAIN, RECIPE_TEST, device=dev,
                     log=quiet)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    TTC.phase_corpus(str(cpu_dir), RECIPE_TRAIN, RECIPE_TEST, device="cpu",
                     log=quiet)
    cpu_s = time.perf_counter() - t0
    errs, frames, names = {}, 0, {}
    for sub in ("corpus_train", "corpus_test"):
        a = sorted(p.name for p in (card_dir / sub).iterdir())
        b = sorted(p.name for p in (cpu_dir / sub).iterdir())
        if a != b:
            raise AssertionError(f"path T {sub}: files {a} on the card, {b} "
                                 f"on the CPU")
        names[sub] = a
        for n in a:
            with open(card_dir / sub / n, "rb") as f:
                x = pickle.load(f)    # written by this run
            with open(cpu_dir / sub / n, "rb") as f:
                y = pickle.load(f)    # written by this run
            frames += len(x["imu"])
            for k in ("imu", "nimble_qdq", "constrs"):
                e = float(np.abs(x[k] - y[k]).max())
                errs[k] = (max(errs.get(k, (0.0,))[0], e), TOL_SYN_IMU)
            off = int((x["constrs"][:, 0::4] != y["constrs"][:, 0::4]).sum())
            errs["sbp_flags_off"] = (errs.get("sbp_flags_off", (0,))[0]
                                     + off, 0)
    check("path T (the corpus phase) card vs CPU", errs)
    n = RECIPE_TRAIN + RECIPE_TEST
    summary = dict(files=names, frames=frames, card_s=card_s, cpu_s=cpu_s,
                   card_s_per_motion=card_s / n, cpu_s_per_motion=cpu_s / n,
                   card_s_per_1000_frames=card_s * 1e3 / frames,
                   max_err={k: v[0] for k, v in errs.items()})
    log(f"path T: {n} motions, {frames} frames at 60 Hz: card "
        f"{card_s:.2f} s ({card_s / n:.2f} s a motion), CPU {cpu_s:.2f} s; "
        f"{json.dumps(summary)}")
    return card_dir, summary


def clone_state(state):
    """A deep copy of a TrainState, its generators included."""
    import copy
    from tip_tpu_torch.train import train as TT
    gen = torch.Generator().manual_seed(0)
    gen.set_state(state.gen.get_state())
    noise = torch.Generator(device=state.noise_gen.device).manual_seed(0)
    noise.set_state(state.noise_gen.get_state())
    return TT.TrainState(
        model=copy.deepcopy(state.model),
        mu={k: v.clone() for k, v in state.mu.items()},
        nu={k: v.clone() for k, v in state.nu.items()},
        step=state.step.clone(), gen=gen, noise_gen=noise)


def states_equal(a, b):
    """Whether two TrainStates are bit-equal: parameters, moments, step
    and both generators."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (all(torch.equal(sa[k], sb[k]) and torch.equal(a.mu[k], b.mu[k])
                and torch.equal(a.nu[k], b.nu[k]) for k in sa)
            and torch.equal(a.step, b.step)
            and torch.equal(a.gen.get_state(), b.gen.get_state())
            and torch.equal(a.noise_gen.get_state(),
                            b.noise_gen.get_state()))


def sync_free_epoch(epoch, state, *args):
    """One call of an epoch function with torch's sync debug mode at
    "error" (a host sync inside raises), the launch counters set to 0 just
    before; synchronised after. Returns (state, aux, launches, synced
    ms)."""
    from tip_tpu_torch.ops import _kernels as K
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, aux = epoch(state, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    return state, aux, launches, ms


def profiled_epoch(epoch, state, *args):
    """Device ms (the sum of the kernels' device time, torch.profiler) and
    kernels of one epoch call, and its synced ms under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch(state, *args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    return dict(device_ms=sum(e.self_device_time_total for e in rows) / 1e3,
                kernels=sum(e.count for e in rows), synced_ms_profiled=ms)


def hold_launches(name, launches, steps, per_step):
    for k in KERNELS:
        want = steps * per_step.get(k, 0)
        if launches[k] != want:
            raise AssertionError(f"path {name}: {k} launched {launches[k]} "
                                 f"times, expected {want} ({steps} steps)")


def recipe_u(dev, TTC, corpus_dir):
    """Path U: the recipe (scripts/torch_train_convergence.py, bf16, K1 bf16
    and K10 bf16, the xla layer loop, rng dropout, B 256, T 40, AdamW) over
    path T's files: its epoch function run once with no host sync (one K1
    bf16 and one K10 bf16 a step, nothing else), against the same epoch
    with rnn_impl="plain" from the same state and generators; then
    phase_train for RECIPE_EPOCHS epochs with the device sampler and a
    checkpoint after each, a run resumed from the first checkpoint (epoch
    2's ends and the final state bit-equal to the uninterrupted run's),
    phase_eval on the held-out motion, and one epoch of cli/train with the
    recipe's flags and with tip_tpu's default flags. Returns (launches by
    path, summary)."""
    import shutil
    import numpy as np
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.train import data as TD
    from tip_tpu_torch.train import train as TT
    run = fresh_dir("chip_smoke_recipe_run")
    quiet = lambda *a: None  # noqa: E731
    prefix = TTC.phase_pack(str(run), [str(corpus_dir / "corpus_train")],
                            log=quiet)
    cfg = TTC.make_train_cfg(RECIPE_EPOCHS)
    ds = TD.PackedDataset.from_prefix(prefix)
    n_windows, n_batches = TTC.epoch_batches(ds.info, cfg)
    dds = TD.to_device(ds, dev)
    sampler = TD.make_window_sampler(ds.info, cfg.seq_len, dev)
    per_step = {"fused_rnn_bf16": 1, "fused_rnn_bwd_bf16": 1}

    # the epoch function: kernels against the plain RNN, then no host sync
    state0 = TT.init_state(cfg, dev)
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rnn_impl="plain"))
    runs = {}
    for name, c in (("U", cfg), ("U-plain", plain_cfg)):
        st = clone_state(state0)
        st.model = TT.M.TIPModel(c.model, device=dev)
        st.model.load_state_dict(state0.model.state_dict())
        st.model.requires_grad_(True)
        K.reset_launch_counts()
        st, aux = TT.make_epoch_fn(c, dds, sampler=sampler,
                                   n_batches=n_batches)(st)
        torch.cuda.synchronize()
        runs[name] = (aux["loss"].tolist(), dict(
            (k, v) for k, v in K.launch_counts.items() if v))
    if runs["U-plain"][1]:
        raise AssertionError(f"path U-plain launched {runs['U-plain'][1]}")
    errs = [abs(a - b) / abs(b) for a, b in zip(runs["U"][0],
                                                 runs["U-plain"][0])]
    log(f"  path U vs U-plain over one epoch of {n_batches} steps: loss rel "
        f"diff {max(errs):.3g}; U {runs['U'][0]}; U-plain "
        f"{runs['U-plain'][0]}")
    if not max(errs) <= TOL_LM_LOSS:
        raise AssertionError(f"path U vs U-plain: {errs}")
    epoch = TT.make_epoch_fn(cfg, dds, sampler=sampler, n_batches=n_batches)
    st, aux, launches, synced_ms = sync_free_epoch(epoch, clone_state(state0))
    hold_launches("U (epoch)", launches, n_batches, per_step)
    skipped = int(aux["skipped"].sum().item())
    if skipped or not torch.isfinite(aux["loss"]).all():
        raise AssertionError(f"path U: skipped {skipped}, loss "
                             f"{aux['loss'].tolist()}")
    prof = profiled_epoch(epoch, clone_state(state0))
    del st, state0

    # the script: two epochs with a checkpoint after each
    after = {}

    def on_epoch(ep, state, aux):
        after[ep] = (clone_state(state), aux)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    TTC.phase_train(str(run), prefix, RECIPE_EPOCHS, sampler="device",
                    device=dev, save_every=1, on_epoch=on_epoch, log=log)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    hold_launches("U (phase_train)", launches, RECIPE_EPOCHS * n_batches,
                  per_step)
    for ep, (_, aux) in after.items():
        if aux["skipped"].sum() or not np.isfinite(aux["loss"]).all():
            raise AssertionError(f"path U epoch {ep}: {aux}")
    # a run resumed from the first checkpoint
    resumed = fresh_dir("chip_smoke_recipe_resumed")
    (resumed / "ckpt").mkdir()
    shutil.copy(run / "ckpt" / f"ckpt_{n_batches}.pt", resumed / "ckpt")
    back = TT.restore_checkpoint(str(resumed / "ckpt"), cfg, device=dev)
    if not states_equal(back, after[1][0]):
        raise AssertionError("path U: the checkpoint after epoch 1 is not "
                             "the live state")

    def ends_of(state):
        g = torch.Generator(device=dev).manual_seed(0)
        g.set_state(state.noise_gen.get_state())
        return TD.device_sample_epoch(sampler, g, n_batches, cfg.batch_size)
    if not torch.equal(ends_of(back), ends_of(after[1][0])):
        raise AssertionError("path U: epoch 2's ends differ after a restore")
    del back
    TTC.phase_train(str(resumed), prefix, RECIPE_EPOCHS, sampler="device",
                    device=dev, log=quiet)
    final = TT.restore_checkpoint(str(resumed / "ckpt"), cfg, device=dev)
    if not states_equal(final, after[RECIPE_EPOCHS][0]):
        raise AssertionError("path U: the resumed run ends elsewhere than "
                             "the uninterrupted one")
    del final, after

    # the eval phase on the held-out motion
    K.reset_launch_counts()
    t0 = time.perf_counter()
    results = TTC.phase_eval(str(run), RECIPE_EPOCHS,
                             test_dir=str(corpus_dir / "corpus_test"),
                             test_len=RECIPE_EVAL_LEN, device=dev, log=quiet)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    for mode, r in results["modes"].items():
        if r["n_motions"] != 1 or not all(
                math.isfinite(v) for v in r["means"].values()):
            raise AssertionError(f"path U eval {mode}: {r}")
    if not (eval_launches["fused_rnn"] and eval_launches["decode_fused"]
            and eval_launches["tail_fused"]):
        raise AssertionError(f"path U eval: launches {eval_launches}")
    metrics = {m: r["means"] for m, r in results["modes"].items()}

    # cli/train on the same blobs, one epoch: the recipe's flags (the RNN
    # kernels in bf16), then tip_tpu's default flags (the plain RNN: no
    # kernel)
    from tip_tpu_torch.cli import train as TCT
    cli = {}
    for name, flags, per in (
            ("U-cli", ["--bf16", "--rnn_impl", "pallas", "--encoder_impl",
                       "xla", "--dropout_impl", "rng", "--dropout_rng",
                       "rbg"], per_step),
            ("U-cli-defaults", ["--rnn_impl", "scan", "--encoder_impl", "xla",
                                "--dropout_impl", "rng"], {})):
        out = fresh_dir(f"chip_smoke_{name}")
        K.reset_launch_counts()
        st = TCT.main(["--data_prefix", prefix, "--save_path", str(out),
                       "--epochs", "1", "--with_acc_sum", "--optim", "AdamW",
                       "--cosine_lr", *flags])
        torch.cuda.synchronize()
        cli_launches = {k: K.launch_counts.get(k, 0) for k in KERNELS}
        hold_launches(name, cli_launches, n_batches, per)
        with open(out / "metrics.jsonl") as f:
            recs = [json.loads(ln) for ln in f]
        loss = [r["mean_loss"] for r in recs if "mean_loss" in r]
        if int(st.step) != n_batches or len(loss) != 1 or not (
                loss[0] is not None and math.isfinite(loss[0])):
            raise AssertionError(f"path {name}: step {int(st.step)}, "
                                 f"{recs}")
        cli[name] = dict(flags=flags, steps=int(st.step), mean_loss=loss[0],
                         launches={k: v for k, v in cli_launches.items()
                                   if v})
        del st
    log(f"  path U: cli/train with the recipe's flags and with tip_tpu's "
        f"defaults: {json.dumps(cli)}")
    with open(run / "train_metrics.jsonl") as f:
        losses = {ep: json.loads(ln)["mean_loss"]
                  for ep, ln in enumerate(f, 1)}
    summary = dict(windows=n_windows, steps_per_epoch=n_batches,
                   loss_rel_vs_plain=max(errs), epoch_synced_ms=synced_ms,
                   epoch_step_ms=synced_ms / n_batches, **prof,
                   phase_train_s=train_s, mean_loss_by_epoch=losses,
                   resume_bit_equal=True, eval_s=eval_s,
                   eval_metrics=metrics, cli_train=cli)
    log(f"path U: {n_batches} steps an epoch, epoch {synced_ms:.1f} ms "
        f"synced, {prof['device_ms']:.1f} device ms; "
        f"{json.dumps(summary)}")
    return {"U": launches, "U-eval": eval_launches,
            "U-cli": cli["U-cli"]["launches"]}, summary


def epoch_v(dev):
    """Path V: the epoch function in the kernel configuration (f32, hash
    dropout; K1, K10 and four each of K11 and K12 a step) over V_BATCHES
    batches of given ends of the packed in-tree motions, with no host
    sync; held against as many train_step calls (path L's) on the same
    ends from the same state: bit-equal state and aux. Then an epoch of a
    batch with an inf in its windows: skipped, the state as before it."""
    import numpy as np
    from tip_tpu_torch.train import data as TD
    from tip_tpu_torch.train import train as TT
    cfg = train_config()
    ds = TD.PackedDataset.from_prefix(str(ROOT / "output"
                                          / "chip_smoke_train"))
    dds = TD.to_device(ds, dev)
    idx = TD.sample_epoch_indices(ds.info, cfg.seq_len,
                                  np.random.default_rng(21))
    ends = torch.as_tensor(idx[:V_BATCHES * cfg.batch_size].reshape(
        V_BATCHES, cfg.batch_size), device=dev)
    epoch = TT.make_epoch_fn(cfg, dds)
    state0 = TT.init_state(cfg, dev)
    a, aux, launches, synced_ms = sync_free_epoch(epoch, clone_state(state0),
                                                  ends)
    hold_launches("V", launches, V_BATCHES,
                  {"fused_rnn": 1, "fused_rnn_bwd": 1,
                   "encoder_layer_fwd": 4, "encoder_layer_bwd": 4})
    b = clone_state(state0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = [TT.train_step(b, TD.device_gather(dds, e, cfg.seq_len), cfg)
             for e in ends]
    steps_ms = (time.perf_counter() - t0) * 1e3
    table = {k: v.tolist() for k, v in aux.items()}
    equal = states_equal(a, b) and all(
        table[k] == [float(s[k]) for s in steps] for k in TT.AUX)
    log(f"  path V vs {V_BATCHES} train_step calls: "
        f"{'bit-equal' if equal else 'NOT bit-equal'}; losses "
        f"{table['loss']} vs {[s['loss'] for s in steps]}")
    if not equal:
        raise AssertionError("path V: the epoch and the train steps differ")
    # the epoch again, warm
    warm = clone_state(state0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch(warm, ends)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    del warm
    prof = profiled_epoch(epoch, clone_state(state0), ends)
    # a poisoned batch: an inf in the first window of a batch
    imu = dds.imu.clone()
    imu[int(ends[1, 0]) - 1] = float("inf")
    poisoned = TT.make_epoch_fn(cfg, TD.DeviceDataset(
        imu=imu, acc_sum=dds.acc_sum, s=dds.s))
    before = clone_state(a)
    a, aux, _, _ = sync_free_epoch(poisoned, a, ends[1:2])
    if aux["skipped"].tolist() != [1.0]:
        raise AssertionError(f"path V: the poisoned batch gave {aux}")
    kept = (states_equal(dataclasses.replace(a, gen=before.gen,
                                             noise_gen=before.noise_gen),
                         before)
            and not torch.equal(a.gen.get_state(), before.gen.get_state()))
    if not kept:
        raise AssertionError("path V: the poisoned batch changed the state "
                             "or left the generators")
    summary = dict(steps=V_BATCHES, bit_equal_to_train_steps=True,
                   epoch_synced_ms_first=synced_ms, epoch_synced_ms=warm_ms,
                   epoch_step_ms=warm_ms / V_BATCHES,
                   train_step_ms=steps_ms / V_BATCHES, **prof,
                   poisoned_batch_skipped=True)
    log(f"path V: {V_BATCHES} steps, epoch {warm_ms:.1f} ms synced, "
        f"{prof['device_ms']:.1f} device ms; {json.dumps(summary)}")
    return {"V": launches}, summary


def recipe_paths(dev):
    """Paths T, U and V. Returns (launches by path, summary)."""
    TTC = recipe_script()
    t0 = time.perf_counter()
    corpus_dir, t_summary = corpus_t(dev, TTC)
    launches, u_summary = recipe_u(dev, TTC, corpus_dir)
    v_launches, v_summary = epoch_v(dev)
    launches.update(v_launches)
    log(f"  recipe paths T, U, V: {time.perf_counter() - t0:.1f} s")
    return launches, {"T": t_summary, "U": u_summary, "V": v_summary}


# ---------------------------------------------------------------------------
# path X: tip_tpu's orbax checkpoint, read by the port's own reader
# ---------------------------------------------------------------------------

ORBAX_FIXTURE = ROOT / "tests" / "data" / "orbax_tiny"
ORBAX_DIGESTS = ROOT / "tests" / "data" / "orbax_tiny.json"
X_FRAMES = 120
X_STEPS = 2
X_BATCH = 8


def orbax_read_x():
    """The fixture read by utils/orbax_read.py on this host, every array
    against the digests of tip_tpu's restore. Returns (seconds, count)."""
    import hashlib
    from tip_tpu_torch.utils import orbax_read as OR
    t0 = time.perf_counter()
    arrays = OR.read_orbax(OR.step_dir(str(ORBAX_FIXTURE)))
    read_s = time.perf_counter() - t0
    with open(ORBAX_DIGESTS) as f:
        want = json.load(f)["arrays"]
    if set(arrays) != set(want):
        diff = sorted(set(arrays) ^ set(want))[:5]
        raise AssertionError(f"path X: the names {diff} are in one of the "
                             f"read arrays and the digests only")
    for name, a in arrays.items():
        got = dict(shape=list(a.shape), dtype=a.dtype.str,
                   sha256=hashlib.sha256(a.tobytes()).hexdigest())
        if got != want[name]:
            raise AssertionError(f"path X: {name} read as {got}, tip_tpu's "
                                 f"restore gives {want[name]}")
    return read_s, len(arrays)


def orbax_serve_x(dev):
    """cli/evaluate's load_model from the fixture, served over X_FRAMES
    frames of an in-tree motion on the default route and through the plain
    versions on the card. Returns the launches."""
    from tip_tpu_torch.cli import evaluate as TCE
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import runner as R
    imu, s_init = load_motion()
    skel = kin.amass_skeleton(device=dev)
    tiny = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
                rnn_hid_size=24)
    cfgs = {"X": R.RunnerConfig(model=M.ModelConfig(**tiny)),
            "X-plain": R.RunnerConfig(model=M.ModelConfig(
                **tiny, rnn_impl="plain", encoder_impl="plain"),
                tail_impl="plain")}
    on_path = {"X": {"fused_rnn": 1, "encoder_layer_fwd": 2,
                     "decode_fused": 1, "tail_fused": 1}, "X-plain": ()}
    runs, launches = {}, {}
    for name, cfg in cfgs.items():
        model = TCE.load_model(str(ORBAX_FIXTURE), cfg.model, 5, dev)
        runs[name], launches[name] = run_path(
            name, model, cfg, skel, s_init, imu[:X_FRAMES + 1], dev,
            on_path[name])
    compare_runs("path X (orbax weights) vs its plain path (card)",
                 runs["X"], runs["X-plain"], X_FRAMES, TOL_EVAL)
    return launches["X"]


def orbax_train_x(dev):
    """A full resume from the fixture (train.restore_checkpoint,
    params_only=False) in the kernel configuration takes X_STEPS steps of
    X_BATCH windows of the packed in-tree motions; the same restore with
    the plain versions takes the first step on the same batch, noise and
    masks (both restores seed the generators from the checkpoint's key).
    Returns (launches, first step's loss rel diff, params max diff)."""
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.train import data as TD
    from tip_tpu_torch.train import train as TT
    with open(ORBAX_DIGESTS) as f:
        meta = json.load(f)
    ds = TD.PackedDataset.from_prefix(str(ROOT / "output" /
                                          "chip_smoke_train"))
    batches = step_batches(ds, X_STEPS, X_BATCH, dev, seed=19)

    def cfg(**kw):
        return TT.TrainConfig(model=M.ModelConfig(**meta["widths"], **kw),
                              n_sbps=meta["n_sbps"], batch_size=X_BATCH,
                              lr=1e-3, optimizer=meta["optimizer"],
                              clip=meta["clip"])
    kern, plain = cfg(), cfg(rnn_impl="plain", encoder_impl="plain")
    state = TT.restore_checkpoint(str(ORBAX_FIXTURE), kern, device=dev)
    if int(state.step) != meta["step"]:
        raise AssertionError(f"path X: restored step {int(state.step)}")
    ref = TT.restore_checkpoint(str(ORBAX_FIXTURE), plain, device=dev)
    K.reset_launch_counts()
    auxes = [TT.train_step(state, b, kern) for b in batches]
    torch.cuda.synchronize()
    launches = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    hold_launches("X-train", launches, X_STEPS,
                  {"fused_rnn": 1, "fused_rnn_bwd": 1,
                   "encoder_layer_fwd": 2, "encoder_layer_bwd": 2})
    if int(state.step) != meta["step"] + X_STEPS or any(
            a["skipped"] or not math.isfinite(a["loss"]) for a in auxes):
        raise AssertionError(f"path X-train: step {int(state.step)}, "
                             f"{auxes}")
    # the kernels' first step again, from the same restore, beside the
    # plain versions' first step
    first = TT.restore_checkpoint(str(ORBAX_FIXTURE), kern, device=dev)
    aux_k = TT.train_step(first, batches[0], kern)
    aux_p = TT.train_step(ref, batches[0], plain)
    loss_rel = abs(aux_k["loss"] - aux_p["loss"]) / abs(aux_p["loss"])
    pk, pp = dict(first.model.named_parameters()), dict(
        ref.model.named_parameters())
    p_err = max((pk[n] - pp[n]).abs().max().item() for n in pk)
    check("path X-train first step vs the plain versions' (card)",
          {"loss_rel": (loss_rel, TOL_PATH), "params": (p_err, TOL_PATH)})
    if aux_k["loss"] != auxes[0]["loss"]:
        raise AssertionError(f"path X-train: two restores' first steps "
                             f"differ: {aux_k['loss']} vs "
                             f"{auxes[0]['loss']}")
    return launches, loss_rel, p_err, [a["loss"] for a in auxes]


def orbax_path_x(dev, card):
    """Path X. Returns (launches by path, summary)."""
    t0 = time.perf_counter()
    read_s, n_arrays = orbax_read_x()
    serve = orbax_serve_x(dev)
    train, loss_rel, p_err, losses = orbax_train_x(dev)
    secs = time.perf_counter() - t0
    summary = dict(seconds=secs, read_s=read_s, arrays=n_arrays,
                   serve_frames=X_FRAMES, train_steps=X_STEPS,
                   train_losses=losses, first_step_loss_rel=loss_rel,
                   first_step_params_max_diff=p_err,
                   launches={"X": {k: v for k, v in serve.items() if v},
                             "X-train": {k: v for k, v in train.items()
                                         if v}}, card=card)
    log(json.dumps({"orbax_path": summary}))
    log(f"path X: {secs:.1f} s ({card})")
    return {"X": serve, "X-train": train}, summary


# ---------------------------------------------------------------------------
# 11. path Y: the (data, model) mesh, in processes that share the card
# ---------------------------------------------------------------------------

# mesh shape (n_data, n_model) and backend of each case: two ranks on one
# card run on gloo (NCCL refuses two ranks on one device), one rank on NCCL
Y_CASES = {"a": ((2, 1), "gloo"), "b": ((1, 2), "gloo"),
           "c": ((2, 1), "gloo"), "d": ((1, 1), "nccl")}
Y_STEPS = {"a": 3, "b": 1, "d": 1}
Y_BATCH = 256
Y_TICKS = 60
# the children's own limit: a hung collective ends the phase, not the call
Y_TIMEOUT = 420
# the mesh's step against one process's on the same global batch, f32 with
# TF32 off: the loss's sums and the gradients' all-reduce add in another
# order (relative)
TOL_Y_LOSS = 1e-5
TOL_Y_NORM = 1e-4
# Adam's moments after the steps, leaf by leaf (the relative norm of the
# difference): a moment is a running mean of the gradients, so it carries
# their rounding (about 1e-6 relative) and no more, while a leaf whose
# gradient the mesh got wrong is off by the order of 1
TOL_Y_MOMENTS = 1e-3
# ...but for the key biases: a key bias adds one constant to every logit of
# a query's row, which the softmax drops, so their gradient is 0 in exact
# arithmetic and rounding alone in both runs (moments and updates apart by
# their own size). Their moments' RMS over the median RMS of the other
# leaves' (the reference's) must stay below this: a gradient that the
# mesh gave them would be of the others' size
TOL_Y_ZERO_GRAD = 1e-3
# the parameters after the steps, leaf by leaf: the norm of the difference
# over the norm of the reference's update (p - p0). An Adam update is about
# lr times the sign of the gradient, so where a gradient entry near 0 comes
# out of the sums in another order its update may flip, by at most 2 lr a
# step: k flips among a leaf's n entries give about 2 sqrt(k / n) (one flip
# in the smallest leaf, 256 entries: 0.125), a wrong update of the leaf 1
# or more
TOL_Y_UPDATE = 0.25
# and over all parameters, the share of entries off by more than
# TOL_Y_PARAMS_NEAR (0.017-0.048% on an H100 80GB HBM3 at 700 W, 0.17-0.19%
# in a CPU rehearsal at small widths)
TOL_Y_PARAMS_NEAR = 1e-6
TOL_Y_OFF_SHARE = 5e-3
# the meshed pool (32 slots a rank) against one card's pool of 64, path H
TOL_Y_POOL = 1e-4


def hold_y(name, errs):
    """``check``, and a line with each worst difference and its
    tolerance."""
    log(f"  {name}: " + ", ".join(f"{k} {e:.3g} (tol {t:g})"
                                  for k, (e, t) in errs.items()))
    check(name, errs)


def y_train(mesh, rank, dev, steps):
    """Y_STEPS steps of the paper recipe at full width in the kernel
    configuration (hash dropout, f32, B 256, T 40) over ``mesh``; rank 0
    then runs the same steps in one process, unmeshed, in the configuration
    a mesh trains (train._mesh_safe: the xla loop, K1/K10), from the same
    seed, on the same global batches."""
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.parallel import mesh as mesh_lib
    from tip_tpu_torch.train import data as TD
    from tip_tpu_torch.train import train as TT
    cfg = train_config()
    ds = TD.PackedDataset.from_prefix(str(ROOT / "output" /
                                          "chip_smoke_train"))
    batches = step_batches(ds, steps, Y_BATCH, dev, seed=23)
    rows = mesh_lib.rows(mesh, Y_BATCH)
    state = TT.shard_state(TT.init_state(cfg, dev), mesh)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    auxes, times = [], []
    for b in batches:
        t0 = time.perf_counter()
        auxes.append(TT.train_step(state, tuple(x[rows] for x in b), cfg,
                                   mesh=mesh))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    params, mu, nu = TT.gather_state(state, mesh)
    # the parameters this rank holds whole, which every rank must hold alike
    whole = {k: v.detach().cpu() for k, v in state.model.named_parameters()
             if v.shape == params[k].shape}
    out = dict(aux=auxes, launches=launches, step_ms=times, whole=whole,
               local_w_q=list(state.model.layers[0].w_q.shape))
    if rank != 0:
        return out
    ref_cfg = train_config(encoder_impl="xla")
    ref = TT.init_state(ref_cfg, dev)
    p0 = {k: v.detach().clone() for k, v in ref.model.named_parameters()}
    ref_aux, ref_times = [], []
    for b in batches:
        t0 = time.perf_counter()
        ref_aux.append(TT.train_step(ref, b, ref_cfg))
        torch.cuda.synchronize()
        ref_times.append((time.perf_counter() - t0) * 1e3)
    want = {k: v.detach() for k, v in ref.model.named_parameters()}

    def rel(d, u):
        d, u = d.norm().item(), u.norm().item()
        return d / u if u else (0.0 if d == 0 else math.inf)

    def rms(t):
        return t.norm().item() / math.sqrt(t.numel())

    out.update(
        ref_step_ms=ref_times,
        loss_rel=max(abs(a["loss"] - r["loss"]) / abs(r["loss"])
                     for a, r in zip(auxes, ref_aux)),
        grad_norm_rel=max(abs(a["grad_norm"] - r["grad_norm"])
                          / r["grad_norm"] for a, r in zip(auxes, ref_aux)),
        leaves={k: dict(mu=rel(mu[k] - ref.mu[k], ref.mu[k]),
                        nu=rel(nu[k] - ref.nu[k], ref.nu[k]),
                        update=rel(params[k] - w, w - p0[k]),
                        mu_rms=rms(mu[k]), ref_mu_rms=rms(ref.mu[k]))
                for k, w in want.items()},
        params_max_abs=max((params[k] - w).abs().max().item()
                           for k, w in want.items()),
        params_off_share=sum(
            int(((params[k] - w).abs() > TOL_Y_PARAMS_NEAR).sum())
            for k, w in want.items()) / sum(w.numel() for w in want.values()),
        bit_equal=all(a == r for a, r in zip(auxes, ref_aux)) and all(
            torch.equal(params[k], w) for k, w in want.items()),
        clipped=sum(r["grad_norm"] > cfg.clip for r in ref_aux))
    if mesh.size() == 1:
        # the NCCL group itself: one all-reduce of the parameters' bytes
        import torch.distributed as dist
        w = want["out.w"]
        out["nccl_merge_equal"] = torch.equal(
            mesh_lib.merge([w], dist.group.WORLD)[0], w)
    return out


def y_pool(mesh, rank, dev):
    """StreamPool(mesh=) in path H's configuration (kv_cache, fused, f32:
    K8, K2, K3) at capacity 64, Y_TICKS ticks of the pool schedule (streams
    join at ticks 7 and 50), with the launch counters reset just before
    and read just after; rank 0 then runs one card's pool of 64 on the
    same weights and ticks."""
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import runner as R
    from tip_tpu_torch.runtime.serving import StreamPool
    cfg = R.RunnerConfig(model=M.ModelConfig(forward_impl="fused",
                                             compute_dtype="float32"),
                         serving_mode="kv_cache")
    model = M.TIPModel(cfg.model, device=dev,
                       generator=torch.Generator().manual_seed(0))
    skel = kin.amass_skeleton(device=dev)
    batch, active, events, s_inits = pool_schedule(Y_TICKS)

    def drive(pool):
        qdq, times = [], []
        for t in range(Y_TICKS):
            for kind, slot, motion in events.get(t, ()):
                if kind == "remove":
                    pool.remove_stream(slot)
                else:
                    pool.add_stream(s_inits[motion])
            t0 = time.perf_counter()
            qdq.append(pool.step(batch[t])["qdq"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return torch.stack(qdq), statistics.median(times[Y_TICKS // 2:])

    pool = StreamPool(model, cfg, skel, capacity=POOL_CAPACITY, device=dev,
                      mesh=mesh)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    qdq, tick_ms = drive(pool)
    launches = {k: K.launch_counts.get(k, 0) for k in KERNELS}
    out = dict(launches=launches, tick_ms=tick_ms,
               local_slots=pool._carries.n_streams)
    if rank != 0:
        return out
    ref_qdq, ref_tick_ms = drive(StreamPool(model, cfg, skel,
                                            capacity=POOL_CAPACITY,
                                            device=dev))
    on = active[:Y_TICKS].to(dev)
    out.update(ref_tick_ms=ref_tick_ms,
               max_abs=(qdq - ref_qdq)[on].abs().max().item(),
               finite=bool(torch.isfinite(qdq[on]).all()))
    return out


def mesh_child(case, rank, world, d):
    """One rank of path Y: ``chip_smoke.py --mesh-child <case> <rank>
    <world> <dir>``. Loads the kernels the parent built (it builds
    nothing), joins the case's group through a file rendezvous in <dir>,
    runs the case on cuda:0 and writes its result to <dir>."""
    import torch.distributed as dist
    from tip_tpu_torch.parallel import mesh as mesh_lib
    exact_math()
    rank, world = int(rank), int(world)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    shape, backend = Y_CASES[case]
    mesh_lib.init_distributed("file://" + str(Path(d) / f"rendezvous_{case}"),
                              world_size=world, rank=rank, backend=backend)
    try:
        mesh = mesh_lib.make_mesh(*shape, device_type="cuda")
        out = (y_pool(mesh, rank, dev) if case == "c"
               else y_train(mesh, rank, dev, Y_STEPS[case]))
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(d) / f"y_{case}_{rank}.pt")
    return 0


def mesh_path_y(card):
    """Path Y: every case's ranks started together as child processes of
    this script on the one card (the kernels already built), waited for
    with a limit, and their results held. Returns (launches by case: a
    list by rank, summary)."""
    t0 = time.perf_counter()
    d = ROOT / "output" / "chip_smoke_mesh"
    if d.exists():
        import shutil
        shutil.rmtree(d)
    d.mkdir(parents=True)
    procs = []
    for case, ((n_data, n_model), _) in Y_CASES.items():
        world = n_data * n_model
        for rank in range(world):
            log_f = open(d / f"log_{case}_{rank}.txt", "w")
            procs.append((case, rank, log_f, subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-child",
                 case, str(rank), str(world), str(d)], cwd=ROOT,
                stdout=log_f, stderr=subprocess.STDOUT)))
    deadline = time.perf_counter() + Y_TIMEOUT
    try:
        for _, _, _, p in procs:
            p.wait(timeout=max(deadline - time.perf_counter(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for _, _, log_f, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log_f.close()
    failed = [(c, r, p.returncode) for c, r, _, p in procs if p.returncode]
    if failed:
        for c, r, _, _ in procs:
            log(f"--- path Y ({c}) rank {r}:\n"
                + (d / f"log_{c}_{r}.txt").read_text()[-4000:])
        raise AssertionError(f"path Y: ranks failed or hung (case, rank, "
                             f"exit code): {failed}")
    res = {c: [torch.load(d / f"y_{c}_{r}.pt", weights_only=False)
               for r in range(n_data * n_model)]
           for c, ((n_data, n_model), _) in Y_CASES.items()}
    summary, launches = {}, {}
    for case in ("a", "b", "d"):
        ranks, steps = res[case], Y_STEPS[case]
        r0 = ranks[0]
        if any(r["aux"] != r0["aux"] for r in ranks):
            raise AssertionError(f"path Y ({case}): the ranks' aux differ")
        differ = [k for r in ranks[1:] for k, v in r["whole"].items()
                  if not torch.equal(v, r0["whole"][k])]
        if differ:
            raise AssertionError(f"path Y ({case}): the ranks' copies of "
                                 f"{sorted(set(differ))} differ")
        for r in ranks:
            hold_launches(f"Y ({case})", r["launches"], steps,
                          {"fused_rnn": 1, "fused_rnn_bwd": 1})
        launches[f"Y-{case}"] = [r["launches"] for r in ranks]
        leaves = r0["leaves"]
        grad = [k for k in leaves if not k.endswith(".b_k")]
        worst = {m: max(((leaves[k][m], k) for k in grad))
                 for m in ("mu", "nu", "update")}
        floor = statistics.median(leaves[k]["ref_mu_rms"] for k in grad)
        key_bias = max(leaves[k]["mu_rms"] for k in leaves
                       if k not in grad) / floor
        summary[case] = dict(
            mesh=list(Y_CASES[case][0]), backend=Y_CASES[case][1],
            steps=steps, loss=[a["loss"] for a in r0["aux"]],
            loss_rel=r0["loss_rel"], grad_norm_rel=r0["grad_norm_rel"],
            worst_leaf=worst, key_bias_mu=key_bias,
            params_max_abs=r0["params_max_abs"],
            leaves_alike_on_every_rank=len(r0["whole"]),
            params_off_share=r0["params_off_share"], clipped=r0["clipped"],
            bit_equal=r0["bit_equal"], local_w_q=r0["local_w_q"],
            step_ms=[r["step_ms"] for r in ranks],
            single_step_ms=r0["ref_step_ms"],
            launches=[{k: v for k, v in r["launches"].items() if v}
                      for r in ranks])
        if case == "d":
            if not (r0["bit_equal"] and r0["nccl_merge_equal"]):
                raise AssertionError("path Y (d): the one-rank NCCL mesh's "
                                     "step is not the unmeshed step bit for "
                                     "bit")
        else:
            hold_y(f"path Y ({case}) mesh {Y_CASES[case][0]} vs one process "
                   f"(card)", {"loss_rel": (r0["loss_rel"], TOL_Y_LOSS),
                               "grad_norm_rel": (r0["grad_norm_rel"],
                                                 TOL_Y_NORM),
                               **{f"{m}({k})": (e, tol) for m, (e, k), tol
                                  in zip(worst, worst.values(),
                                         (TOL_Y_MOMENTS, TOL_Y_MOMENTS,
                                          TOL_Y_UPDATE))},
                               "key_bias_mu": (key_bias, TOL_Y_ZERO_GRAD),
                               "params_off_share": (r0["params_off_share"],
                                                    TOL_Y_OFF_SHARE)})
    ranks = res["c"]
    for r in ranks:
        per = {"fused_cached_batch": 1, "decode_fused": 1, "tail_fused": 1}
        hold_launches("Y (c)", r["launches"], Y_TICKS, per)
    launches["Y-c"] = [r["launches"] for r in ranks]
    if not ranks[0]["finite"]:
        raise AssertionError("path Y (c): the meshed pool's qdq is not "
                             "finite")
    hold_y("path Y (c) StreamPool(mesh=) 2x1 vs one card's pool",
           {"qdq": (ranks[0]["max_abs"], TOL_Y_POOL)})
    summary["c"] = dict(mesh=list(Y_CASES["c"][0]), ticks=Y_TICKS,
                        capacity=POOL_CAPACITY,
                        local_slots=[r["local_slots"] for r in ranks],
                        max_abs=ranks[0]["max_abs"],
                        tick_ms=[r["tick_ms"] for r in ranks],
                        single_tick_ms=ranks[0]["ref_tick_ms"],
                        launches=[{k: v for k, v in r["launches"].items()
                                   if v} for r in ranks])
    secs = time.perf_counter() - t0
    summary.update(seconds=secs, card=card)
    log(json.dumps({"mesh_path": summary}))
    log(f"path Y: {secs:.1f} s ({card})")
    return launches, summary


# the path whose launches a kernel's entry reports
COUNTED_ON = {"fused_rnn": "A", "decode_fused": "A", "tail_fused": "A",
              "fused_forward_last": "B", "fused_forward": "replay",
              "fk_bullet_fused": "C", "fused_cached_forward_step": "D",
              "fused_cached_batch": "H", "fused_recompute_batch": "J",
              "fused_rnn_bwd": "L", "encoder_layer_fwd": "L",
              "encoder_layer_bwd": "L", "fused_rnn_bf16": "A-bf16",
              "encoder_layer_fwd_bf16": "A-bf16",
              "fused_rnn_bwd_bf16": "L-bf16",
              "encoder_layer_bwd_bf16": "L-bf16"}


def exact_math():
    """TF32 off, and cuBLAS's bf16 products (the in-projection, W_ih, the
    out-projection and the plain versions in bf16) summed in f32, as
    XLA's are."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def count_launches(kernels, launches, mesh_launches, abf_calls,
                   pool_summary):
    """Each kernel's launches on its path and on every other path that
    launched it; raise if a kernel was not launched on its path."""
    for k in kernels:
        k["launches"] = launches[COUNTED_ON[k["name"]]][k["name"]]
        k["launches_on"] = COUNTED_ON[k["name"]]
        k["launches_full_runner"] = {
            p: launches[p][k["name"]] for p in ("N", "N-gt", "N-E")
            if launches[p][k["name"]]}
        k["launches_pool"] = {p: launches[p][k["name"]] for p in (
            "G", "H", "I", "J", "K", "K-bf16") if launches[p][k["name"]]}
        k["launches_serving"] = {p: launches[p][k["name"]] for p in (
            "P", "P-2", "Q") if launches[p][k["name"]]}
        k["launches_recipe"] = {p: launches[p].get(k["name"], 0) for p in (
            "U", "U-eval", "U-cli", "V") if launches[p].get(k["name"])}
        k["launches_orbax"] = {p: launches[p][k["name"]] for p in (
            "X", "X-train") if launches[p][k["name"]]}
        k["launches_mesh"] = {
            p: [r[k["name"]] for r in by_rank]
            for p, by_rank in mesh_launches.items()
            if any(r[k["name"]] for r in by_rank)}
        if not k["launches"] > 0:
            raise AssertionError(f"{k['name']} was not launched on its path")
        if k["name"] in abf_calls:
            k["calls_held"] = {
                "A-bf16": abf_calls[k["name"]],
                "K-bf16": pool_summary["K-bf16"]["calls"][k["name"]]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on a GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mesh-child"]:
        return mesh_child(*sys.argv[2:])
    exact_math()
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import kinematics as kin

    dev = torch.device("cuda")
    card = card_info()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    report = Report()
    with report.stage("build and kernel checks"):
        t0 = time.perf_counter()
        K.build_all()
        log(f"kernels built in {time.perf_counter() - t0:.1f} s: "
            f"{K.sources()}")
        stamp("built")

        gen = torch.Generator(device=dev).manual_seed(1)
        skel = kin.amass_skeleton(device=dev)
        model = M.TIPModel(M.ModelConfig(forward_impl="fused"), device=dev,
                           generator=torch.Generator().manual_seed(0))
        kernels = [check_fused_rnn(dev, gen), check_decode_fused(dev, gen),
                   check_tail_fused(dev, gen, skel),
                   *check_fused_forward(dev, gen, model),
                   check_fk_bullet_fused(dev, gen, skel),
                   check_fused_cached(dev, gen, model),
                   check_fused_cached_batch(dev, gen, model),
                   check_fused_recompute_batch(dev, gen, model),
                   check_fused_rnn_bwd(dev, gen),
                   *check_encoder_train(dev, gen, model)]
        for check_bf16 in (
                lambda: check_fused_rnn(dev, gen, torch.bfloat16),
                lambda: check_encoder_fwd_bf16(dev, gen, model),
                lambda: check_fused_rnn_bwd(dev, gen, torch.bfloat16),
                lambda: check_encoder_bwd_bf16(dev, gen, model)):
            t0 = time.perf_counter()
            kernels.append(check_bf16())
            log(f"  {kernels[-1]['name']} checked and timed in "
                f"{time.perf_counter() - t0:.1f} s")
        stamp("kernels checked")
        widths = {**widths_by_kernel(check_rnn_widths(dev, gen)),
                  **widths_by_kernel(check_whole_model_widths(dev, gen))}
        batched = check_batched_tail(dev, gen, skel)
        children_first = check_children_first(dev, gen)
        deep_chains = check_deep_chains(dev, gen)
        long_filter = check_long_filter(dev, gen, skel)
        tail = tail_floor_and_clocks(dev, gen, skel)
        race_err = race_check(dev, gen, skel)
        for k in kernels:
            if k["name"] in batched:
                k.update({f: v for f, v in tail[k["name"]].items()
                          if f != "pool"})
                k["pool"] = dict(batched[k["name"]],
                                 **tail[k["name"]]["pool"])
            if k["name"] in ("decode_fused", "tail_fused"):
                k["race_check_max_abs_err"] = race_err
            if k["name"] in children_first:
                k["children_first_max_abs_err"] = children_first[k["name"]]
                k["deep_chains_max_abs_err"] = deep_chains[k["name"]]
            if k["name"] == "decode_fused":
                k["long_filter_max_abs_err"] = long_filter
            if k["name"] in widths:
                k["widths"] = widths[k["name"]]
        torch.cuda.synchronize()
        for k in kernels:
            log(f"  {k['name']}: max err {k['max_abs_err']:.3g} (tol "
                f"{k['tol']:g}), device {k['ms']:.4f} ms (eager call "
                f"{k['call_ms']:.4f}), plain {k['plain_ms']:.4f} "
                f"({k['plain_call_ms']:.4f}), bound {k['bound_ms']:.2e} "
                f"ms ({k['bound_by']}), library {k['library_ms']}")

    stamp("widths and tail checks")
    report.add("kernels", f"{len(kernels)} checked; worst err/tol "
               f"{max(k['max_abs_err'] / k['tol'] for k in kernels):.3g}")
    with report.stage("main paths"):
        launches, frame_ms, runs, state_dict, abf_calls = main_paths(dev)
    report.paths(launches, {p: f"frame {v:.3f} ms"
                            for p, v in frame_ms.items()})
    stamp("main paths")
    with report.stage("full runner paths"):
        full_launches, full_summary = full_runner_paths(dev, state_dict)
    launches.update(full_launches)
    report.paths(full_launches, {p: f"frame {v:.3f} ms" for p, v in
                                 full_summary["frame_ms"].items()})
    stamp("full runner paths")
    with report.stage("pool paths"):
        pool_launches, pool_summary = pool_paths(dev, runs, state_dict)
    launches.update(pool_launches)
    report.paths(pool_launches, {p: f"tick {v['tick_ms']:.3f} ms"
                                 for p, v in pool_summary.items()})
    stamp("pool paths")
    with report.stage("widened paths and eval"):
        widened = widened_paths(dev, state_dict)
        eval_launches, eval_summary = eval_path(dev)
    launches.update(widened)
    launches.update(eval_launches)
    report.paths(widened)
    report.paths(eval_launches, {p: f"{v['s_per_motion']:.3f} s a motion"
                                 for p, v in eval_summary.items()})
    stamp("widened paths and eval")
    with report.stage("serving paths"):
        serve_launches, serve_summary = serving_paths(dev, card)
    launches.update(serve_launches)
    free = serve_summary["P"]["free_run"]
    report.paths(serve_launches, {
        "P": f"{free['ticks_done']}/{free['ticks_due']} ticks "
             f"({free['ticks_share']:.1%}); tick p50 "
             f"{free['tick_ms_p50']:.2f}, p99 {free['tick_ms_p99']:.2f} ms; "
             f"{free['threads']} threads",
        "Q": f"step p50 {serve_summary['Q']['p50_ms']:.2f} ms"})
    report.add("P tick", f"ms p50 fill {free['fill_ms_p50']:.2f}, step "
               f"{free['pool_step_ms_p50']:.2f} (bare "
               f"{free['bare_step_ms_p50']:.2f}), encode "
               f"{free['encode_ms_p50']:.2f}, send {free['send_ms_p50']:.2f}")
    report.add("R", f"{serve_summary['R']['s_per_1000_frames']:.3f} s a "
               f"1,000 frames")
    stamp("serving paths")
    with report.stage("training paths"):
        train_launches, train_summary = training_paths(dev)
    launches.update(train_launches)
    report.paths(train_launches, {p: f"step {v['step_ms']:.2f} ms"
                                  for p, v in train_summary.items()})
    stamp("training paths")
    with report.stage("recipe paths"):
        recipe_launches, recipe_summary = recipe_paths(dev)
    launches.update(recipe_launches)
    report.add("T", f"{recipe_summary['T']['card_s_per_motion']:.3f} s a "
               f"motion on the card")
    report.paths(recipe_launches, {
        p: f"epoch {recipe_summary[p]['epoch_synced_ms']:.1f} ms"
        for p in ("U", "V")})
    stamp("recipe paths")
    with report.stage("path X"):
        orbax_launches, orbax_summary = orbax_path_x(dev, card)
    launches.update(orbax_launches)
    report.paths(orbax_launches)
    stamp("path X")
    with report.stage("path Y"):
        mesh_launches, mesh_summary = mesh_path_y(card)
    ys = mesh_summary
    report.add("Y", "loss/grad " + ", ".join(
        f"({c}) {ys[c]['loss_rel']:.2g}/{ys[c]['grad_norm_rel']:.2g}"
        for c in "ab") + f"; pool (c) {ys['c']['max_abs']:.2g}; (d) "
        f"bit-equal {ys['d']['bit_equal']}")
    stamp("path Y")
    with report.stage("launch counts"):
        count_launches(kernels, launches, mesh_launches, abf_calls,
                       pool_summary)
    frame_ms.update(full_summary["frame_ms"])
    log(json.dumps({"frame_ms": frame_ms, "launches": launches,
                    "pool_tick_ms": {n: v["tick_ms"]
                                     for n, v in pool_summary.items()},
                    "train_step_ms": {n: v["step_ms"]
                                      for n, v in train_summary.items()},
                    "eval_s_per_motion": {n: v["s_per_motion"]
                                          for n, v in eval_summary.items()},
                    "serve_tick_ms_p50": serve_summary["P"]["free_run"][
                        "tick_ms_p50"],
                    "live_frame_ms_p50": serve_summary["Q"]["p50_ms"],
                    "datagen_s_per_1000_frames": serve_summary["R"][
                        "s_per_1000_frames"],
                    "corpus_s_per_motion": recipe_summary["T"][
                        "card_s_per_motion"],
                    "epoch_ms": {p: {k: recipe_summary[p][k] for k in (
                        "epoch_synced_ms", "device_ms", "kernels")}
                        for p in ("U", "V")},
                    "recipe_eval": recipe_summary["U"]["eval_metrics"],
                    "orbax_path_s": orbax_summary["seconds"],
                    "mesh_path_s": mesh_summary["seconds"],
                    "card": card}))
    print(json.dumps({"kernels": kernels}))
    stamp("done")
    report.print()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
