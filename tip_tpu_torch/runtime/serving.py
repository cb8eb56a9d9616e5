"""Batched multi-stream serving: many IMU streams on one card (twin of
tip_tpu/runtime/serving.py).

The runner carry is a fixed set of tensors, so a pool of streams is a
stacked carry (``runner.PoolCarry``) with a per-slot active mask: one
batched frame step (``runner.pool_step``) serves the whole pool per tick,
and adding or removing a stream touches one slot. Each stream joins at its
own tick; the per-stream frame counters live on the host
(runtime/runner.py says why).

``mesh`` (a ``DeviceMesh`` of ``parallel/mesh.py``, one process a device)
spreads the pool's slots over the data axis: each rank holds its
capacity / n_data slots and a whole model, and steps its slots through the
same kernels as one card's pool. What tip_tpu's pool takes and this one
does not: the tile sizes of the batched Pallas kernels (``b_tile``, ``bt``,
``bt_rnn``: VMEM tiles picked by ops/tiling.py; the CUDA kernels K8 and K9
take any number of streams).
"""

import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tip_tpu_torch import constants as cst
from tip_tpu_torch import resolve_device
from tip_tpu_torch.models import tip_model as M
from tip_tpu_torch.ops import kinematics as kin
from tip_tpu_torch.parallel import mesh as mesh_lib
from tip_tpu_torch.runtime import runner as runner_lib


class StreamPool:
    """Fixed-capacity pool of independent streaming sessions."""

    def __init__(self, model: M.TIPModel, cfg: runner_lib.RunnerConfig,
                 skel: Optional[kin.Skeleton] = None, capacity: int = 64,
                 dtype=torch.float32, device=None,
                 chunk: Optional[int] = None, mesh=None):
        """Runs on ``device`` (``cuda`` unless the caller asks for another);
        the model, and the skeleton when one is given, must already be
        there, in ``dtype``.

        chunk: optionally process the pool in sub-batches of this many
        streams per tick (each a ``pool_step`` of its own, so each kernel
        of the tick is launched once per sub-batch). Must divide the
        streams a rank holds (capacity without a mesh).

        mesh: every rank builds the pool alike (a whole model on its
        ``device``) and takes the same ``add_stream``, ``remove_stream``
        and ``step`` calls; it holds the slots of its rows of the data axis
        (``parallel.mesh.rows``), and ``step`` returns every slot's outputs
        on every rank. capacity must split over the data axis.
        """
        self.device = resolve_device(device)
        if model.cfg != cfg.model:
            raise ValueError("the model was built for another ModelConfig "
                             "than cfg.model")
        runner_lib._check_on(next(model.parameters()), self.device,
                             "the model")
        self._mesh = mesh
        if mesh is not None and capacity % mesh.size(0):
            raise ValueError(f"capacity={capacity} must split over the "
                             f"{mesh.size(0)} ranks of the data axis")
        # this rank's slots
        self._rows = (slice(0, capacity) if mesh is None
                      else mesh_lib.rows(mesh, capacity))
        local = self._rows.stop - self._rows.start
        if chunk is not None and (chunk < 1 or local % chunk != 0):
            raise ValueError(f"chunk={chunk} must divide the {local} slots "
                             f"of a rank (capacity={capacity})")
        self.model = model
        self.cfg = cfg
        self.capacity = capacity
        self.chunk = chunk
        self.skel = skel or kin.amass_skeleton(dtype=dtype,
                                               device=self.device)
        self._dtype = dtype
        # a tick's outputs by slot, which a rank whose tick raised must
        # still bring to the mesh's gather
        self._out_shapes = {"qdq": (2 * cst.N_DOFS,),
                            "viz_locs": (cfg.n_sbps, 3),
                            "ct": (cfg.n_sbps * 4,)}

        # every slot's membership, the same on every rank of a mesh
        self.active = np.zeros(capacity, bool)
        # per-slot init poses, kept on the host so that a failed tick can
        # rebuild the pool (see step)
        self._s_inits = np.zeros((capacity, 2 * cst.N_DOFS), np.float64)
        # the fused kernels' weights, packed once: a tick never looks the
        # pack up in the model
        self._packed = runner_lib.pack_fused_weights(model, cfg, dtype)
        # the global tick: the KV-cache modes' ring cursor, shared by every
        # stream of the pool
        self._tick = 0
        # add_stream, remove_stream and step are serialised, the free-slot
        # scan and claim included: a tick writes the cache rings in place,
        # and a slot written under it (the serve daemon's accept threads
        # race its ticker) would be half the old stream's and half the new
        self._carries_lock = threading.Lock()
        self._carries = self._empty_pool()

    def _empty_pool(self) -> runner_lib.PoolCarry:
        """Stacked zero-session carries of this rank's slots (at
        construction and for the failed-tick rebuild)."""
        n = self._rows.stop - self._rows.start
        return runner_lib.pool_init(
            self.cfg, self.skel, np.zeros((n, 2 * cst.N_DOFS)),
            self._dtype, self.device)

    def _own(self, slot: int) -> bool:
        return self._rows.start <= slot < self._rows.stop

    def _slot_init(self, s_init) -> runner_lib.RunnerCarry:
        return runner_lib.runner_init(self.cfg, self.skel, s_init,
                                      self._dtype, self.device)

    def add_stream(self, s_init) -> int:
        """Returns the slot id; raises RuntimeError if the pool is full.
        Thread-safe with respect to a concurrent step() and other
        add_stream calls."""
        fresh = self._slot_init(s_init)
        with self._carries_lock:
            free = np.flatnonzero(~self.active)
            if len(free) == 0:
                raise RuntimeError("stream pool full")
            slot = int(free[0])
            if self._own(slot):
                runner_lib.pool_write_slot(self._carries,
                                           slot - self._rows.start, fresh)
            self.active[slot] = True
            self._s_inits[slot] = np.asarray(s_init, np.float64)
        return slot

    def remove_stream(self, slot: int):
        # active[] is part of the lock-protected pool membership
        with self._carries_lock:
            self.active[slot] = False

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def _rebuild_carries(self):
        """Recreate the pool state from the stored per-slot init poses.
        Active streams restart their sessions (smoothing warm-up and a
        fresh cache): degraded but well-defined recovery."""
        carries = self._empty_pool()
        for slot in np.flatnonzero(self.active):
            if self._own(int(slot)):
                runner_lib.pool_write_slot(
                    carries, int(slot) - self._rows.start,
                    self._slot_init(self._s_inits[slot]))
        self._carries = carries

    def _step(self, carries, imu, tick):
        """One tick over this rank's slots, or over their chunks in turn."""
        cfg, skel = self.cfg, self.skel
        n = carries.n_streams
        with torch.no_grad():
            if self.chunk is None or self.chunk >= n:
                return runner_lib.pool_step(self.model, carries, imu, cfg,
                                            skel, tick, self._packed)
            parts = [runner_lib.pool_step(
                self.model, carries.streams(lo, lo + self.chunk),
                imu[lo:lo + self.chunk], cfg, skel, tick, self._packed)
                for lo in range(0, n, self.chunk)]
        return (runner_lib.join_carries([c for c, _ in parts],
                                        carries.cache),
                {k: torch.cat([o[k] for _, o in parts])
                 for k in parts[0][1]})

    def step(self, imu_batch) -> Dict[str, torch.Tensor]:
        """One 60 Hz tick for every slot. imu_batch: (capacity, 72); rows of
        inactive slots are ignored (computed but discarded). Returns
        ``qdq`` (capacity, 114), ``viz_locs`` and ``ct`` on the pool's
        device.

        The cache rings are written in place, so a tick that raises can
        leave them half written; on error the pool state is rebuilt from
        the per-slot init poses (active sessions restart) before
        re-raising, keeping the pool usable for the next tick. Under a
        mesh each rank brings its error flag to the one all-reduce that
        gathers the outputs, so every rank learns of a tick that failed on
        any, and every rank rebuilds and raises."""
        imu = torch.as_tensor(imu_batch, dtype=self._dtype,
                              device=self.device)
        if self._mesh is not None:
            if tuple(imu.shape) != (self.capacity, cst.IMU_DIM):
                raise ValueError(f"imu_batch is ({self.capacity}, "
                                 f"{cst.IMU_DIM}) for this pool, got "
                                 f"{tuple(imu.shape)}")
            imu = imu[self._rows]
        with self._carries_lock:
            try:
                carries, out = self._step(self._carries, imu, self._tick)
                error = None
            except Exception as e:
                carries, out, error = None, None, e
            failed = []
            if self._mesh is not None and self._mesh.size() > 1:
                out, failed = self._gather(out)
            if error is not None or failed:
                self._rebuild_carries()
                try:
                    raise error or RuntimeError(
                        f"the tick failed on rank(s) {failed} of the mesh; "
                        f"the pool restarted its streams")
                finally:
                    # this frame holding the error, whose traceback holds
                    # this frame, would keep the failed tick's state (the
                    # old rings) allocated until the cyclic collector runs
                    error = None
            self._carries = carries
            self._tick += 1
        return out

    def _gather(self, out):
        """Every slot's outputs and every rank's error flag on every rank,
        in one all-reduce over the mesh (``parallel.mesh.merge``, exact):
        the ranks at model coordinate 0 write their rows of the outputs, a
        rank whose tick raised (``out`` None) writes zeros and its flag.
        Returns (outputs, the ranks whose tick raised)."""
        coords = mesh_lib.coords(self._mesh)
        full = []
        for k, shape in self._out_shapes.items():
            t = torch.zeros((self.capacity,) + shape, dtype=self._dtype,
                            device=self.device)
            if out is not None and coords.model == 0:
                t[self._rows] = out[k]
            full.append(t)
        flags = torch.zeros(dist.get_world_size(), dtype=torch.uint8,
                            device=self.device)
        flags[dist.get_rank()] = out is None
        *full, flags = mesh_lib.merge(full + [flags], dist.group.WORLD)
        return (dict(zip(self._out_shapes, full)),
                torch.nonzero(flags).flatten().tolist())
