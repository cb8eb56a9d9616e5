"""Training-window sampling from packed blobs (twin of
tip_tpu/train/data.py).

The blobs (``data_gen/combine.py``) are memory-mapped once; an epoch draws
new window-end indices with numpy's ``default_rng`` in tip_tpu's order, so
one seed gives tip_tpu's windows. ``to_device`` puts the blobs on the card
once and ``device_gather`` gathers a batch's windows there from a (B,)
index tensor, so a step copies B indices up instead of the batch. The
on-device sampler (``make_window_sampler``, ``device_sample_epoch``) draws
a whole epoch's ends on the card from a ``torch.Generator``, so an epoch
needs nothing from the host. Under a mesh (``parallel/mesh.py``) every rank
holds the whole blobs, as tip_tpu replicates them, draws or takes the
whole epoch's ends and gathers the windows of its own rows
(``train.make_epoch_fn``, ``train.train_loop``).

Blob format:
  <prefix>_imu.npy      (N, 72)  root-local IMU features, float32
  <prefix>_sum_imu.npy  (N, 18)  scaled acc-sum features
  <prefix>_s.npy        (N, 131) [108 two-axis pose, 3 root vel, n_sbps*4 SBP]
  <prefix>_info.npy     (M, 3)   [start_frame, end_frame, downsample] segments
"""

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class PackedDataset:
    imu: np.ndarray                 # (N, 72)
    acc_sum: Optional[np.ndarray]   # (N, 18) or None
    s: np.ndarray                   # (N, state_dim)
    info: np.ndarray                # (M, 3)

    @classmethod
    def load(cls, imu_path: str, s_path: str, info_path: str,
             with_acc_sum: bool = True) -> "PackedDataset":
        return cls(
            imu=np.load(imu_path, mmap_mode="r"),
            acc_sum=(np.load(imu_path.replace("imu", "sum_imu"),
                             mmap_mode="r") if with_acc_sum else None),
            s=np.load(s_path, mmap_mode="r"),
            info=np.asarray(np.load(info_path)),
        )

    @classmethod
    def from_prefix(cls, prefix: str, with_acc_sum: bool = True):
        return cls.load(prefix + "_imu.npy", prefix + "_s.npy",
                        prefix + "_info.npy", with_acc_sum=with_acc_sum)


def sample_epoch_indices(info: np.ndarray, seq_len: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Window-end indices for one epoch: per segment [start, end, rate] the
    candidate ends are start+seq_len .. end-2; round(n / rate) of them (at
    least 1) are drawn without replacement; then all are shuffled."""
    out = []
    for start, end, rate in info.astype(np.int64):
        lo, hi = start + seq_len, end - 1
        n = hi - lo
        if n <= 0:
            continue
        k = max(int(round(n / rate)), 1)
        out.append(rng.choice(np.arange(lo, hi), size=min(k, n),
                              replace=False))
    idx = np.concatenate(out) if out else np.zeros((0,), np.int64)
    rng.shuffle(idx)
    return idx


def gather_batch(ds: PackedDataset, ends: np.ndarray, seq_len: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x_imu (B,T,72[+18]), x_s (B,T,sd), y (B,T,sd)) for end indices:
    x_s the teacher-forced history s[t-T:t], y the targets s[t-T+1:t+1]."""
    win = ends[:, None] + np.arange(-seq_len, 0)            # (B, T)
    x_imu = ds.imu[win]
    if ds.acc_sum is not None:
        x_imu = np.concatenate([x_imu, ds.acc_sum[win]], axis=-1)
    return (np.ascontiguousarray(x_imu, np.float32),
            np.ascontiguousarray(ds.s[win], np.float32),
            np.ascontiguousarray(ds.s[win + 1], np.float32))


def epoch_batches(ds: PackedDataset, seq_len: int, batch_size: int,
                  rng: np.random.Generator, drop_remainder: bool = True
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """One epoch of shuffled batches. As in tip_tpu the trailing partial
    batch is dropped unless ``drop_remainder=False``."""
    idx = sample_epoch_indices(ds.info, seq_len, rng)
    n_full = len(idx) // batch_size
    for b in range(n_full):
        yield gather_batch(ds, idx[b * batch_size:(b + 1) * batch_size],
                           seq_len)
    if not drop_remainder and len(idx) % batch_size:
        yield gather_batch(ds, idx[n_full * batch_size:], seq_len)


@dataclasses.dataclass(frozen=True)
class DeviceDataset:
    """Packed blobs resident on the device (float32)."""
    imu: torch.Tensor                 # (N, 72)
    acc_sum: Optional[torch.Tensor]   # (N, 18) or None
    s: torch.Tensor                   # (N, state_dim)


def to_device(ds: PackedDataset, device) -> DeviceDataset:
    """Copy the blobs to ``device`` once."""
    def put(a):
        if a is None:
            return None
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return DeviceDataset(imu=put(ds.imu), acc_sum=put(ds.acc_sum),
                         s=put(ds.s))


def device_gather(dds: DeviceDataset, ends: torch.Tensor, seq_len: int):
    """``gather_batch`` on the device: (B,) int64 end indices -> windows."""
    win = ends[:, None] + torch.arange(-seq_len, 0, device=ends.device)
    x_imu = dds.imu[win]
    if dds.acc_sum is not None:
        x_imu = torch.cat([x_imu, dds.acc_sum[win]], dim=-1)
    return x_imu, dds.s[win], dds.s[win + 1]


# ---------------------------------------------------------------------------
# on-device epoch sampling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WindowSampler:
    """The static candidate table from which ``device_sample_epoch`` draws
    an epoch's window ends on the device (tip_tpu's ``WindowSampler``, the
    same integers).

    The distribution is ``sample_epoch_indices``'s: per segment k_i =
    clamp(round(n_i / downsample), 1, n_i) of its n_i candidate ends drawn
    uniformly without replacement, then a global shuffle. The layout
    depends only on the segment table: the candidates of a segment are one
    contiguous block, and ``keep`` marks the first k_i positions of each.
    """
    cands: torch.Tensor    # (N_tot,) int64: the valid ends, segment-ordered
    seg_id: torch.Tensor   # (N_tot,) int64: the segment of each candidate
    keep: torch.Tensor     # (N_tot,) bool: position in its segment < k_i
    n_select: int          # sum(k_i): the windows an epoch can draw


def make_window_sampler(info: np.ndarray, seq_len: int,
                        device=None) -> WindowSampler:
    """The sampler's tables from the segment table, once, on ``device``
    (``cuda`` unless the caller asks for another)."""
    from tip_tpu_torch import resolve_device
    device = resolve_device(device)
    cands, seg_id, keep = [], [], []
    sid = 0
    for start, end, rate in np.asarray(info).astype(np.int64):
        lo, hi = start + seq_len, end - 1
        n = hi - lo
        if n <= 0:
            continue
        k = min(max(int(round(n / rate)), 1), n)
        cands.append(np.arange(lo, hi))
        seg_id.append(np.full(n, sid))
        keep.append(np.arange(n) < k)
        sid += 1

    def put(parts, dtype):
        a = (np.concatenate(parts) if parts else np.zeros((0,), dtype))
        return torch.as_tensor(a.astype(dtype), device=device)

    keep_t = put(keep, bool)
    return WindowSampler(cands=put(cands, np.int64),
                         seg_id=put(seg_id, np.int64), keep=keep_t,
                         n_select=int(sum(int(k.sum()) for k in keep)))


def device_sample_epoch(sampler: WindowSampler, generator: torch.Generator,
                        n_batches: int, batch_size: int) -> torch.Tensor:
    """(n_batches, batch_size) int64 window ends drawn on the sampler's
    device from ``generator`` (on that device), with no host sync;
    ValueError when the epoch needs more windows than the sampler has.

    tip_tpu's two stages: (1) a random order within each segment, a uniform
    key r per candidate sorted by (seg_id, r): torch has no lexsort, so a
    stable sort by r and then a stable sort by seg_id; each segment stays
    its static block, so ``keep`` (its first k_i positions) picks k_i of
    n_i uniformly without replacement. (2) A global shuffle of the kept
    candidates (a second key, 2.0 for the others, so they sort last),
    truncated to the epoch's batch grid. The stream is torch's, not
    jax.random's: the distribution is the same.
    """
    need = n_batches * batch_size
    if need > sampler.n_select:
        raise ValueError(f"the epoch needs {need} windows, the sampler has "
                         f"{sampler.n_select}")
    dev = sampler.cands.device
    r = torch.rand(sampler.cands.shape, generator=generator, device=dev)
    by_r = torch.argsort(r, stable=True)
    order = by_r[torch.argsort(sampler.seg_id[by_r], stable=True)]
    vals = sampler.cands[order]
    r2 = torch.rand(vals.shape, generator=generator, device=dev)
    pick = torch.argsort(torch.where(sampler.keep, r2, r2.new_full((), 2.0)),
                         stable=True)
    return vals[pick[:need]].reshape(n_batches, batch_size)
