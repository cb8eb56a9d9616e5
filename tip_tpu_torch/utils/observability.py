"""Structured metrics, latency histograms, and profiler hooks (twin of
tip_tpu/utils/observability.py).

jsonl metric records, streaming latency percentiles (p50 is the product's
north-star metric), and a torch.profiler trace context in place of
tip_tpu's jax.profiler one.
"""

import contextlib
import json
import os
import time
from typing import IO, Optional

import numpy as np
import torch


class MetricsWriter:
    """Append-only jsonl metric stream with wall-clock stamps."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f: IO = open(path, "a", buffering=1)
        self._t0 = time.time()

    def write(self, **record):
        record.setdefault("wall_s", round(time.time() - self._t0, 3))
        self._f.write(json.dumps(record) + "\n")

    def close(self):
        self._f.close()


class LatencyHistogram:
    """Fixed-capacity reservoir of frame latencies with percentile summary."""

    def __init__(self, capacity: int = 4096):
        self._buf = np.zeros(capacity)
        self._n = 0
        self._capacity = capacity

    def record(self, seconds: float):
        i = self._n % self._capacity
        self._buf[i] = seconds
        self._n += 1

    def summary(self) -> dict:
        n = min(self._n, self._capacity)
        if n == 0:
            return {"count": 0}
        lat_ms = self._buf[:n] * 1e3
        return {
            "count": self._n,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p90_ms": float(np.percentile(lat_ms, 90)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "max_ms": float(lat_ms.max()),
        }

    @contextlib.contextmanager
    def timed(self):
        t0 = time.perf_counter()
        yield
        self.record(time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace of the block (the host, and the card when CUDA
    is available), written as a Chrome trace ``*.pt.trace.json`` under
    ``log_dir`` when the block ends; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
