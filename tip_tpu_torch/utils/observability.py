"""Structured metrics (own copy of the part of
tip_tpu/utils/observability.py that training uses)."""

import json
import os
import time
from typing import IO


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
