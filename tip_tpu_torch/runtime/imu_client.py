"""TCP client for live IMU frames (the consumer side of native/imu_bridge;
copy of tip_tpu/runtime/imu_client.py).

Replaces the reference's IMUSet (live_demo_new.py:72-139). Two deliberate
fixes over the reference:

  * the reader thread publishes frames through a seqlock-style slot (version
    counter incremented around the write) instead of an unsynchronised
    attribute — readers retry on a torn read, keeping latest-wins sampling
    without the benign-but-real data race (SURVEY.md §5);
  * the wire quaternions are converted once into rotation matrices here, so
    consumers always see the 72-float feature layout.
"""

import socket
import threading
from typing import Optional

import numpy as np
from scipy.spatial.transform import Rotation

N_IMUS = 6
FLOATS_PER_FRAME = N_IMUS * 7       # quat(4) + acc(3) per sensor


def parse_wire_frame(vals: np.ndarray) -> np.ndarray:
    """One wire frame (42 floats: per sensor quat xyzw + acc) -> the 72-float
    feature layout (6 rotation matrices ++ 6 accs). Single source of truth
    for the wire format — shared by IMUClient and the serve daemon."""
    qa = vals.reshape(N_IMUS, 7)
    r = Rotation.from_quat(qa[:, :4]).as_matrix()      # xyzw wire quats
    return np.concatenate([r.reshape(-1), qa[:, 4:].reshape(-1)])


def drain_wire_frames(data: str, sink) -> str:
    """Feed every complete space-separated frame in ``data`` to
    sink(frame72); returns the unconsumed tail of the buffer."""
    parts = data.split(" ", FLOATS_PER_FRAME)
    while len(parts) == FLOATS_PER_FRAME + 1:
        sink(parse_wire_frame(np.array(parts[:-1], dtype=float)))
        data = parts[-1]
        parts = data.split(" ", FLOATS_PER_FRAME)
    return data


class SeqlockSlot:
    """Single-writer latest-value slot with torn-read detection."""

    def __init__(self, width: int):
        self._buf = np.zeros(width)
        self._version = 0           # even = stable, odd = writing

    def write(self, value: np.ndarray):
        self._version += 1          # -> odd
        self._buf[:] = value
        self._version += 1          # -> even

    def read(self) -> Optional[np.ndarray]:
        for _ in range(8):
            v0 = self._version
            if v0 == 0:
                return None
            if v0 % 2:
                continue
            out = self._buf.copy()
            if self._version == v0:
                return out
        return self._buf.copy()     # contended; latest-wins anyway


class IMUClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 27015):
        self.host, self.port = host, port
        self._slot = SeqlockSlot(72)
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.frames_received = 0

    def _read_loop(self):
        def sink(frame72):
            self._slot.write(frame72)
            self.frames_received += 1

        data = ""
        while self._running:
            try:
                chunk = self._sock.recv(1024).decode("ascii")
            except OSError:
                break
            if not chunk:
                break
            data = drain_wire_frames(data + chunk, sink)

    def start(self):
        assert self._thread is None, "already reading"
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.connect((self.host, self.port))
        self._running = True
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def stop(self):
        if self._thread is not None:
            self._running = False
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
            self._thread.join(timeout=2.0)
            self._thread = None

    def current_reading(self) -> Optional[np.ndarray]:
        """Latest (72,) frame: 6x rotation matrix + 6x acc; None before the
        first frame arrives."""
        return self._slot.read()
