"""Multi-stream TCP serving daemon: many live IMU clients on one card
(twin of tip_tpu/runtime/serve_daemon.py).

Production-serving counterpart of the single-stream live demo
(cli/live_demo): each TCP client speaks the imu_bridge wire protocol
(ascii floats, 6 sensors x quat+acc = 42 per frame — the reference's Xsens
bridge format, live_demo_new.py:85-127) and is assigned a StreamPool slot;
one 60 Hz batched pool tick serves every connected client, and each client
receives its predicted pose back as a jsonl line per tick.

Frames are expected pre-calibrated (bone-frame, like live_demo
--skip_calibration); heading/T-pose calibration is a per-sensor-rig concern
that belongs on the client side of the wire.

Threading model: one reader thread per client publishing latest-wins frames
through a SeqlockSlot (no locks on the hot path), a single ticker loop
stepping the pool, and best-effort non-blocking writes back to clients (a
slow client drops responses, never stalls the tick).

Locks are taken in one order: the daemon's membership lock ``_lock``, then
``StreamPool._carries_lock`` (``_drop`` removes a stream under ``_lock``).
The ticker therefore releases ``_lock`` before it steps the pool. The
accept threads' ``add_stream`` makes a carry on the card; every thread
launches on its current stream, which is the default stream for each of
them, so a slot written by an accept thread is ordered with the ticks.
A tick copies the pool's poses to the host once (one sync).
"""

import json
import select
import socket
import threading
import time
from typing import Dict, Optional

import numpy as np

from tip_tpu_torch import constants as cst
from tip_tpu_torch.runtime.imu_client import SeqlockSlot, drain_wire_frames
from tip_tpu_torch.runtime.serving import StreamPool

# Per-client outgoing byte budget. A client that stops reading fills its
# kernel TCP buffer, then this; past it, whole response lines are DROPPED
# (latest-wins telemetry — a resumed reader re-syncs on the next tick).
MAX_OUTBUF = 1 << 16


class _Client:
    def __init__(self, conn: socket.socket, slot: int):
        self.conn = conn
        self.slot = slot
        self.input = SeqlockSlot(72)
        self.alive = True
        # outgoing buffer: only the tick thread touches it (no lock); keeps
        # jsonl framing intact across partial non-blocking sends
        self.outbuf = bytearray()
        self.dropped = 0

    def send_line(self, line: bytes) -> bool:
        """Best-effort non-blocking send. Queues the whole line (or drops it
        when the buffer is full), then flushes what the socket accepts.
        Returns False when the connection is dead."""
        if len(self.outbuf) + len(line) <= MAX_OUTBUF:
            self.outbuf += line
        else:
            self.dropped += 1
        while self.outbuf:
            try:
                n = self.conn.send(self.outbuf)
            except (BlockingIOError, InterruptedError):
                break                      # kernel buffer full — try next tick
            except OSError:
                return False
            if n <= 0:
                break
            del self.outbuf[:n]
        return True


class ServeDaemon:
    """TCP front-end over a StreamPool."""

    def __init__(self, pool: StreamPool, s_init: np.ndarray,
                 host: str = "127.0.0.1", port: int = 27100,
                 hz: float = 1.0 / cst.DT, log=print,
                 sndbuf: Optional[int] = None):
        self.pool = pool
        self.s_init = np.asarray(s_init, np.float32)
        self.hz = hz
        self.log = log
        # optional SO_SNDBUF cap for accepted sockets: bounds how much a
        # non-reading client can absorb in the kernel before send_line
        # starts dropping (also makes the drop path testable)
        self.sndbuf = sndbuf
        self._clients: Dict[int, _Client] = {}     # slot -> client
        self._lock = threading.Lock()              # membership only
        self._running = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen()
        self.port = self._srv.getsockname()[1]
        self.ticks = 0
        # persistent tick batch; identity orientations for empty slots
        self._idle = np.zeros(72, np.float32)
        self._idle[0] = self._idle[4] = self._idle[8] = 1.0
        self._batch = np.tile(self._idle, (pool.capacity, 1))

    # -- client side ---------------------------------------------------------

    def _reader(self, client: _Client):
        # the client socket is non-blocking (the tick thread writes it too);
        # wait for readability with select instead of a blocking recv
        data = ""
        conn = client.conn
        while self._running and client.alive:
            try:
                ready, _, _ = select.select([conn], [], [], 0.25)
            except (OSError, ValueError):
                break
            if not ready:
                continue
            try:
                chunk = conn.recv(4096).decode("ascii")
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                break
            if not chunk:
                break
            data = drain_wire_frames(data + chunk, client.input.write)
        self._drop(client)

    def _drop(self, client: _Client):
        with self._lock:
            if self._clients.get(client.slot) is client:
                del self._clients[client.slot]
                self.pool.remove_stream(client.slot)
                # reset the slot's tick-batch row: a NEW client on this
                # recycled slot must not be warmed up on the departed
                # client's last frame (torn row writes are harmless — the
                # slot is inactive until re-add, which resets the carry)
                self._batch[client.slot] = self._idle
        client.alive = False
        try:
            client.conn.close()
        except OSError:
            pass

    def _accept_loop(self):
        while self._running:
            try:
                conn, addr = self._srv.accept()
            except OSError:
                break
            try:
                slot = self.pool.add_stream(self.s_init)
            except RuntimeError:
                try:
                    conn.sendall(b'{"error": "pool full"}\n')
                except OSError:
                    pass
                conn.close()
                continue
            if self.sndbuf:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                self.sndbuf)
            client = _Client(conn, slot)
            # greeting FIRST, registration after: once the client is in
            # _clients a concurrent tick may send_line() on the socket, which
            # would interleave a qdq line with (or ahead of) the hello the
            # protocol promises as the first line — and briefly block the
            # tick thread on the still-blocking socket
            try:
                conn.sendall((json.dumps({"slot": slot}) + "\n").encode())
            except OSError:
                # client vanished before the greeting: free the slot and
                # keep accepting (an uncaught raise here would kill the
                # accept thread and leak the slot forever)
                with self._lock:
                    self.pool.remove_stream(slot)
                    self._batch[slot] = self._idle
                client.alive = False
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            # non-blocking from here on: tick-thread writes must never stall
            # the 60 Hz loop on a slow reader (send_line drops instead)
            conn.setblocking(False)
            with self._lock:
                self._clients[slot] = client
            threading.Thread(target=self._reader, args=(client,),
                             daemon=True).start()
            self.log(f"client {addr} -> slot {slot} "
                     f"({self.pool.n_active} active)")

    # -- tick loop -----------------------------------------------------------

    def _tick_once(self, batch: np.ndarray):
        # rows are filled UNDER the membership lock: a _drop racing a
        # stale snapshot could otherwise repollute the idle row it just
        # reset, and the departed client's last frame would leak into the
        # next occupant's warmup (the invariant DEPLOY.md promises)
        with self._lock:
            clients = list(self._clients.values())
            for c in clients:
                frame = c.input.read()
                if frame is not None:
                    batch[c.slot] = frame
        out = self.pool.step(batch)
        qdq = out["qdq"].cpu().numpy()
        for c in clients:
            line = (json.dumps({"t": self.ticks,
                                "qdq": np.round(qdq[c.slot], 5).tolist()})
                    + "\n").encode()
            if not c.send_line(line):
                self._drop(c)
        self.ticks += 1

    def run(self, seconds: Optional[float] = None,
            max_consecutive_failures: int = 30):
        self._running = True
        threading.Thread(target=self._accept_loop, daemon=True).start()
        batch = self._batch
        dt = 1.0 / self.hz
        t_end = time.time() + seconds if seconds else None
        fails = 0
        try:
            while self._running and (t_end is None or time.time() < t_end):
                t0 = time.perf_counter()
                try:
                    self._tick_once(batch)
                    fails = 0
                except Exception as e:          # noqa: BLE001 — keep serving
                    # a failed tick rebuilds the pool state (StreamPool.step
                    # rebuilds its carries); log, back off (a persistent error
                    # must not spin+log at 60 Hz), and give up after a run of
                    # failures — that's a misconfig, not a transient
                    fails += 1
                    self.log(f"tick {self.ticks} failed ({e!r}); "
                             f"pool rebuilt, sessions restarted "
                             f"({fails} consecutive)")
                    if fails >= max_consecutive_failures:
                        self.log(f"{fails} consecutive tick failures; "
                                 "shutting down")
                        break
                    time.sleep(min(dt * (2 ** min(fails, 6)), 2.0))
                sleep = dt - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(sleep)
        finally:
            self.stop()

    def stop(self):
        self._running = False
        try:
            # shutdown wakes an accept() blocked in another thread (close
            # alone does not on Linux)
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            clients = list(self._clients.values())
        for c in clients:
            self._drop(c)
