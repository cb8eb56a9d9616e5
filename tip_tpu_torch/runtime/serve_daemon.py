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

Threading model: two threads, whatever the number of clients. The I/O
thread ("serve-io", ``_accept_loop``) waits on one selector holding the
listening socket and every client socket: it accepts and greets clients
and parses their frames into a latest-wins SeqlockSlot per client (no
locks on the hot path). The ticker ("serve-tick", the thread that calls
``run``) steps the pool, encodes every client's line in one pass and
writes it back best-effort and non-blocking (a slow client drops
responses, never stalls the tick). Each op of a tick (a launch, a send)
hands the interpreter lock over, and a thread that takes it then holds
the ticker up; so the two take turns (``_take_turn``): the I/O thread
handles an event only between ticks, a tick waits for the event in hand
(each wait at most a tick's period), and an accept, whose add_stream
takes milliseconds, waits for the next tick where it would run into it.
tip_tpu's daemon runs a reader thread a client (its tick is one jitted
dispatch).

Locks are taken in one order: the daemon's membership lock ``_lock``, then
``StreamPool._carries_lock`` (``_drop`` removes a stream under ``_lock``).
The ticker therefore releases ``_lock`` before it steps the pool. The I/O
thread's ``add_stream`` makes a carry on the card while reads wait; every
thread launches on its current stream, which is the default stream for
each of them, so a slot written by the I/O thread is ordered with the
ticks. A tick copies the pool's poses to the host once (one sync).

The I/O thread alone registers sockets with its selector. The ticker may
close a client's socket (``_drop`` after a failed send) while it is still
registered: epoll forgets a closed descriptor but the selector's map keeps
it, so before each registration the I/O thread unregisters the sockets of
dropped clients, whose numbers a new socket may reuse.
"""

import functools
import json
import selectors
import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from tip_tpu_torch import constants as cst
from tip_tpu_torch.runtime.imu_client import SeqlockSlot, drain_wire_frames
from tip_tpu_torch.runtime.serving import StreamPool

# Per-client outgoing byte budget. A client that stops reading fills its
# kernel TCP buffer, then this; past it, whole response lines are DROPPED
# (latest-wins telemetry — a resumed reader re-syncs on the next tick). A
# line is about 1.1 KB (114 values with 5 decimals), so the budget holds
# about 58 lines; tip_tpu's lines of float32 reprs (about 2.4 KB) fill it in
# about 27.
MAX_OUTBUF = 1 << 16


@functools.lru_cache(maxsize=None)
def _line_format(width: int) -> bytes:
    return (b'{"t": %d, "qdq": [' + b", ".join([b"%.5f"] * width)
            + b"]}\n")


def encode_lines(t: int, rows: np.ndarray) -> List[bytes]:
    """The jsonl line of tick ``t`` for each row of poses:
    ``{"t": t, "qdq": [...]}``. Each value is rounded to 5 places as
    tip_tpu's daemon rounds it (``np.round`` in the rows' dtype), then
    written with 5 decimals: float64 rows read back as tip_tpu's values,
    float32 rows within 5e-6 of them. A row with a non-finite value is
    written by ``json.dumps`` (``NaN``, ``Infinity``, ``-Infinity``)."""
    rounded = np.round(rows, 5)
    finite = np.isfinite(rounded).all(axis=1)
    fmt = _line_format(rows.shape[1])
    lines = []
    for row, ok in zip(rounded.astype(np.float64).tolist(), finite):
        if ok:
            lines.append(fmt % (t, *row))
        else:
            lines.append((json.dumps({"t": t, "qdq": row}) + "\n").encode())
    return lines


def _unregister(sel: selectors.BaseSelector, sock: socket.socket):
    """Unregister ``sock`` if it is registered. The selector finds a socket
    that another thread closed by identity."""
    try:
        sel.unregister(sock)
    except (KeyError, ValueError):
        pass


class _Client:
    def __init__(self, conn: socket.socket, slot: int):
        self.conn = conn
        self.slot = slot
        self.input = SeqlockSlot(72)
        # wire text received but not yet a whole frame (the I/O thread's)
        self.text = ""
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
        # the ticker and the I/O thread take turns (module docstring): set
        # between ticks, and while the I/O thread handles no event
        self._between_ticks = threading.Event()
        self._between_ticks.set()
        self._io_idle = threading.Event()
        self._io_idle.set()
        self._next_tick = float("inf")     # run()'s next tick, perf_counter
        self._accept_s = 0.0               # the last add_stream's seconds
        self._running = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen()
        self._srv.setblocking(False)
        self.port = self._srv.getsockname()[1]
        self.ticks = 0
        # persistent tick batch; identity orientations for empty slots
        self._idle = np.zeros(72, np.float32)
        self._idle[0] = self._idle[4] = self._idle[8] = 1.0
        self._batch = np.tile(self._idle, (pool.capacity, 1))

    # -- the I/O thread ------------------------------------------------------

    def _accept_loop(self):
        """The I/O thread: accepts, greets and reads every client through
        one selector until stop(); then drops the clients it read."""
        sel = selectors.DefaultSelector()
        try:
            sel.register(self._srv, selectors.EVENT_READ)
        except (OSError, ValueError):      # stopped before the loop began
            sel.close()
            return
        try:
            while self._running:
                for key, _ in sel.select(0.25):
                    self._take_turn(accept=key.data is None)
                    try:
                        if key.data is None:
                            self._accept(sel)
                        else:
                            self._read(sel, key.data)
                    finally:
                        self._io_idle.set()
        finally:
            for key in list(sel.get_map().values()):
                if key.data is not None:
                    self._drop(key.data)
            sel.close()

    def _take_turn(self, accept: bool):
        """Wait for the tick in progress to end (a frame read during a
        tick would only feed the next one), at most a tick's period; an
        accept whose add_stream would run into the next tick (or the
        overdue one) waits for that tick too. Then hold the next tick off
        until the event is handled."""
        if accept:
            ahead = self._next_tick - time.perf_counter()
            if ahead < self._accept_s:
                time.sleep(max(ahead, 0.0) + 1e-3)
        self._between_ticks.wait(1.0 / self.hz)
        self._io_idle.clear()

    def _accept(self, sel: selectors.BaseSelector):
        try:
            conn, addr = self._srv.accept()
        except (BlockingIOError, InterruptedError, ConnectionAbortedError):
            return
        except OSError:
            # the listening socket is shut (stop) or failing: accept no
            # more, but go on reading the clients (tip_tpu's accept thread
            # ends so, and its readers go on)
            _unregister(sel, self._srv)
            return
        t0 = time.perf_counter()
        try:
            slot = self.pool.add_stream(self.s_init)
        except RuntimeError:
            try:
                conn.sendall(b'{"error": "pool full"}\n')
            except OSError:
                pass
            conn.close()
            return
        self._accept_s = time.perf_counter() - t0
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
            # keep accepting (an uncaught raise here would end the I/O
            # thread and leak the slot forever)
            with self._lock:
                self.pool.remove_stream(slot)
                self._batch[slot] = self._idle
            client.alive = False
            try:
                conn.close()
            except OSError:
                pass
            return
        # non-blocking from here on: tick-thread writes must never stall
        # the 60 Hz loop on a slow reader (send_line drops instead)
        conn.setblocking(False)
        # sockets the ticker closed may hold this one's number in the map
        for key in list(sel.get_map().values()):
            if key.data is not None and not key.data.alive:
                _unregister(sel, key.fileobj)
        with self._lock:
            self._clients[slot] = client
        sel.register(conn, selectors.EVENT_READ, client)
        self.log(f"client {addr} -> slot {slot} "
                 f"({self.pool.n_active} active)")

    def _read(self, sel: selectors.BaseSelector, client: _Client):
        try:
            chunk = client.conn.recv(4096)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:                    # reset, or closed by the ticker
            chunk = b""
        if not chunk:
            _unregister(sel, client.conn)
            self._drop(client)
            return
        try:
            client.text = drain_wire_frames(
                client.text + chunk.decode("ascii"), client.input.write)
        except ValueError as e:
            # non-ascii bytes or a token that is not a float: stop reading
            # this client only, as tip_tpu's reader thread dies on them. It
            # keeps its slot and its last frame, and still gets its lines
            _unregister(sel, client.conn)
            self.log(f"slot {client.slot}: malformed input ({e!r}); "
                     f"no longer read")

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

    # -- tick loop -----------------------------------------------------------

    def _fill(self, batch: np.ndarray) -> List[_Client]:
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
        return clients

    def _send(self, clients: List[_Client], lines: List[bytes]):
        for c, line in zip(clients, lines):
            if not c.send_line(line):
                self._drop(c)

    def _tick_once(self, batch: np.ndarray):
        self._between_ticks.clear()
        try:
            self._io_idle.wait(1.0 / self.hz)     # the event in hand
            clients = self._fill(batch)
            qdq = self.pool.step(batch)["qdq"].cpu().numpy()
            self._send(clients, encode_lines(
                self.ticks, qdq[[c.slot for c in clients]]))
            self.ticks += 1
        finally:
            self._between_ticks.set()

    def run(self, seconds: Optional[float] = None,
            max_consecutive_failures: int = 30):
        """Serve until stop() or ``seconds``: the calling thread ticks
        (named "serve-tick" meanwhile) beside the I/O thread."""
        self._running = True
        threading.Thread(target=self._accept_loop, name="serve-io",
                         daemon=True).start()
        me = threading.current_thread()
        name, me.name = me.name, "serve-tick"
        batch = self._batch
        dt = 1.0 / self.hz
        t_end = time.time() + seconds if seconds else None
        fails = 0
        # ticks start on a grid of dt: a sleep's overshoot, or a tick up to
        # a period late, is taken from the next wait; a tick later than
        # that restarts the grid (no burst of ticks to catch up)
        t_next = self._next_tick = time.perf_counter()
        try:
            while self._running and (t_end is None or time.time() < t_end):
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
                t_next += dt
                t_next = self._next_tick = max(t_next,
                                               time.perf_counter() - dt)
                time.sleep(max(t_next - time.perf_counter(), 0.0))
        finally:
            self._next_tick = float("inf")
            self.stop()
            me.name = name

    def stop(self):
        self._running = False
        try:
            # shutdown wakes the I/O thread's select at once (close alone
            # leaves it to its timeout)
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
