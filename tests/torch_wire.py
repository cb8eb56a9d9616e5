"""In-process peers of the imu_bridge wire protocol (42 ascii floats a
frame: per sensor a quaternion xyzw, then its acc) for the port's live I/O
tests and chip_smoke.py: frames from a 72-float feature stream, a replay
server, a line client of the serve daemon and a lockstep driver of it.
numpy, scipy and the standard library only; every wait has a deadline.
"""

import json
import socket
import threading
import time

import numpy as np
from scipy.spatial.transform import Rotation

DEADLINE_S = 60.0


def wire_frames(imu) -> np.ndarray:
    """(T, 72) feature rows (6 rotation matrices ++ 6 accs) -> (T, 42)
    float32 wire frames."""
    imu = np.asarray(imu, np.float64)
    T = len(imu)
    q = Rotation.from_matrix(imu[:, :54].reshape(-1, 3, 3)).as_quat()
    return np.concatenate([q.reshape(T, 6, 4), imu[:, 54:].reshape(T, 6, 3)],
                          axis=2).reshape(T, 42).astype(np.float32)


def wire_text(frame42) -> str:
    """One frame as the wire sends it, 9 significant digits: each value
    parses back to the same float32."""
    return " ".join(f"{v:.9g}" for v in
                    np.asarray(frame42, np.float32).tolist()) + " "


def wait_until(pred, what: str, timeout: float = DEADLINE_S,
               poll: float = 1e-3):
    """Poll ``pred`` until it holds; raise with ``what`` at the deadline."""
    t_end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > t_end:
            raise TimeoutError(f"timed out after {timeout:g} s waiting for "
                               f"{what}")
        time.sleep(poll)


def join(thread: threading.Thread, what: str, timeout: float = 10.0):
    thread.join(timeout)
    if thread.is_alive():
        raise TimeoutError(f"{what} did not end within {timeout:g} s")


class ReplayServer:
    """A one-client-at-a-time TCP server on a free localhost port that
    streams wire frames at ``hz``: frame i is ``source(i)`` (42 floats), or
    ``frames[i % len(frames)]``. Counts the frames sent in ``sent``."""

    def __init__(self, frames=None, hz: float = 60.0, source=None):
        self._source = source or (lambda i: frames[i % len(frames)])
        self.hz = hz
        self.sent = 0
        self._stop = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen()
        self._srv.settimeout(0.1)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                conn.settimeout(5.0)
                t0, i = time.perf_counter(), 0
                while not self._stop.is_set():
                    try:
                        conn.sendall(wire_text(self._source(i)).encode())
                    except OSError:
                        break
                    i += 1
                    self.sent += 1
                    sleep = t0 + i / self.hz - time.perf_counter()
                    if sleep > 0:
                        time.sleep(sleep)

    def stop(self):
        self._stop.set()
        join(self._thread, "the replay server")
        self._srv.close()


class LineClient:
    """A client of the serve daemon: reads the greeting, sends wire frames,
    reads jsonl lines. Socket operations time out after ``timeout``.
    ``sock``: a socket already connected to the daemon, in place of a new
    connection."""

    def __init__(self, port: int, timeout: float = DEADLINE_S, sock=None):
        if sock is None:
            sock = socket.create_connection(("127.0.0.1", port),
                                            timeout=timeout)
        self.sock = sock
        self.sock.settimeout(timeout)
        self._buf = b""
        self.hello = json.loads(self.read_line())
        self.slot = self.hello.get("slot")

    def read_line(self) -> bytes:
        while b"\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("the daemon closed the connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return line

    def send(self, frame42):
        self.sock.sendall(wire_text(frame42).encode())

    def close(self):
        self.sock.close()


def start_accepting(daemon) -> threading.Thread:
    """Run a ServeDaemon's accept loop without its ticker (lockstep
    driving: the caller ticks with ``_tick_once``)."""
    daemon._running = True
    thread = threading.Thread(target=daemon._accept_loop, daemon=True)
    thread.start()
    return thread


def stop_accepting(daemon, thread: threading.Thread):
    """Stop a daemon started by ``start_accepting`` and join its accept
    loop. The listening socket is shut down first: tip_tpu's daemon only
    closes it, which does not wake an accept() blocked in another
    thread."""
    try:
        daemon._srv.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    daemon.stop()
    join(thread, "the accept loop")


def lockstep_tick(daemon, parse, sends, timeout: float = DEADLINE_S):
    """One lockstep tick: each (client, frame42) of ``sends`` sends its
    frame; once every frame sits in its client's slot of the daemon (as
    ``parse`` of the wire text gives it), the daemon ticks once and each
    client reads its line. Returns the lines, in the order of ``sends``."""
    for client, frame in sends:
        client.send(frame)
    for client, frame in sends:
        want = parse(np.array(wire_text(frame).split(), dtype=float))

        def arrived(slot=client.slot, want=want):
            with daemon._lock:
                c = daemon._clients.get(slot)
            got = None if c is None else c.input.read()
            return got is not None and np.array_equal(got, want)
        wait_until(arrived, f"slot {client.slot}'s frame", timeout)
    daemon._tick_once(daemon._batch)
    return [json.loads(client.read_line()) for client, _ in sends]


def wait_dropped(daemon, pool, slot: int, timeout: float = DEADLINE_S):
    """Wait until the daemon has dropped the client of ``slot`` and freed
    the slot in its pool."""
    def gone():
        with daemon._lock:
            return slot not in daemon._clients and not pool.active[slot]
    wait_until(gone, f"slot {slot} freed", timeout)


def client_load(port: int, frames, slow: int, slow_rcvbuf: int,
                slow_lines: int, results, seconds: float = 300.0):
    """Clients of a running serve daemon, for another process than the
    daemon's: one socket a stream of ``frames`` (a list of (T, 42)
    arrays), each pushing a frame at 60 Hz and reading its lines. Client
    ``slow`` has a ``slow_rcvbuf`` receive buffer and stops reading once
    it has read ``slow_lines`` lines. Puts ("queued",)
    on ``results`` once every socket sits in the daemon's listen backlog
    (the daemon may start accepting then), ("connected", slots) once every
    client has its greeting, then, when the daemon has closed every socket
    read or ``seconds`` have passed, ("done", lines a client, non-finite
    (client, t) pairs)."""
    import selectors
    socks, slots, bufs = [], [], []
    for i in range(len(frames)):
        s = socket.socket()
        if i == slow:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, slow_rcvbuf)
        s.settimeout(DEADLINE_S)
        s.connect(("127.0.0.1", port))
        socks.append(s)
    results.put(("queued",))
    for s in socks:
        buf = b""
        while b"\n" not in buf:
            buf += s.recv(1 << 16)
        hello, buf = buf.split(b"\n", 1)
        slots.append(json.loads(hello)["slot"])
        bufs.append(buf)
    results.put(("connected", slots))
    t0 = time.perf_counter()
    stop = threading.Event()

    def push():
        k = 0
        while not stop.is_set():
            for i, s in enumerate(socks):
                try:
                    s.sendall(wire_text(frames[i][k % len(frames[i])])
                              .encode())
                except OSError:
                    pass
            k += 1
            sleep = t0 + k / 60.0 - time.perf_counter()
            if sleep > 0:
                time.sleep(sleep)
    pusher = threading.Thread(target=push, daemon=True)
    pusher.start()
    sel = selectors.DefaultSelector()
    for i, s in enumerate(socks):
        s.setblocking(False)
        sel.register(s, selectors.EVENT_READ, i)
    n_lines, bad = [0] * len(socks), []
    open_socks = set(range(len(socks)))
    while open_socks and time.perf_counter() - t0 < seconds:
        if slow in open_socks and n_lines[slow] >= slow_lines:
            sel.unregister(socks[slow])          # stops reading
            open_socks.discard(slow)
        for key, _ in sel.select(0.05):
            i = key.data
            try:
                chunk = key.fileobj.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                chunk = b""
            if not chunk:
                sel.unregister(key.fileobj)
                open_socks.discard(i)
                continue
            *lines, bufs[i] = (bufs[i] + chunk).split(b"\n")
            for ln in lines:
                msg = json.loads(ln)
                n_lines[i] += 1
                if not np.isfinite(msg["qdq"]).all():
                    bad.append((i, msg["t"]))
    stop.set()
    join(pusher, "the pusher")
    for s in socks:
        s.close()
    results.put(("done", n_lines, bad))
