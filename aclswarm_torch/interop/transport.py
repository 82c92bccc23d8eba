"""Host message transport (a copy of `aclswarm_tpu/interop/transport.py`):
the native shared-memory ring, and a TCP socket presenting the same
channel API for off-host peers.

What crosses the host boundary — operator dispatches, planner outputs,
serve requests, telemetry to a recorder or a ROS bridge process — moves
over named SPSC shared-memory rings
(`native/shmring.cpp`): one ring per directed channel, length-prefixed
frames, lock-free, bounded (write returns False on backpressure instead of
silently dropping — the reference's "queue size 1 but don't want to lose
any" bid subscriptions, `coordination_ros.cpp:417-418`, made explicit).

`SocketChannel` / `SocketListener` extend the same contract past the
host boundary: one duplex TCP stream carrying the
identical length-prefixed frames, non-blocking, with a bounded outbound
buffer so a peer that stops draining turns into explicit backpressure
(``send_bytes`` -> False) instead of a blocked writer — the serve wire
front end (`aclswarm_torch.serve.wire`) layers its slow-loris and
reconnect-storm hardening on exactly these two observables
(`queued_bytes`, `stalled_recv_s`). The payload bytes on the wire are
byte-for-byte what the shm ring carries: same codec records, same CRC,
one versioning surface.

The shm `Channel` requires the native library (``make -C native``) and
raises RuntimeError otherwise — there is deliberately no slow Python
fallback for a component whose reason to exist is being out of Python's
way. The socket transport is pure stdlib and always available.
"""
from __future__ import annotations

import ctypes as C
import errno
import select
import socket
import threading
import time

from aclswarm_torch.interop import codec
from aclswarm_torch.interop import native as nat

DEFAULT_CAPACITY = 1 << 20  # 1 MiB per channel


class Channel:
    """One directed message channel (≈ one ROS topic between two hosts).

    The creating side owns the shm object (``create=True``); the peer opens
    it by name. Either side may write or read, but the ring is
    single-producer single-consumer: exactly one writer process and one
    reader process per channel, like a directed topic edge.
    """

    def __init__(self, name: str, create: bool = False,
                 capacity: int = DEFAULT_CAPACITY):
        lib = nat.load()
        if lib is None:
            raise RuntimeError(
                "native transport needs native/build/libaclswarm_native.so "
                "(run: make -C native)")
        self._lib = lib
        self.name = name if name.startswith("/") else "/" + name
        self._h = lib.asw_ring_open(self.name.encode(), capacity,
                                    1 if create else 0)
        if not self._h:
            raise OSError(f"cannot {'create' if create else 'open'} ring "
                          f"{self.name}")
        self._owner = create
        # the creator dictates the size; openers read the true capacity
        # from the shm control block (their `capacity` arg is ignored)
        self._capacity = int(lib.asw_ring_capacity(self._h))
        self._buf = (C.c_uint8 * self._capacity)()
        # one REUSABLE view over the receive buffer: recv_bytes snapshots
        # through it (one copy, ctypes -> bytes) instead of the old
        # ctypes -> numpy -> bytes double hop
        self._view = memoryview(self._buf)

    def send(self, msg) -> bool:
        """Encode + enqueue one wire message; False on backpressure."""
        return self.send_bytes(codec.encode(msg))

    def send_bytes(self, frame: bytes) -> bool:
        """False means the ring is momentarily full (backpressure — retry
        after draining). A frame that can NEVER fit raises instead, so a
        retry loop can't spin forever."""
        if len(frame) + 8 > self._capacity:
            raise ValueError(
                f"frame of {len(frame)} bytes can never fit channel "
                f"{self.name} (capacity {self._capacity}); create the "
                f"channel with a larger capacity")
        # zero-copy handoff: the ring write only READS the frame, so a
        # pointer cast into the immutable bytes object replaces the old
        # from_buffer_copy staging allocation
        ptr = C.cast(C.c_char_p(frame), C.POINTER(C.c_uint8))
        return self._lib.asw_ring_write(self._h, ptr, len(frame)) == 0

    def recv(self):
        """Dequeue + decode one message, or None if the channel is empty."""
        b = self.recv_bytes()
        return None if b is None else codec.decode(b)

    def recv_bytes(self) -> bytes | None:
        n = self._lib.asw_ring_read(self._h, self._buf, len(self._buf))
        if n == 0:
            return None
        if n < 0:
            raise OSError(f"ring {self.name}: corrupt or oversized message")
        # the buffer is reused on the next read, so the result must be a
        # snapshot — one slice-copy through the persistent view
        return bytes(self._view[:n])

    @property
    def queued_bytes(self) -> int:
        return int(self._lib.asw_ring_used(self._h))

    def close(self, unlink: bool | None = None):
        """Unmap the ring; the owner also unlinks the shm object unless
        ``unlink=False`` (used by tests to simulate a crashed owner — a
        later ``create`` reclaims such stale objects)."""
        if self._h:
            do_unlink = self._owner if unlink is None else unlink
            self._lib.asw_ring_close(self._h, 1 if do_unlink else 0)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_when_ready(name: str, grace_s: float = 5.0,
                    poll_s: float = 0.005) -> "Channel":
    """Open a peer-created ring, polling until the creator has
    registered the shm object (the wire-handshake shape: a client
    creates its connection rings THEN announces them on the control
    ring, but shm visibility and the announcement are not ordered
    across processes). Raises OSError after ``grace_s``, and the error
    names WHICH failure happened: a ring that never appeared (the peer
    never started — look at the peer's launch), versus a ring that
    appeared but stayed unopenable (the peer started, then died or
    left a corrupt object mid-handshake — look at the peer's crash).
    The old message blamed the handshake for both, sending every
    never-launched-peer hunt to the wrong log."""
    import pathlib

    from aclswarm_torch.utils.retry import poll_until

    out: list = []
    # shm_open objects surface under /dev/shm on Linux: existence is
    # the "appeared" signal even while the open itself keeps failing
    shm_path = pathlib.Path("/dev/shm") / (name if not name.startswith("/")
                                           else name[1:])
    seen = [shm_path.exists()]

    def _try() -> bool:
        seen[0] = seen[0] or shm_path.exists()
        try:
            out.append(Channel(name, create=False))
            return True
        except OSError:
            seen[0] = seen[0] or shm_path.exists()
            return False

    if not poll_until(_try, grace_s=grace_s, poll_s=poll_s):
        if seen[0]:
            raise OSError(
                f"ring {name} appeared but could not be opened within "
                f"{grace_s:g} s (peer created it, then died or left it "
                "corrupt mid-handshake)")
        raise OSError(f"ring {name} never appeared within {grace_s:g} s "
                      "(peer process never started, or never created "
                      "its rings)")
    return out[0]


# ---------------------------------------------------------------------------
# TCP socket transport (off-host peers)

# framing: u32 little-endian payload length, then the payload — the
# same shape the shm ring uses internally, so a frame is a frame on
# either transport
_LEN = 4
MAX_FRAME = 1 << 24             # 16 MiB: far above any codec record;
#                                 a bigger length prefix is corruption,
#                                 not a big message (ring parity: raise)
DEFAULT_SOCK_BUFFER = 1 << 20   # bounded outbound buffer (ring parity)


class SocketChannel:
    """One duplex TCP stream presenting the shm `Channel` frame API.

    Non-blocking by construction: ``send_bytes`` appends to a BOUNDED
    outbound buffer and opportunistically flushes (False = the buffer
    is full — the peer stopped draining; explicit backpressure, exactly
    like a full ring), ``recv_bytes`` returns one complete frame or
    None. Two extra observables exist for the wire front end's
    adversarial-client hardening:

    - `queued_bytes` — undrained outbound bytes (a client that never
      reads accumulates here until the bound, then sends fail);
    - `stalled_recv_s` — age of the oldest INCOMPLETE inbound frame (a
      slow-loris peer trickling one byte at a time shows up as a
      partial frame that never completes).

    A closed/reset peer or a corrupt length prefix raises OSError, the
    same contract as a corrupt ring: the connection is unrecoverable,
    the caller declares the peer gone.

    Thread-safety: unlike the shm rings (one per direction, one writer
    each), ONE duplex socket carries both directions — a wire client's
    submit path and its reader thread both write (submits, pings,
    flushes). An internal lock serializes every outbound-buffer
    mutation; the inbound buffer stays single-consumer.
    """

    def __init__(self, sock: socket.socket, name: str, *,
                 max_frame: int = MAX_FRAME,
                 max_buffer: int = DEFAULT_SOCK_BUFFER):
        self.name = name
        self._sock = sock
        self._max_frame = int(max_frame)
        self._max_buffer = int(max_buffer)
        self._rx = bytearray()
        self._tx = bytearray()
        self._tx_lock = threading.Lock()
        self._rx_partial_since: float | None = None
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass                       # not a TCP socket (tests/pipes)

    # ------------------------------------------------------------- send

    def send_bytes(self, frame: bytes) -> bool:
        """Enqueue one frame; False on backpressure (outbound buffer at
        its bound with the peer not draining). A frame that can NEVER
        fit raises instead, so a retry loop can't spin forever."""
        if len(frame) + _LEN > min(self._max_frame, self._max_buffer):
            # ring parity: a frame that can NEVER fit raises — both the
            # protocol bound (max_frame) and the outbound buffer bound
            # (a frame larger than max_buffer would return False
            # forever, the exact spin this ValueError exists to stop)
            raise ValueError(
                f"frame of {len(frame)} bytes can never fit channel "
                f"{self.name} (max_frame {self._max_frame}, "
                f"max_buffer {self._max_buffer})")
        with self._tx_lock:
            if len(self._tx) + _LEN + len(frame) > self._max_buffer:
                self._flush_locked()
                if len(self._tx) + _LEN + len(frame) > self._max_buffer:
                    return False
            self._tx += len(frame).to_bytes(_LEN, "little")
            self._tx += frame
            self._flush_locked()
        return True

    def flush(self) -> bool:
        """Push buffered outbound bytes to the socket without blocking;
        True when the buffer fully drained."""
        with self._tx_lock:
            return self._flush_locked()

    def _flush_locked(self) -> bool:
        while self._tx:
            try:
                n = self._sock.send(self._tx)
            except BlockingIOError:
                return False
            except OSError as e:
                raise OSError(f"socket {self.name}: send failed "
                              f"({e})") from e
            if n <= 0:
                return False
            del self._tx[:n]
        return True

    # ------------------------------------------------------------- recv

    def recv_bytes(self) -> bytes | None:
        """Dequeue one complete frame, or None. Reads from the kernel
        only until a frame is READY — a peer flooding small frames
        cannot balloon the inbound buffer past ~one read chunk while
        the consumer pops one frame per call (TCP flow control takes
        over once we stop reading); a peer that closed or reset raises
        OSError."""
        self.flush()                   # opportunistic outbound progress
        while not self._frame_ready():
            try:
                chunk = self._sock.recv(1 << 16)
            except BlockingIOError:
                break
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    break
                raise OSError(f"socket {self.name}: recv failed "
                              f"({e})") from e
            if not chunk:
                raise OSError(f"socket {self.name}: peer closed the "
                              "connection")
            self._rx += chunk
        return self._pop_frame()

    def _frame_ready(self) -> bool:
        if len(self._rx) < _LEN:
            return False
        ln = int.from_bytes(self._rx[:_LEN], "little")
        if ln + _LEN > self._max_frame:
            return True                # corrupt: let _pop_frame raise
        return len(self._rx) >= _LEN + ln

    def _pop_frame(self) -> bytes | None:
        if len(self._rx) < _LEN:
            self._note_partial(bool(self._rx))
            return None
        ln = int.from_bytes(self._rx[:_LEN], "little")
        if ln + _LEN > self._max_frame:
            raise OSError(f"socket {self.name}: corrupt or oversized "
                          f"frame (length prefix {ln})")
        if len(self._rx) < _LEN + ln:
            self._note_partial(True)
            return None
        frame = bytes(self._rx[_LEN:_LEN + ln])
        del self._rx[:_LEN + ln]
        # a COMPLETED frame resets the stall clock even when more
        # bytes follow: stalled_recv_s means "oldest incomplete frame",
        # not "oldest busy stretch" — an honest high-throughput client
        # completing frames every pass must never age into the
        # slow-loris bound
        self._rx_partial_since = None
        self._note_partial(bool(self._rx))
        return frame

    def _note_partial(self, partial: bool) -> None:
        if not partial:
            self._rx_partial_since = None
        elif self._rx_partial_since is None:
            self._rx_partial_since = time.monotonic()

    # ------------------------------------------------------- observables

    @property
    def queued_bytes(self) -> int:
        return len(self._tx)

    @property
    def stalled_recv_s(self) -> float:
        """Seconds the oldest incomplete inbound frame has been waiting
        (0.0 with no partial frame pending) — the slow-loris clock."""
        if self._rx_partial_since is None:
            return 0.0
        return time.monotonic() - self._rx_partial_since

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SocketListener:
    """Accept-rate-bounded TCP listener handing out `SocketChannel`s.

    ``accept()`` is non-blocking and consumes one token from a refilling
    bucket (``accept_rate`` per second, burst ``accept_burst``): a
    reconnect storm beyond the rate waits in the kernel backlog instead
    of monopolizing the dispatcher, and backlog overflow is the kernel
    refusing connections — bounded at every layer, never an unbounded
    accept loop (`throttled` counts the deferrals)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 accept_rate: float = 64.0, accept_burst: int = 16,
                 backlog: int = 64):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(backlog)
        self._sock.setblocking(False)
        self.address = self._sock.getsockname()
        self._rate = float(accept_rate)
        self._burst = max(1, int(accept_burst))
        self._tokens = float(self._burst)
        self._t_last = time.monotonic()
        self.throttled = 0             # accepts deferred by the bound

    def accept(self) -> SocketChannel | None:
        """One pending connection as a `SocketChannel`, or None (none
        pending, or the accept-rate bound says not yet)."""
        now = time.monotonic()
        self._tokens = min(float(self._burst),
                           self._tokens + (now - self._t_last) * self._rate)
        self._t_last = now
        if self._tokens < 1.0:
            # count a deferral only when a connection is actually
            # waiting — an idle listener polled with an empty bucket
            # throttled nothing (the gauge must mean what it says)
            try:
                ready, _, _ = select.select([self._sock], [], [], 0)
            except (OSError, ValueError):
                ready = []
            if ready:
                self.throttled += 1
            return None
        try:
            sock, addr = self._sock.accept()
        except BlockingIOError:
            return None
        except OSError:
            return None
        self._tokens -= 1.0
        return SocketChannel(sock, f"tcp:{addr[0]}:{addr[1]}")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect_when_ready(host: str, port: int, grace_s: float = 5.0,
                       poll_s: float = 0.02) -> SocketChannel:
    """Connect to a serve TCP endpoint, polling through the listener's
    startup window. Like `open_when_ready`, the raised OSError names
    WHICH failure happened: nothing ever listened (connection refused
    throughout — the server never started) versus a connection that was
    accepted and then lost mid-handshake (the server started, then
    died)."""
    from aclswarm_torch.utils.retry import poll_until

    out: list = []
    # ECONNREFUSED throughout = nothing ever listened; any OTHER
    # failure (reset, timeout after a SYN was taken) = something was
    # there and went away — two different postmortems
    seen_listener = [False]

    def _try() -> bool:
        # close-on-every-failed-exit is STRUCTURAL (try/finally), not
        # per-branch: a refused-then-retried connect storm runs this
        # dozens of times, and any exit path that skipped the close —
        # a settimeout error, a failed SocketChannel wrap — would leak
        # one fd per attempt until the process hits its rlimit
        # (regression: tests/test_interop.py fd-count over 50 refusals)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        handed_off = False
        try:
            s.settimeout(max(poll_s, 0.05))
            try:
                s.connect((host, port))
            except OSError as e:
                if e.errno != errno.ECONNREFUSED:
                    seen_listener[0] = True
                return False
            out.append(SocketChannel(s, f"tcp:{host}:{port}"))
            handed_off = True
            return True
        finally:
            if not handed_off:
                s.close()

    if not poll_until(_try, grace_s=grace_s, poll_s=poll_s):
        if seen_listener[0]:
            raise OSError(
                f"tcp {host}:{port} answered and then dropped the "
                f"connection within {grace_s:g} s (server started, then "
                "died mid-handshake?)")
        raise OSError(f"tcp {host}:{port} refused every connection for "
                      f"{grace_s:g} s (no server ever listening — was "
                      "it started?)")
    return out[0]


def send_bytes_reliable(channel: "Channel", frame: bytes,
                        grace_s: float = 1.0, poll_s: float = 0.001,
                        log=None, what: str = "frame") -> bool:
    """Raw-frame form of `send_reliable`: bounded retry through
    backpressure, loud drop after the grace. THE single home for the
    bounded-send loop — the codec path (`send_reliable`) and the serve
    wire front end (`aclswarm_torch.serve.wire`) both layer on this, so
    backpressure semantics evolve in one place.

    The loop itself lives in the unified retry layer
    (`aclswarm_torch.utils.retry.poll_until`): fixed
    poll cadence — an SPSC ring drains on its own, backoff would only
    add dispatch latency — against a hard grace deadline."""
    from aclswarm_torch.utils.retry import poll_until

    if poll_until(lambda: channel.send_bytes(frame), grace_s=grace_s,
                  poll_s=poll_s):
        return True
    if log is not None:
        log.warning("DROPPED %s on %s after %ss backpressure",
                    what, channel.name, grace_s)
    return False


def send_reliable(channel: "Channel", msg, grace_s: float = 1.0,
                  poll_s: float = 0.001, log=None) -> bool:
    """Send with bounded retry through backpressure; a drop after the
    grace period is loud. The 'queue size 1 but don't want to lose any'
    intent of the reference's subscriptions (`coordination_ros.cpp
    :417-418`) — shared by the bridge daemon and the shm planner client
    for frames that must not vanish (formation commits, KILL broadcasts,
    one-shot assignments)."""
    return send_bytes_reliable(channel, codec.encode(msg),
                               grace_s=grace_s, poll_s=poll_s, log=log,
                               what=type(msg).__name__)
