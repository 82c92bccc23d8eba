"""Span flight recorder: the last N timed spans, always on, O(N) forever.

The reference's tracing story was wall-clock log lines
(`coordination_ros.cpp:113-118`); the trial driver's ``profile_dir``
takes opt-in `torch.profiler` captures. Between "nothing" and "a full profiler trace"
sits the flight recorder: a bounded ring of the most recent spans
(name, wall start, duration, attrs) that costs two list writes per span
and can be dumped after the fact — when a soak goes sideways, the last
1024 spans ARE the incident timeline, no foresight required.

Wraparound drops the OLDEST spans (and counts the drops loudly in
`dropped`): a flight recorder that refuses new evidence once full would
record the boring startup and miss the crash.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
import signal
import threading
import time
from typing import Optional

__all__ = ["Span", "FlightRecorder", "SpanDump", "install_crash_dump"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One timed block. ``seq`` is assigned by the recorder (global
    order survives the ring wraparound)."""

    name: str
    t_wall: float            # wall-clock start (epoch seconds)
    dur_s: float
    attrs: dict = dataclasses.field(default_factory=dict)
    seq: int = -1

    def to_row(self) -> dict:
        row = {"span": self.name, "seq": self.seq,
               "t_wall": self.t_wall, "dur_s": self.dur_s}
        if self.attrs:
            row["attrs"] = dict(self.attrs)
        return row


class FlightRecorder:
    """Thread-safe bounded span ring (newest ``capacity`` retained)."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self._cap = int(capacity)
        self._ring: list[Optional[Span]] = []
        self._next = 0
        self._seq = 0
        self._dropped = 0
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def recorded(self) -> int:
        """Total spans ever recorded (retained + dropped)."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def record(self, span: Span) -> Span:
        with self._lock:
            stamped = dataclasses.replace(span, seq=self._seq)
            self._seq += 1
            if len(self._ring) < self._cap:
                self._ring.append(stamped)
            else:
                self._ring[self._next] = stamped
                self._dropped += 1
            self._next = (self._next + 1) % self._cap
            return stamped

    def spans(self) -> list[Span]:
        """Retained spans, oldest first (seq-ordered across wraparound)."""
        with self._lock:
            items = [s for s in self._ring if s is not None]
        return sorted(items, key=lambda s: s.seq)

    def to_rows(self) -> list[dict]:
        """Retained spans as plain rows, oldest first (the dump/export
        shape)."""
        return [s.to_row() for s in self.spans()]

    def clear(self) -> None:
        with self._lock:
            self._ring = []
            self._next = 0
            self._dropped = 0


# ---------------------------------------------------------------------------
# crash dump: the ring must outlive the process that recorded it

class SpanDump:
    """Flush handle for one recorder: dump the span ring to a JSONL
    file on demand, at interpreter exit, and on SIGTERM — so the last
    ~N spans survive a dying process instead of dying with it
    (docs/OBSERVABILITY.md §swarmtrace). A SIGKILL cannot be caught;
    the worker-death path covers that case by flushing from the
    supervisor when it declares a worker dead.

    Appends are line-buffered JSONL: a crash mid-dump costs at most the
    line being written (readers drop a torn trailing line). Each dump
    is prefixed with a census header naming the reason, so multiple
    flushes of one incident stay attributable."""

    def __init__(self, recorder: FlightRecorder, path, log=None):
        self.recorder: Optional[FlightRecorder] = recorder
        self.path = path
        self.log = log
        self._lock = threading.Lock()
        self._dead = False
        self.dumps = 0
        self.drops = 0           # recorder drop count at the last dump:
        #                          the span-loss census a postmortem of
        #                          the dump file can trust (the ring may
        #                          be gone with the process by then)
        # set by install_crash_dump when a SIGTERM hook was chained:
        # (our handler object, the disposition it replaced) — uninstall
        # restores `prev` when ours is still the installed handler
        self._sigterm: Optional[tuple] = None

    def dump(self, reason: str) -> int:
        """Append the current ring (returns span count; -1 on an OS
        refusal, logged loudly — a failed dump must not raise into a
        signal/atexit context)."""
        with self._lock:
            if self._dead or self.recorder is None:
                return 0
            rows = self.recorder.to_rows()
            self.drops = self.recorder.dropped
            header = {"span_dump": reason, "t_wall": time.time(),
                      "pid": os.getpid(), "spans": len(rows),
                      "recorded": self.recorder.recorded,
                      "dropped": self.drops}
            try:
                with open(self.path, "a") as f:
                    f.write(json.dumps(header, sort_keys=True) + "\n")
                    for row in rows:
                        f.write(json.dumps(row, sort_keys=True) + "\n")
                self.dumps += 1
                return len(rows)
            except OSError as e:
                if self.log is not None:
                    self.log.warning("span crash dump to %s failed (%s)"
                                     " — the ring dies with the process",
                                     self.path, e)
                return -1

    def uninstall(self) -> None:
        """Disarm this handle (clean close): the atexit hook is
        unregistered, the recorder reference is released (a long-lived
        process creating many journaled services must not retain N
        dead span rings), and — when our SIGTERM hook is still the
        installed handler — the previous disposition is restored so
        the handler chain does not grow without bound. A hook buried
        mid-chain (someone installed after us) stays as a pass-through
        no-op; that is the best an un-unchainable signal API allows."""
        with self._lock:
            self._dead = True
            self.recorder = None
            sig = self._sigterm
            self._sigterm = None
        atexit.unregister(self._atexit)
        if sig is not None:
            ours, prev = sig
            try:
                if signal.getsignal(signal.SIGTERM) is ours:
                    signal.signal(signal.SIGTERM, prev)
            except ValueError:
                pass            # not the main thread: leave the chain

    def _atexit(self) -> None:
        self.dump("atexit")


def install_crash_dump(recorder: FlightRecorder, path, log=None
                       ) -> SpanDump:
    """Arm a `SpanDump` for ``recorder``: flush on interpreter exit
    and (when installing from the main thread — signal handlers are a
    main-thread privilege) on SIGTERM, chaining any previous handler so
    supervisors layering their own shutdown hooks keep them."""
    handle = SpanDump(recorder, path, log=log)
    atexit.register(handle._atexit)
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            handle.dump("SIGTERM")
            if callable(prev):
                prev(signum, frame)
            elif prev is signal.SIG_IGN:
                # the host explicitly chose to survive SIGTERM; dump
                # and honor that choice — never convert SIG_IGN into
                # process death
                return
            else:
                # restore the default disposition and re-deliver so the
                # process still dies of SIGTERM (exit status intact)
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)
        handle._sigterm = (_on_term, prev)
    except ValueError:
        # not the main thread: atexit + the worker-death flush still
        # cover the ring; only the SIGTERM hook is unavailable
        if log is not None:
            log.debug("span crash dump: SIGTERM hook unavailable off "
                      "the main thread; atexit flush armed")
    return handle
