"""JC103 fixture: blocking calls under a service-tier lock.

The lock's OrderedLock family starts with ``serve.`` which marks it
service-tier regardless of module path. `_flush` has one locked and
one unlocked call site, so the report lands on the locked CALL SITE
(the entry-held intersection is empty); `_fsync_always_locked` is
entry-held, so the report lands on the primitive itself. ``cv.wait()``
on the condition you hold is the CV protocol and stays quiet.

The alias cases bind the blocking callable to a local name first
(``w = evt.wait``; ``f = os.fsync``) — the call site then carries no
attribute to match, so the binding site supplies the identity. The
queue case types ``q`` from its stdlib ctor: bare ``.get`` is not in
the method catalog (every dict read would match), only queue-typed
receivers report, and only in the blocking form.
"""
import os
import queue
import threading
import time

from aclswarm_torch.utils.locks import OrderedLock


class Service:
    def __init__(self, sock, fd):
        self._lock = OrderedLock("serve.fixture")
        self._cv = threading.Condition()
        self._evt = threading.Event()
        self._sock = sock
        self._fd = fd

    def bad_sleep(self):
        with self._lock:
            time.sleep(0.1)                 # JC103 (sleep under lock)

    def bad_send(self, payload):
        with self._lock:
            self._sock.sendall(payload)     # JC103 (socket under lock)

    def bad_wait(self):
        with self._lock:
            self._evt.wait(1.0)             # JC103 (event wait under lock)

    def bad_transitive(self):
        with self._lock:
            self._flush()                   # JC103 (call into fsync path)

    def flush_unlocked(self):
        self._flush()                       # clean: no lock held

    def _flush(self):
        os.fsync(self._fd)

    def always_locked_sync(self):
        with self._lock:
            self._fsync_always_locked()

    def _fsync_always_locked(self):
        # entry-held under the service lock: the primitive reports
        os.fsync(self._fd)                  # JC103 (fsync entry-held)

    def good_outside(self, payload):
        with self._lock:
            data = payload
        self._sock.sendall(data)            # clean: lock released first

    def cv_wait_ok(self):
        with self._cv:
            self._cv.wait(0.5)              # clean: waiting releases cv

    def suppressed_send(self, payload):
        # justified: single-writer socket with a bounded frame size
        with self._lock:
            self._sock.sendall(payload)  # torchcheck: disable=JC103

    def bad_alias_wait(self):
        w = self._evt.wait
        with self._lock:
            w(1.0)                          # JC103 (aliased event wait)

    def bad_alias_fsync(self):
        f = os.fsync
        with self._lock:
            f(self._fd)                     # JC103 (aliased fsync)

    def bad_queue_get(self):
        q = queue.Queue()
        with self._lock:
            return q.get(timeout=1.0)       # JC103 (queue get under lock)

    def queue_get_nonblocking_ok(self):
        q = queue.Queue()
        with self._lock:
            try:
                return q.get(block=False)   # clean: returns immediately
            except queue.Empty:
                return None

    def alias_rebound_ok(self):
        w = self._evt.wait
        w = self._make_payload              # rebound: no longer blocking
        with self._lock:
            return w()                      # clean

    def _make_payload(self):
        return b""
