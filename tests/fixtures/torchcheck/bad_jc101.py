"""JC101 fixture: guarded-field access outside its lock.

`Store` uses explicit ``# guarded-by:`` annotations; `Tally` has none
and exercises the inference path (>= 5 accesses, >= 80% under one
lock, an unlocked WRITE reports). `_locked_helper` proves the
entry-contract propagation: every call site holds the lock, so its
bare access is clean.
"""
import threading


class Store:
    def __init__(self):
        self._lock = threading.Lock()
        self.items = {}                     # guarded-by: _lock
        self.count = 0                      # guarded-by: _lock

    def good_put(self, k, v):
        with self._lock:
            self.items[k] = v
            self.count += 1

    def bad_read(self):
        return len(self.items)              # JC101 (read outside lock)

    def bad_write(self):
        self.count += 1                     # JC101 (write outside lock)

    def _locked_helper(self):
        # clean: every call site holds _lock (entry contract)
        self.count -= 1

    def drain(self):
        with self._lock:
            self._locked_helper()
            self.items.clear()

    def snapshot(self):
        # justified: racy sampled read, staleness is acceptable
        return self.count   # torchcheck: disable=JC101


class Tally:
    """No annotations: the majority-locked pattern is inferred."""

    def __init__(self):
        self._mu = threading.Lock()
        self.total = 0

    def add(self, x):
        with self._mu:
            self.total += x

    def sub(self, x):
        with self._mu:
            self.total -= x

    def double(self):
        with self._mu:
            self.total *= 2

    def read(self):
        with self._mu:
            return self.total

    def racy_reset(self):
        self.total = 0                      # JC101 (inferred guarded-by)
