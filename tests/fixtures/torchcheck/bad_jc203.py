"""JC203 fixture: terminal state reachable twice.

A terminal once-guard is a flag TEST (bail if already terminal)
followed by a flag COMMIT. Unless both sit under one held lock, two
racing resolvers (worker vs recovery vs wire reader) can both pass the
check-then-act window and publish different terminal results. The
report lands on the TEST line. A guard with no commit in the same
function is an early-bail, not a race.
"""
import threading


class RacyTicket:
    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._resolve_lock = threading.Lock()

    def racy_resolve(self, result):
        if self._done.is_set():          # JC203 (test+commit unlocked)
            return
        self._result = result
        self._done.set()

    def locked_resolve_ok(self, result):
        with self._resolve_lock:
            if self._done.is_set():
                return                   # clean: one critical section
            self._result = result
            self._done.set()

    def guard_only_ok(self):
        if self._done.is_set():
            return True                  # clean: no commit here
        return False


class RacyJob:
    def racy_finish(self, job, outcome):
        if job.finished:                 # JC203 (flag store races)
            return
        job.outcome = outcome
        job.finished = True              # torchcheck: disable=JC202

    def locked_finish_ok(self, job, lock, outcome):
        with lock:
            if job.finished:
                return                   # clean: shared lock
            job.outcome = outcome
            job.finished = True          # torchcheck: disable=JC202
