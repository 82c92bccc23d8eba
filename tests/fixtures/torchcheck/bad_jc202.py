"""JC202 fixture: state transition without a lifecycle event.

A ``_jobs`` map mutation or a ``status``/``finished`` store in a scope
(function body or except-handler body) with no schema'd emission in
that same scope is a journal-invisible state change — the postmortem
reconstructs it as a gap or a loss. Emissions count when made directly
OR through a call into a (transitively) emitting helper. Constructors
are pre-protocol and exempt.
"""


class BadService:
    def __init__(self):
        self._jobs = {}                  # clean: ctor is pre-protocol
        self._log = None

    def silent_drop(self, rid):
        self._jobs.pop(rid, None)        # JC202 (no emission in scope)

    def silent_status(self, job):
        job.status = "failed"            # JC202 (store never journaled)

    def journaled_drop(self, rid, job):
        self._jobs.pop(rid, None)        # clean: emission in same scope
        self._journal_event("resolved", job, status="failed", chunks=0)

    def silent_handler(self, rid, job):
        try:
            self._journal_event("queued", job, reason="boundary")
        except OSError:
            del self._jobs[rid]          # JC202 (handler scope is silent)

    def helper_emits_ok(self, rid, job):
        self._jobs[rid] = job            # clean: _note() emits for us
        self._note(job)

    def _note(self, job):
        self._journal_event("admitted", job)

    def _journal_event(self, event, job, **fields):
        return event, job, fields
