"""JC201 fixture: journal-write-after-promise.

The durable done-frame must land BEFORE the client-visible
``_resolve`` — a crash between a premature reply and its journal
record is a silently lost request (the client saw a terminal the
recovery cannot reconstruct). The report lands on the DURABLE line
(the append that arrived too late). A ``return``/``raise`` between
the two is a path barrier: reply-and-bail on one path, journal on
another, is clean.
"""


def _write_frame(path, payload, manifest):
    return path, payload, manifest


class BadFinisher:
    def reply_before_journal(self, job, result):
        job.ticket._resolve(result)
        _write_frame("done", result, {})        # JC201 (append after reply)

    def journal_then_reply_ok(self, job, result):
        _write_frame("done", result, {})
        job.ticket._resolve(result)             # clean: durable first

    def barrier_ok(self, job, result):
        if job.rejected:
            job.ticket._resolve(result)
            return                              # path ends here
        _write_frame("done", result, {})        # clean: other path
