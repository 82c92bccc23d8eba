"""JC204 fixture: event-vocabulary drift.

Emissions with a literal event name are checked against
`telemetry.lifecycle.EVENTS`/`FLEET_EVENTS` at lint time: unknown
names, literal fields outside the event's schema (required +
documented-optional + envelope), and missing required fields all
report. A ``**splat`` waives only the missing-required check (the
fields are not statically knowable); the suppression pragma waives a
reviewed exception.
"""


class BadEmitter:
    def __init__(self, log):
        self._log = log

    def unknown_event(self, rid):
        self._log.emit("teleported", request_id=rid)      # JC204 (name)

    def extra_field(self, rid):
        self._log.emit("admitted", request_id=rid,  # JC204 (extra field)
                       vibe="good")

    def missing_required(self, rid):
        self._log.emit("chunk", request_id=rid, k=0)      # JC204 (missing)

    def splat_ok(self, rid, fields):
        self._log.emit("chunk", request_id=rid, **fields)   # clean

    def clean_emit(self, rid):
        self._log.emit("queued", request_id=rid,
                       reason="boundary")                   # clean

    def waived_emit(self, rid):
        self._log.emit("warped", request_id=rid)  # torchcheck: disable=JC204
