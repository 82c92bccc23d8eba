"""swarmproto — protocol-conformance tier (JC2xx) for the serve
promise/journal/fencing protocol.

Every robustness claim the fleet makes (no journaled loss across a
SIGKILL, no silent loss under overload) rests on an ordering protocol:
req-frame-before-accept, done-frame-before-resolve, incarnation
fencing, requeue-under-lock, terminal-exactly-once. This module makes
the protocol a checked artifact with one source of truth:

1.  A **declarative transition system** over the request lifecycle,
    derived from `telemetry.lifecycle.EVENTS` (the alphabet is cross-
    checked against the vocabulary at import time — adding an event
    without teaching the protocol about it is an ImportError, not a
    silent drift). The linter (here), the model checker
    (`analysis.model`) and the postmortem refinement gate all consume
    THIS table.

2.  A **static conformance lint** (the JC2xx family) over `serve/` +
    `resilience/`, reusing `analysis.lint.Linter`'s module loader,
    call resolution and pragma machinery:

      JC201  journal-write-after-promise — a ticket `_resolve(...)`
             (the client-visible promise) lexically reachable before a
             durable frame append (`_write_frame`/`append_frame`) on
             the same path (no return/raise between them). The
             durable-then-visible order is what makes a crash between
             the two recoverable instead of a silent loss.
      JC202  state-transition-without-lifecycle-event — a `_jobs` map
             mutation or a `status`/`finished` store in a scope
             (function body, or an except-handler body) with no
             schema'd lifecycle emission in that same scope (directly
             or via a call into an emitting helper). A state change
             the journal cannot see is a timeline gap the postmortem
             reports as a loss.
      JC203  terminal-state-reachable-twice — a terminal once-guard
             (test a finished/done flag, bail; later commit the flag)
             whose test and commit are not both under a held lock:
             two racing resolvers can both pass the check-then-act
             window and publish different terminal results.
      JC204  event-vocabulary drift — an emission with an event name
             outside `EVENTS`/`FLEET_EVENTS`, literal fields outside
             the event's schema (required + documented-optional +
             envelope), missing required fields, or (on full sweeps)
             a vocabulary entry with no emission site at all.

Pragmas: the shared `# torchcheck: disable=JC2xx <reason>` /
`disable-file=` escape hatches apply.

CLI:  python -m aclswarm_torch.analysis.protocol [paths...]
      python -m aclswarm_torch.analysis.lint --protocol
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import sys
from pathlib import Path

from .lint import FuncInfo, Linter, ModuleInfo, Violation, _dotted
from ..telemetry import lifecycle

__all__ = ["RULES", "TRANSITIONS", "INITIAL_PHASE", "TERMINAL_PHASE",
           "OPTIONAL_FIELDS", "ENVELOPE_FIELDS", "VOCABULARY",
           "step", "accepts", "accepts_fragment",
           "ProtocolChecker", "check_paths", "default_paths", "main"]

RULES = {
    "JC201": "journal-write-after-promise: durable frame append "
             "reachable after the client-visible resolve on the same "
             "path (promise must follow the journal, never precede it)",
    "JC202": "state-transition-without-lifecycle-event: _jobs/status "
             "mutation with no schema'd emission in the same scope",
    "JC203": "terminal-state-reachable-twice: terminal once-guard "
             "(flag test + commit) not atomic under a lock",
    "JC204": "event-vocabulary drift: emission outside the "
             "lifecycle.EVENTS schema (name, fields) or vocabulary "
             "entry with no emission site",
}

# ---------------------------------------------------------------------------
# schema tables — lifecycle.EVENTS gives the REQUIRED fields; the
# documented optionals (the trailing comments in lifecycle.py) are
# mirrored here and cross-checked so the two files cannot drift apart
# without an import error.

#: Fields every record carries regardless of event kind. ``incarnation``
#: is stamped by `SwarmService._journal_event` on every emission (the
#: fencing witness), the rest by `telemetry.lifecycle.make_event`.
ENVELOPE_FIELDS = frozenset({
    "request_id", "trace_id", "t_wall", "t_mono", "seq", "pid",
    "incarnation",
})

#: Documented-optional fields per event (lifecycle.py's `# + ...`
#: comments, promoted to a checkable table).
OPTIONAL_FIELDS: dict[str, frozenset] = {
    "submitted": frozenset({"deadline_s", "t_submit"}),
    "admitted": frozenset({"queue_depth"}),
    "queued": frozenset(),
    "batched": frozenset({"bucket", "chunk"}),
    "chunk": frozenset({"tick_end", "round"}),
    "preempted": frozenset({"run_chunks"}),
    "checkpointed": frozenset(),
    "migrated": frozenset({"failovers"}),
    "resumed": frozenset({"preemptions"}),
    "deadline": frozenset({"late"}),
    "resolved": frozenset({"latency_s", "preemptions", "failovers",
                           "error_code"}),
    "poisoned": frozenset({"excluded"}),
    "cancelled": frozenset(),
    "failover": frozenset({"retired"}),
    "alert": frozenset({"burn_short", "burn_long", "value"}),
}

#: name -> required-field frozenset, request- and fleet-scope merged.
VOCABULARY: dict[str, frozenset] = {**lifecycle.EVENTS,
                                    **lifecycle.FLEET_EVENTS}

if set(OPTIONAL_FIELDS) != set(VOCABULARY):          # pragma: no cover
    raise ImportError(
        "swarmproto OPTIONAL_FIELDS drifted from lifecycle.EVENTS: "
        f"missing={set(VOCABULARY) - set(OPTIONAL_FIELDS)} "
        f"stale={set(OPTIONAL_FIELDS) - set(VOCABULARY)}")

# ---------------------------------------------------------------------------
# the declarative protocol: request-lifecycle transition system
#
# Phases are the model's abstraction of where a request IS:
#   init      nothing journaled yet
#   accepted  req frame + `submitted` landed (the acceptance promise)
#   pickable  admitted/requeued — in the queue, no worker owns it
#   resident  a worker owns it (batched); chunks/checkpoints stream
#   finishing a terminal verdict (deadline/cancel/poison) is journaled
#             but the `resolved` record has not landed yet
#   terminal  `resolved` landed — the journal's promise is honoured
#
# Crash-at-any-boundary is representable because the table is
# prefix-closed: any prefix of an accepted trace is itself accepted
# (`accepts` distinguishes "valid so far" from "complete"). Fenced
# zombies never appear here at all — their writes are no-ops by
# protocol (property P4 in analysis.model), so an accepted journal
# contains only live-incarnation records.

INITIAL_PHASE = "init"
TERMINAL_PHASE = "terminal"

_TERMINALISH = {"deadline": "finishing", "cancelled": "finishing",
                "poisoned": "finishing", "resolved": "terminal"}

TRANSITIONS: dict[str, dict[str, str]] = {
    "init": {"submitted": "accepted"},
    # the acceptance pair lands back-to-back under the submit path; a
    # torn tail can strand a request here, and close() can resolve it
    "accepted": {"admitted": "pickable", **_TERMINALISH},
    "pickable": {"queued": "pickable",      # requeue markers may repeat
                 "migrated": "pickable",    # failover = requeue marker
                 "batched": "resident",
                 **_TERMINALISH},
    "resident": {"batched": "resident",     # pipelined rounds
                 "chunk": "resident",
                 "checkpointed": "resident",
                 "resumed": "resident",
                 "preempted": "resident",
                 "queued": "pickable",
                 "migrated": "pickable",
                 **_TERMINALISH},
    "finishing": {"checkpointed": "finishing",   # cancel-at-boundary
                  "resolved": "terminal"},
    "terminal": {},                         # terminal-exactly-once
}

# alphabet cross-check: the protocol must speak exactly the request-
# scope vocabulary (fleet events are per-worker, not per-request)
_ALPHABET = {ev for edges in TRANSITIONS.values() for ev in edges}
if _ALPHABET != set(lifecycle.EVENTS):               # pragma: no cover
    raise ImportError(
        "swarmproto TRANSITIONS drifted from lifecycle.EVENTS: "
        f"unmodelled={set(lifecycle.EVENTS) - _ALPHABET} "
        f"unknown={_ALPHABET - set(lifecycle.EVENTS)}")


def step(phase: str, event: str) -> str | None:
    """Successor phase, or None if `event` is illegal in `phase`."""
    return TRANSITIONS.get(phase, {}).get(event)


def accepts(events) -> tuple[bool, str, str | None]:
    """Run a per-request event-name sequence through the protocol.

    Returns ``(ok, final_phase, problem)``: ``ok`` means every step was
    legal (the trace is accepted — possibly incomplete); ``problem``
    names the first offending (phase, event) pair. Completeness is
    ``final_phase == TERMINAL_PHASE``."""
    phase = INITIAL_PHASE
    for i, ev in enumerate(events):
        nxt = step(phase, ev)
        if nxt is None:
            return False, phase, (f"event #{i} '{ev}' illegal in phase "
                                  f"'{phase}'")
        phase = nxt
    return True, phase, None


def accepts_fragment(events) -> tuple[bool, str | None]:
    """Accept a MID-STREAM fragment: valid from *some* phase.

    A process-mode fleet splits one request's history across journals
    (the dir that accepted it, the dir that finished it after a
    migration); each per-journal slice must still be a walk of the
    protocol graph even though it need not start at `init`."""
    phases = set(TRANSITIONS)
    for i, ev in enumerate(events):
        nxt = {p2 for p in phases
               if (p2 := step(p, ev)) is not None}
        if not nxt:
            return False, (f"event #{i} '{ev}' illegal in every "
                           f"reachable phase")
        phases = nxt
    return True, None


# ---------------------------------------------------------------------------
# static conformance lint

_DURABLE_CALLS = {"_write_frame", "append_frame"}
_PROMISE_ATTR = "_resolve"
_JOBMAP_ATTRS = {"_jobs"}
_JOBMAP_MUTATORS = {"pop", "clear", "setdefault", "update", "popitem"}
_STATUS_ATTRS = {"status", "finished"}
_EMIT_FUNNELS = {"_journal_event", "_journal_event_owned"}
_TERMINAL_FLAGS = {"finished", "_done", "done", "resolved"}
_CTORS = {"__init__", "__post_init__", "__new__"}


def _chain(node: ast.AST) -> tuple[str, ...] | None:
    parts = _dotted(node)
    return tuple(parts) if parts else None


def _lockish(expr: ast.AST) -> bool:
    """Heuristic: a `with` context manager that names a lock."""
    parts = _dotted(expr.func if isinstance(expr, ast.Call) else expr)
    if not parts:
        return False
    leaf = parts[-1].lower()
    return any(k in leaf for k in ("lock", "mutex", "guard"))


@dataclasses.dataclass
class _Region:
    """One JC202 scope: a function body or an except-handler body."""
    label: str
    mutations: list = dataclasses.field(default_factory=list)
    emits: bool = False
    calls: list = dataclasses.field(default_factory=list)  # ast.Call


class ProtocolChecker(Linter):
    """JC201-JC204 over the serve/resilience protocol surface."""

    def __init__(self, coverage: bool = False) -> None:
        super().__init__()
        self.coverage = coverage
        self._emission_names: set[str] = set()

    # -- shared helpers -----------------------------------------------------
    @staticmethod
    def _is_emission(call: ast.Call) -> str | None:
        """Literal event name if `call` is a journal emission, else
        None. Covers the service funnels and raw `LifecycleLog.emit`;
        non-literal names (the funnel's own forwarding) are opaque and
        intentionally skipped."""
        func = call.func
        if not isinstance(func, ast.Attribute):
            return None
        if func.attr not in _EMIT_FUNNELS and func.attr != "emit":
            return None
        if not call.args or not isinstance(call.args[0], ast.Constant) \
                or not isinstance(call.args[0].value, str):
            return None
        return call.args[0].value

    @staticmethod
    def _is_emission_like(call: ast.Call) -> bool:
        """Any journal-funnel call, literal-named or forwarded."""
        func = call.func
        return isinstance(func, ast.Attribute) \
            and (func.attr in _EMIT_FUNNELS
                 or (func.attr == "emit" and bool(call.args)
                     and isinstance(call.args[0], ast.Constant)
                     and isinstance(call.args[0].value, str)))

    def _emitting_fixpoint(self) -> set[int]:
        """ids of FuncInfos that (transitively) journal an event —
        JC202's 'a call into this helper counts as an emission'."""
        emits: set[int] = set()
        for mod in self.modules.values():
            for info in mod.funcs:
                for node in self._iter_own_body(info):
                    if isinstance(node, ast.Call) \
                            and self._is_emission_like(node):
                        emits.add(id(info))
                        break
        for _ in range(32):
            changed = False
            for mod in self.modules.values():
                for info in mod.funcs:
                    if id(info) in emits:
                        continue
                    for call, scope in info.calls:
                        parts = _dotted(call.func)
                        if not parts:
                            continue
                        t = self._resolve(mod, parts, scope)
                        if isinstance(t, FuncInfo) and id(t) in emits:
                            emits.add(id(info))
                            changed = True
                            break
            if not changed:
                break
        return emits

    # -- JC201: journal-write-after-promise ---------------------------------
    def _jc201(self, mod: ModuleInfo, info: FuncInfo) -> None:
        promises: list[ast.Call] = []
        durables: list[ast.Call] = []
        barriers: list[int] = []
        for node in self._iter_own_body(info):
            if isinstance(node, (ast.Return, ast.Raise)):
                barriers.append(node.lineno)
            elif isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute) \
                        and func.attr == _PROMISE_ATTR:
                    promises.append(node)
                name = func.attr if isinstance(func, ast.Attribute) \
                    else (func.id if isinstance(func, ast.Name) else None)
                if name in _DURABLE_CALLS:
                    durables.append(node)
        if not promises or not durables:
            return
        for d in durables:
            prior = [p for p in promises if p.lineno < d.lineno]
            for p in prior:
                if any(p.lineno < b < d.lineno for b in barriers):
                    continue
                self._emit(
                    mod, d, "JC201",
                    f"durable frame append at line {d.lineno} is "
                    f"reachable after the promise resolve at line "
                    f"{p.lineno} on the same path — the reply must "
                    f"never precede its journal record")
                break

    # -- JC202: state transition without lifecycle event --------------------
    def _mutation_kind(self, node: ast.AST) -> str | None:
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript):
                    parts = _chain(t.value)
                    if parts and parts[-1] in _JOBMAP_ATTRS:
                        return f"{'.'.join(parts)}[...] store"
                elif isinstance(t, ast.Attribute) \
                        and t.attr in _STATUS_ATTRS:
                    parts = _chain(t)
                    if parts and parts[0] != "self":
                        return f"{'.'.join(parts)} store"
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    parts = _chain(t.value)
                    if parts and parts[-1] in _JOBMAP_ATTRS:
                        return f"del {'.'.join(parts)}[...]"
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _JOBMAP_MUTATORS:
            parts = _chain(node.func.value)
            if parts and parts[-1] in _JOBMAP_ATTRS:
                return f"{'.'.join(parts)}.{node.func.attr}(...)"
        return None

    def _jc202(self, mod: ModuleInfo, info: FuncInfo,
               emitting: set[int]) -> None:
        leaf = info.fq.rsplit(".", 1)[-1]
        if leaf in _CTORS:
            return      # construction is pre-protocol: nothing to journal
        regions: list[_Region] = [_Region("function body")]

        def classify(expr: ast.AST, region: _Region) -> None:
            """Walk one expression tree (no statement bodies inside)."""
            for node in ast.walk(expr):
                if isinstance(node, ast.Lambda):
                    continue
                kind = self._mutation_kind(node)
                if kind is not None:
                    region.mutations.append((node, kind))
                if isinstance(node, ast.Call):
                    if self._is_emission_like(node):
                        region.emits = True
                    else:
                        region.calls.append(node)

        def scan(stmts, region: _Region) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                if isinstance(stmt, ast.Try):
                    scan(stmt.body, region)
                    for h in stmt.handlers:
                        sub = _Region(
                            f"except handler at line {h.lineno}")
                        regions.append(sub)
                        scan(h.body, sub)
                    scan(stmt.orelse, region)
                    scan(stmt.finalbody, region)
                    continue
                # statement-level mutation forms (Assign/Delete)
                kind = self._mutation_kind(stmt)
                if kind is not None:
                    region.mutations.append((stmt, kind))
                # header expressions of compound statements; full
                # expression trees of leaf statements
                if isinstance(stmt, (ast.If, ast.While)):
                    classify(stmt.test, region)
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    classify(stmt.iter, region)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        classify(item.context_expr, region)
                elif isinstance(stmt, ast.Match):
                    classify(stmt.subject, region)
                elif isinstance(stmt, (ast.Assign, ast.AugAssign)):
                    classify(stmt.value, region)
                elif not isinstance(stmt, ast.Delete):
                    for child in ast.iter_child_nodes(stmt):
                        if isinstance(child, ast.expr):
                            classify(child, region)
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if isinstance(sub, list):
                        scan(sub, region)
                if isinstance(stmt, ast.Match):
                    for case in stmt.cases:
                        scan(case.body, region)

        if isinstance(info.node, ast.Lambda):
            return
        scan(list(info.node.body), regions[0])
        for region in regions:
            if not region.mutations or region.emits:
                continue
            if any(isinstance(t := self._resolve(
                    mod, _dotted(c.func) or [], info), FuncInfo)
                    and id(t) in emitting for c in region.calls):
                continue
            node, kind = region.mutations[0]
            self._emit(
                mod, node, "JC202",
                f"{kind} in {region.label} of {leaf}() has no "
                f"lifecycle emission in the same scope — a state "
                f"change the journal cannot see is a postmortem gap")

    # -- JC203: non-atomic terminal once-guard ------------------------------
    def _jc203(self, mod: ModuleInfo, info: FuncInfo) -> None:
        if isinstance(info.node, ast.Lambda):
            return
        guards: dict[tuple, tuple[ast.AST, bool]] = {}
        commits: dict[tuple, tuple[ast.AST, bool]] = {}

        def flag_key(expr: ast.AST) -> tuple | None:
            """Normalized chain of the terminal flag being tested or
            committed, e.g. ('self', '_done') or ('job', 'finished')."""
            node = expr
            while isinstance(node, ast.UnaryOp):
                node = node.operand
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("is_set", "set"):
                node = node.func.value
            parts = _chain(node)
            if parts and parts[-1] in _TERMINAL_FLAGS:
                return parts
            return None

        def scan(stmts, locked: bool) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    inner = locked or any(
                        _lockish(i.context_expr) for i in stmt.items)
                    scan(stmt.body, inner)
                    continue
                if isinstance(stmt, ast.If):
                    tests = [stmt.test]
                    if isinstance(stmt.test, ast.BoolOp):
                        tests = list(stmt.test.values)
                    exits = any(isinstance(
                        s, (ast.Return, ast.Continue, ast.Break))
                        for s in stmt.body)
                    if exits:
                        for t in tests:
                            key = flag_key(t)
                            if key is not None and key not in guards:
                                guards[key] = (stmt, locked)
                    scan(stmt.body, locked)
                    scan(stmt.orelse, locked)
                    continue
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        key = flag_key(t)
                        if key is not None:
                            commits.setdefault(key, (stmt, locked))
                if isinstance(stmt, ast.Expr) \
                        and isinstance(stmt.value, ast.Call) \
                        and isinstance(stmt.value.func, ast.Attribute) \
                        and stmt.value.func.attr == "set":
                    key = flag_key(stmt.value)
                    if key is not None:
                        commits.setdefault(key, (stmt, locked))
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if isinstance(sub, list):
                        scan(sub, locked)
                if isinstance(stmt, ast.Try):
                    for h in stmt.handlers:
                        scan(h.body, locked)

        scan(list(info.node.body), False)
        for key, (gnode, glocked) in guards.items():
            if key not in commits:
                continue        # guard-only (early bail) — no race window
            cnode, clocked = commits[key]
            if glocked and clocked:
                continue
            self._emit(
                mod, gnode, "JC203",
                f"terminal once-guard on '{'.'.join(key)}' (test at "
                f"line {gnode.lineno}, commit at line {cnode.lineno}) "
                f"is not atomic — test and commit must share one held "
                f"lock or two racing resolvers can both win")

    # -- JC204: event-vocabulary drift --------------------------------------
    def _jc204(self, mod: ModuleInfo, info: FuncInfo) -> None:
        for node in self._iter_own_body(info):
            if not isinstance(node, ast.Call):
                continue
            name = self._is_emission(node)
            if name is None:
                continue
            self._emission_names.add(name)
            if name not in VOCABULARY:
                self._emit(
                    mod, node, "JC204",
                    f"emission '{name}' is not in the lifecycle event "
                    f"vocabulary (telemetry/lifecycle.py EVENTS)")
                continue
            allowed = (VOCABULARY[name] | OPTIONAL_FIELDS[name]
                       | ENVELOPE_FIELDS)
            literal = {k.arg for k in node.keywords if k.arg is not None}
            has_splat = any(k.arg is None for k in node.keywords)
            extra = literal - allowed - {"job", "epoch"}
            if extra:
                self._emit(
                    mod, node, "JC204",
                    f"emission '{name}' carries fields outside its "
                    f"schema: {sorted(extra)} (allowed: "
                    f"{sorted(allowed)})")
            if not has_splat:
                missing = VOCABULARY[name] - literal
                if missing:
                    self._emit(
                        mod, node, "JC204",
                        f"emission '{name}' is missing required "
                        f"fields: {sorted(missing)}")

    def _jc204_coverage(self) -> None:
        missing = sorted(set(VOCABULARY) - self._emission_names)
        for name in missing:
            self.violations.append(Violation(
                str(Path(lifecycle.__file__)), 1, "JC204",
                f"vocabulary entry '{name}' has no emission site in "
                f"the swept paths — dead schema or missed journal"))

    # -- run ---------------------------------------------------------------
    def run(self) -> list[Violation]:
        emitting = self._emitting_fixpoint()
        for mod in self.modules.values():
            for info in mod.funcs:
                if isinstance(info.node, ast.Lambda):
                    continue
                self._jc201(mod, info)
                self._jc202(mod, info, emitting)
                self._jc203(mod, info)
                self._jc204(mod, info)
        if self.coverage:
            self._jc204_coverage()
        return self._dedupe()


# ---------------------------------------------------------------------------
# entry points

def default_paths() -> list[Path]:
    pkg = Path(__file__).resolve().parents[1]
    return [pkg / "serve", pkg / "resilience"]


def check_paths(paths: list[Path],
                coverage: bool = False) -> list[Violation]:
    checker = ProtocolChecker(coverage=coverage)
    checker.load([Path(p) for p in paths])
    return checker.run()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aclswarm_torch.analysis.protocol",
        description="swarmproto protocol-conformance lint "
                    "(JC201-JC204)")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to sweep (default: serve/ + "
                         "resilience/, with vocabulary coverage)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    full_sweep = not args.paths
    paths = args.paths or default_paths()
    violations = check_paths(paths, coverage=full_sweep)
    for v in violations:
        print(v)
    if not args.quiet:
        n = len(violations)
        scope = "serve/ + resilience/" if full_sweep else \
            ", ".join(str(p) for p in paths)
        print(f"swarmproto: {n} finding{'s' if n != 1 else ''} "
              f"across {scope}", file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
