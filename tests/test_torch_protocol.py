"""The port's protocol tier against the reference's: the declarative spec
(`analysis.protocol`), the JC201-JC204 conformance lint, the explicit-state
model checker (`analysis.model`) and the refinement of journals.

Both packages' tools run side by side: on the reference's fixtures (copied
under `tests/fixtures/torchcheck/` with only the pragma token changed)
they report the same ``(line, rule)`` lists; both model checkers reach
the same states on the 2x2 configuration and each mutation trips exactly
its property in both; and a journal written by the port's `SwarmService`
refines in both packages with the same verdict.
"""
from __future__ import annotations

from pathlib import Path

import pytest
import torch

from aclswarm_torch.analysis import lint as port_lint
from aclswarm_torch.analysis import model as port_model
from aclswarm_torch.analysis import protocol as port_proto
from aclswarm_torch.telemetry import LifecycleLog, lifecycle, mint_trace_id
from aclswarm_tpu.analysis import model as ref_model
from aclswarm_tpu.analysis import protocol as ref_proto

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

ROOT = Path(__file__).parent
REF_FIXTURES = ROOT / "fixtures" / "jaxcheck"
FIXTURES = ROOT / "fixtures" / "torchcheck"

CLEAN = ["submitted", "admitted", "batched", "chunk", "queued",
         "batched", "chunk", "checkpointed", "resolved"]


# ------------------------------------------------------ declarative spec

def test_spec_equals_the_reference():
    assert port_proto.TRANSITIONS == ref_proto.TRANSITIONS
    assert port_proto.OPTIONAL_FIELDS == ref_proto.OPTIONAL_FIELDS
    assert port_proto.ENVELOPE_FIELDS == ref_proto.ENVELOPE_FIELDS
    assert port_proto.VOCABULARY == ref_proto.VOCABULARY


def test_alphabet_is_the_ports_request_vocabulary():
    alphabet = {ev for edges in port_proto.TRANSITIONS.values()
                for ev in edges}
    assert alphabet == set(lifecycle.EVENTS)
    assert set(port_proto.OPTIONAL_FIELDS) == set(port_proto.VOCABULARY)


TRACES = [CLEAN, CLEAN + ["resolved"], ["batched"],
          ["submitted", "admitted", "cancelled", "resolved"],
          ["batched", "chunk", "resolved"], ["resolved", "submitted"]]


@pytest.mark.parametrize("events", TRACES, ids=lambda t: "-".join(t)[:40])
def test_accepts_as_the_reference(events):
    for cut in range(len(events) + 1):
        assert port_proto.accepts(events[:cut]) \
            == ref_proto.accepts(events[:cut])
    assert port_proto.accepts_fragment(events) \
        == ref_proto.accepts_fragment(events)


# ------------------------------------------------------ conformance lint

FIXTURE_RULES = {"bad_jc201.py": ("JC201", 1), "bad_jc202.py": ("JC202", 3),
                 "bad_jc203.py": ("JC203", 2), "bad_jc204.py": ("JC204", 3)}


def _lines(violations):
    return [(v.line, v.rule) for v in violations]


@pytest.mark.parametrize("fixture", list(FIXTURE_RULES))
def test_same_findings_as_reference(fixture):
    want = _lines(ref_proto.check_paths([REF_FIXTURES / fixture]))
    got = _lines(port_proto.check_paths([FIXTURES / fixture]))
    rule, count = FIXTURE_RULES[fixture]
    assert got == want
    assert [r for _, r in got] == [rule] * count


def test_serve_and_resilience_sweep_clean():
    """Zero unsuppressed JC201-JC204 across the port's serve/ and
    resilience/, including vocabulary coverage (every event of the
    schema has an emission site)."""
    violations = port_proto.check_paths(port_proto.default_paths(),
                                        coverage=True)
    assert violations == [], "\n".join(str(v) for v in violations)


def test_cli_exit_codes(tmp_path):
    for mod, fixtures in ((port_proto, FIXTURES), (ref_proto, REF_FIXTURES)):
        assert mod.main(["-q", str(fixtures / "bad_jc204.py")]) == 1
    clean = tmp_path / "clean.py"
    clean.write_text("def f():\n    return 1\n")
    assert port_proto.main(["-q", str(clean)]) == 0


def test_lint_all_merges_tiers(capsys):
    """`lint --all` runs JC0xx + JC1xx + JC2xx over the port with one
    merged exit surface, and each tier alone exits 0 on the port."""
    assert port_lint.main(["--all"]) == 0
    out = capsys.readouterr()
    assert "torchcheck:" in out.out
    assert "torchcheck-concurrency:" in out.out
    assert "swarmproto:" in out.out + out.err
    for argv in ([], ["--concurrency"], ["--protocol"]):
        assert port_lint.main(argv) == 0
    capsys.readouterr()
    assert port_lint.main(["--protocol",
                           str(FIXTURES / "bad_jc201.py")]) == 1


# ----------------------------------------------------- the model checker

def test_same_state_space_as_reference():
    got = port_model.check(port_model.ModelConfig())
    want = ref_model.check(ref_model.ModelConfig())
    assert got.ok and want.ok, port_model.render_trace(got)
    assert got.states == want.states > 100


@pytest.mark.parametrize("mutation,expected",
                         sorted(ref_model.MUTATIONS.items()))
def test_mutation_trips_exactly_its_property(mutation, expected):
    """Each deliberate protocol mutation trips the property built to catch
    it in both packages, with the same minimal counterexample."""
    assert port_model.MUTATIONS[mutation] == expected
    got = port_model.check(port_model.ModelConfig(mutation=mutation))
    want = ref_model.check(ref_model.ModelConfig(mutation=mutation))
    assert not got.ok and got.property == want.property == expected
    assert [step[0] for step in got.trace] \
        == [step[0] for step in want.trace]
    assert port_model.render_trace(got) == ref_model.render_trace(want)


def test_self_test_cli():
    assert port_model.main(["--self-test", "-q"]) == 0
    assert port_model.main(["--mutate", "skip_fence", "-q"]) == 0


# ----------------------------------------------------- trace refinement

def _emit_history(log: LifecycleLog, rid: str, events) -> None:
    tid = mint_trace_id()
    t = [1000.0]
    defaults = {
        "submitted": {"kind": "rollout", "tenant": "a"},
        "admitted": {},
        "queued": {"reason": "boundary"},
        "batched": {"worker": 0, "round": 1, "batch": 1},
        "chunk": {"k": 0, "digest": 7, "worker": 0},
        "checkpointed": {"chunk": 0, "durable": True},
        "migrated": {"dead_worker": 0, "chunk": 0},
        "resumed": {"from_chunk": 0},
        "preempted": {"chunk": 0},
        "deadline": {"chunk": 0},
        "cancelled": {"reason": "client"},
        "poisoned": {},
        "resolved": {"status": "completed", "chunks": 1},
    }
    for ev in events:
        t[0] += 0.1
        log.emit(ev, request_id=rid, trace_id=tid, t_wall=t[0],
                 **defaults[ev])


@pytest.mark.parametrize("events,ok", [(CLEAN, True),
                                       (CLEAN + ["resolved"], False),
                                       (["submitted", "submitted"], False)])
def test_synthetic_journal_same_verdict(tmp_path, events, ok):
    _emit_history(LifecycleLog(tmp_path / "events.log"), "r1", events)
    got, want = port_model.refine_dir(tmp_path), \
        ref_model.refine_dir(tmp_path)
    assert (got == []) is (want == []) is ok
    assert len(got) == len(want)


def test_fleet_slices_refine_as_fragments(tmp_path):
    a, b = tmp_path / "slot0", tmp_path / "slot1"
    _emit_history(LifecycleLog(a / "events.log"), "r1",
                  ["submitted", "admitted", "batched", "chunk"])
    _emit_history(LifecycleLog(b / "events.log"), "r1",
                  ["batched", "resumed", "chunk", "resolved"])
    assert port_model.refine_dir(b) != []       # not valid from init
    rep = port_model.refine_tree(tmp_path)      # siblings = one fleet
    assert rep == {"journals": 2, "requests": 2, "events": 8,
                   "problems": []}
    assert ref_model.refine_tree(tmp_path) == {"journals": 2,
                                               "problems": []}


def test_refine_cli_exit_codes(tmp_path, capsys):
    good = tmp_path / "good"
    _emit_history(LifecycleLog(good / "events.log"), "r1", CLEAN)
    assert port_model.main(["--refine", str(good), "-q"]) == 0
    bad = tmp_path / "bad"
    _emit_history(LifecycleLog(bad / "events.log"), "r1",
                  ["submitted", "submitted"])
    assert port_model.main(["--refine", str(bad), "-q"]) == 1
    assert "REFINEMENT FAIL" in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert port_model.main(["--refine", str(empty), "-q"]) == 1


def test_port_service_journal_refines_in_both(tmp_path):
    """End to end: a live journal of the port's `SwarmService` on the CPU
    (acceptance frames, lifecycle events, terminals) replays as accepted,
    complete protocol traces in both packages' refinement."""
    from aclswarm_torch.serve import ServiceConfig, SwarmService

    svc = SwarmService(ServiceConfig(max_batch=2, journal_dir=str(tmp_path),
                                     device="cpu", dtype="float64"))
    try:
        tickets = [svc.submit("assign", {"n": 8, "seed": 3}, tenant="a"),
                   svc.submit("rollout", {"n": 5, "ticks": 40,
                                          "chunk_ticks": 20, "seed": 1},
                              tenant="b")]
        assert all(t.result(timeout=120).ok for t in tickets)
    finally:
        svc.close()
    stats: dict = {}
    assert port_model.refine_dir(tmp_path, stats=stats) == []
    assert ref_model.refine_dir(tmp_path) == []
    assert stats["requests"] == 2 and stats["events"] > 8
