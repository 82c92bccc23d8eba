"""The chunk executor (`aclswarm_torch.resilience.executor`) against the
reference's `ChunkExecutor(cpu_fallback=False)`, and both trial drivers
with an injected transient failure, float64 on the CPU.

- a transient failure (the reference's message markers, or
  ``torch.cuda.OutOfMemoryError``) is retried; a chunk that failed
  partway and is replayed gives the uninterrupted chunk's bits, and the
  rollout never writes to its inputs;
- a sticky CUDA error and the port's own kernel errors are not retried;
  `InjectedCrash` and a cancel surface at once;
- spent retries raise and leave an `ExecutionFailure` record; the thunk
  ran exactly ``attempts`` times and nothing ran it again elsewhere (no
  CPU re-run, no ``degraded``);
- `row_fields` equals the reference's on the same failure script,
  ``elapsed_s`` aside;
- `run_trial` (`swarm4`, seed 3) and `run_trial_batch` (two `simform8`
  trials) with a transient failure injected into one chunk's rollout reach
  the reference's outcome under the same injection, with the same
  ``retries`` and the same `run_trials` summary ``resilience`` block.
"""
import threading

import numpy as np
import pytest
import torch

import aclswarm_tpu.sim as jsim_mod
from aclswarm_torch import sim
from aclswarm_torch.harness import supervisor as tsup
from aclswarm_torch.harness import trials as ttrials
from aclswarm_torch.resilience import checkpoint as tckpt
from aclswarm_torch.resilience.crash import InjectedCrash
from aclswarm_torch.resilience.executor import (ChunkExecutor,
                                                is_transient_device_error)
from aclswarm_torch.sim import summary as tsum
from aclswarm_torch.utils.retry import RetryCancelled, RetryPolicy
from aclswarm_tpu.harness import supervisor as jsup
from aclswarm_tpu.harness import trials as jtrials
from aclswarm_tpu.resilience import executor as jexec
from aclswarm_tpu.sim import summary as jsum
from aclswarm_tpu.utils import retry as jretry

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

FAST = dict(attempts=3, base_s=0.001, max_s=0.002)
CPU64 = dict(device="cpu", dtype="float64")       # TrialConfig fields
TORCH64 = dict(device="cpu", dtype=torch.float64)


def _executor(**kw):
    return ChunkExecutor(policy=RetryPolicy(**FAST), **kw)


def _failing(errors, result="ok"):
    """A thunk raising ``errors`` in turn, then returning ``result``;
    ``calls`` counts its calls."""
    errs = list(errors)

    def fn():
        fn.calls += 1
        if errs:
            raise errs.pop(0)
        return result
    fn.calls = 0
    return fn


# ------------------------------------------------------------ classifier

@pytest.mark.parametrize("err, transient", [
    (RuntimeError("UNAVAILABLE: tunnel reset"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (RuntimeError("CUDA error: device-side assert triggered"), False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
    (RuntimeError("CUDA error: misaligned address"), False),
    (RuntimeError("sinkhorn_log_launch failed: CUDA error 700 (an illegal "
                  "memory access was encountered)"), False),
    (RuntimeError("round_dominant_launch failed: CUDA error 2 (INTERNAL)"),
     False),
    (InjectedCrash("scripted preemption UNAVAILABLE"), False),
    (ValueError("a bug"), False),
])
def test_transient_classifier(err, transient):
    assert is_transient_device_error(err) is transient


# ------------------------------------------------------------ retry runs

def _roll_inputs(seed=0, n=5):
    rng = np.random.default_rng(seed)
    from aclswarm_torch.core import types

    pts = rng.normal(size=(n, 3)) * 3
    form = types.make_formation(pts, np.ones((n, n)) - np.eye(n),
                                np.eye(3 * n) * 0.01, **TORCH64)
    state = sim.init_state(rng.normal(size=(n, 3)) * 2 + [0, 0, 2],
                           **TORCH64)
    cfg = sim.SimConfig(assignment="sinkhorn", assign_every=10)
    sp = types.SafetyParams(bounds_min=(-50, -50, 0), bounds_max=(50, 50, 10))
    return state, form, types.ControlGains(), sp, cfg


def test_retried_chunk_that_failed_partway_is_bit_identical():
    """A chunk that ran half its ticks and then hit a transient failure is
    replayed from the same inputs: the result equals an uninterrupted
    chunk bit for bit, and the inputs are untouched (the rollout never
    writes to its arguments)."""
    state, form, g, sp, cfg = _roll_inputs()
    before = tckpt.tree_arrays((state, form))
    want_state, want_m = sim.rollout(state, form, g, sp, cfg, 30)

    def chunk():
        chunk.calls += 1
        if chunk.calls == 1:
            sim.rollout(state, form, g, sp, cfg, 15)
            raise RuntimeError("UNAVAILABLE: the chunk's launch was lost")
        return sim.rollout(state, form, g, sp, cfg, 30)
    chunk.calls = 0

    ex = _executor()
    got_state, got_m = ex.run(chunk, stage="chunk0")
    assert chunk.calls == 2 and ex.retries == 1 and ex.failures == []
    assert all(np.array_equal(a, b) for a, b in zip(
        tckpt.tree_arrays((got_state, got_m)),
        tckpt.tree_arrays((want_state, want_m))))
    assert all(np.array_equal(a, b) for a, b in zip(
        tckpt.tree_arrays((state, form)), before))
    assert ex.row_fields() == {"retries": 1}


def test_batched_rollout_leaves_its_inputs_alone():
    state, form, g, sp, cfg = _roll_inputs(seed=1)
    from aclswarm_torch.core import types

    bstate = sim.stack_states([state, state])
    bform = types.stack([form, form])
    before = tckpt.tree_arrays((bstate, bform))
    sim.batched_rollout(bstate, bform, g, sp, cfg, 20, None, 0)
    assert all(np.array_equal(a, b) for a, b in zip(
        tckpt.tree_arrays((bstate, bform)), before))


def test_out_of_memory_is_retried_after_emptying_the_cache(monkeypatch):
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: emptied.append(True))
    fn = _failing([torch.cuda.OutOfMemoryError("CUDA out of memory")])
    ex = _executor()
    assert ex.run(fn) == "ok" and fn.calls == 2 and emptied == [True]


@pytest.mark.parametrize("err", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("flood_merge_launch failed: CUDA error 719 (unspecified "
                 "launch failure)"),
    InjectedCrash("scripted preemption at serve boundary 2"),
    ValueError("not a device failure"),
])
def test_not_retried_errors_surface_at_once(err):
    fn = _failing([err])
    ex = _executor()
    with pytest.raises(type(err)):
        ex.run(fn)
    assert fn.calls == 1 and ex.retries == 0 and ex.failures == []
    assert ex.row_fields() == {}


def test_cancel_surfaces_at_once():
    ex = _executor()
    cancel = threading.Event()
    cancel.set()
    fn = _failing([])
    with pytest.raises(RetryCancelled):
        ex.run(fn, cancel=cancel)
    assert fn.calls == 0
    # cancelled after a failed attempt: that failure, no record, no retry
    cancel = threading.Event()

    def fn2():
        cancel.set()
        raise RuntimeError("UNAVAILABLE: lost")
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        ex.run(fn2, cancel=cancel)
    assert ex.failures == [] and ex.retries == 1


def test_spent_retries_raise_with_a_record_and_no_cpu_run():
    """Every attempt fails transiently: the executor raises the last
    failure and records it; the thunk ran exactly ``attempts`` times, and
    the record names no fallback."""
    fn = _failing([RuntimeError(f"RESOURCE_EXHAUSTED: try {i}")
                   for i in range(3)])
    ex = _executor()
    with pytest.raises(RuntimeError, match="try 2"):
        ex.run(fn, stage="wave0:chunk4")
    assert fn.calls == 3 and ex.retries == 2
    row = ex.row_fields()
    assert set(row) == {"retries", "execution_failures"}
    (rec,) = row["execution_failures"]
    assert rec["stage"] == "wave0:chunk4" and rec["attempts"] == 3
    assert rec["fallback"] is None and "try 2" in rec["error"]
    assert not hasattr(ex, "degraded")


def _script():
    """One failure script: (errors before success or exhaustion, stage)."""
    return [([RuntimeError("UNAVAILABLE: a")], "s0"),
            ([RuntimeError("RESOURCE_EXHAUSTED: b")] * 3, "s1"),
            ([ValueError("c")], "s2"),
            ([], "s3"),
            ([RuntimeError("DEADLINE: d"), RuntimeError("ABORTED: e")],
             "s4")]


def _drive(ex):
    for errs, stage in _script():
        try:
            ex.run(_failing(errs), stage=stage)
        except (RuntimeError, ValueError):
            pass
    row = ex.row_fields()
    for rec in row.get("execution_failures", []):
        rec.pop("elapsed_s")
    return row


def test_row_fields_equal_the_references():
    ref = jexec.ChunkExecutor(policy=jretry.RetryPolicy(**FAST),
                              cpu_fallback=False)
    got, want = _drive(_executor()), _drive(ref)
    assert got == want
    assert got["retries"] == 5 and len(got["execution_failures"]) == 1


# -------------------------------------------------- trial drivers, injected

def _inject(monkeypatch, mod, name, at_call):
    """Make ``mod.name`` raise a transient error once, on its
    ``at_call``-th call (0-based); returns the call counter."""
    real = getattr(mod, name)
    seen = {"calls": 0}

    def wrapped(*a, **kw):
        k = seen["calls"]
        seen["calls"] += 1
        if k == at_call:
            raise RuntimeError("UNAVAILABLE: injected transient failure")
        return real(*a, **kw)
    monkeypatch.setattr(mod, name, wrapped)
    return seen


def _fast_retries(monkeypatch):
    real = ttrials.ChunkExecutor
    monkeypatch.setattr(ttrials, "ChunkExecutor",
                        lambda log=None: real(policy=RetryPolicy(**FAST),
                                              log=log))


def _outcome(fsm, names):
    return (names[fsm.state], fsm.tick_count, list(fsm.times),
            list(fsm.assignments), list(fsm.time_avoidance))


def test_serial_trial_with_a_transient_failure_matches_the_reference(
        monkeypatch):
    cfg = dict(formation="swarm4", seed=3, verbose=False)
    _inject(monkeypatch, jsim_mod, "rollout", 3)
    jf = jtrials.run_trial(jtrials.TrialConfig(**cfg), 0)
    _fast_retries(monkeypatch)
    seen = _inject(monkeypatch, sim, "rollout", 3)
    tf = ttrials.run_trial(ttrials.TrialConfig(**cfg, **CPU64), 0)
    assert seen["calls"] > 4
    assert _outcome(tf, tsup.NAMES) == _outcome(jf, jsup.NAMES)
    assert tf.execution == jf.execution == {"retries": 1}
    np.testing.assert_allclose(tf.csv_row(0)[1:5], jf.csv_row(0)[1:5],
                               rtol=0, atol=1e-9)


def test_batched_trials_with_a_transient_failure_match_the_reference(
        monkeypatch, tmp_path):
    """`run_trials` with batch=2 on `simform8`: the wave's chunk 5 fails
    once in both packages; both trials reach the reference's outcomes,
    each FSM carries ``retries`` 1, and the summaries' ``resilience``
    blocks agree."""
    cfg = dict(formation="simform8", seed=1, assignment="sinkhorn",
               localization="flooded", flood_phases=2, assign_eps=0.01,
               gain_scale=0.15, trial_timeout=40.0, chunk_ticks=120,
               trials=2, batch=2, verbose=False)
    jf = []
    real_j = jtrials.run_trial_batch
    monkeypatch.setattr(jtrials, "run_trial_batch",
                        lambda c, idx: jf.extend(real_j(c, idx)) or jf)
    _inject(monkeypatch, jsum, "batched_rollout_summary", 5)
    jstats = jtrials.run_trials(jtrials.TrialConfig(
        **cfg, out=str(tmp_path / "j.csv")))
    _fast_retries(monkeypatch)
    tf = []
    real_t = ttrials.run_trial_batch
    monkeypatch.setattr(ttrials, "run_trial_batch",
                        lambda c, idx: tf.extend(real_t(c, idx)) or tf)
    _inject(monkeypatch, tsum, "batched_rollout_summary", 5)
    tstats = ttrials.run_trials(ttrials.TrialConfig(
        **cfg, **CPU64, out=str(tmp_path / "t.csv")))
    assert [_outcome(f, tsup.NAMES) for f in tf] \
        == [_outcome(f, jsup.NAMES) for f in jf]
    assert [f.execution for f in tf] == [f.execution for f in jf] \
        == [{"retries": 1}] * 2
    assert tstats["resilience"] == jstats["resilience"] \
        == {"retries": 2, "execution_failures": []}
