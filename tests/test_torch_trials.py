"""The serial trial harness: the reference's `run_trial`/`run_trials` against
the port's (`aclswarm_torch.harness.trials`) on the same `TrialConfig`
fields, float64 on the CPU, the JAX run as its own tests run it.

Each trial case compares the verdict, the supervisor's transitions
(state, tick) — recorded in both packages by wrapping
`TrialFSM._next_state` — the ticks at which a dispatch took effect (the
chunk that starts on a re-phased tick 0), and the CSV row: trial id,
times, time_avoidance and assignments exact, distances at 1e-9 (float64,
positions equal to ~1e-12 between the packages; the EWMA distance sums
thousands of ticks). The cases:

1. `swarm4`, seed 3: library gains, auction, full lifecycle, COMPLETE;
2. `swarm6_3d`, seed 1, doubleint: the flagship's sparse graphs;
3. `simform8`, seed 1, the `simform1000_flooded` knobs that apply at this
   size (Sinkhorn with assign_eps, flooded localization in two stripes,
   gain_scale 0.15) with trial_timeout cut to 40 s: gains designed on
   dispatch in the n-4 bucket, the plain versions of K1, K2 and K3;
4. the same with `warm_gains=True`: the carry is threaded, and the second
   dispatch takes fewer ADMM iterations, in both packages alike.

Cases 1 and 3 fly with every observability field on (``check_mode``,
``telemetry``, ``telemetry_dump``, ``record_dir`` in both packages,
``profile_dir`` in the port's): besides the above, the counters published at each chunk
boundary are equal (integers exact, ``admm_residual`` at rtol 1e-12), the
dumped trial counters are equal, the recordings are equal (positions and
|distcmd| at 1e-9, every other field exact) and each package's `review`
of its own recording reaches the live trial's state, ticks and times.

Seeds: the reference's own test seeds for the library groups
(`tests/test_trials.py`: swarm4 seed 3, swarm6_3d seed 1); seed 1 for
`simform8`, which completes inside the cut in both packages. Avoidance is
dense (`colavoid_neighbors=None`, the default at these sizes), which keeps
the k-pruned avoidance's duplicate-sector coin flip (ROADMAP.md §3) off
every path here.

Port-only cases: checkpoint/resume after a scripted crash with the
invariant and counter carries on (same CSV row, same final `SimState`
bits), a dtype mismatch refused, the codec's bytes against the
reference's, each observability field alone, and the scenario field.
`test_torch_trials_library.py` holds `run_trials`, the CLI, the library,
the loader, the generator and the supervisor against the reference's.

Serial time of this file on one CPU host: ~100 s, most of it the port's
trials (2-5 ms per tick of Python-dispatched tensor code).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference runs on the CPU under conftest)

import aclswarm_torch.sim as tsim_mod
import aclswarm_tpu.sim as jsim_mod
from aclswarm_torch import convert
from aclswarm_torch import gains as tgains
import aclswarm_torch.telemetry as ttel
import aclswarm_tpu.telemetry as jtel
from aclswarm_torch.analysis import invariants as tinv
from aclswarm_torch.harness import review as treview
from aclswarm_torch.harness import supervisor as tsup
from aclswarm_torch.harness import trials as ttrials
from aclswarm_torch.resilience import checkpoint as tckpt
from aclswarm_torch.resilience import crash as tcrash
from aclswarm_torch.telemetry import device as tdev
from aclswarm_tpu import gains as jgains
from aclswarm_tpu.harness import review as jreview
from aclswarm_tpu.harness import supervisor as jsup
from aclswarm_tpu.harness import trials as jtrials
from aclswarm_tpu.resilience import checkpoint as jckpt
from aclswarm_tpu.telemetry import device as jdev

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

CPU64 = dict(device="cpu", dtype="float64")
SIMFORM = dict(formation="simform8", seed=1, assignment="sinkhorn",
               localization="flooded", flood_phases=2, assign_eps=0.01,
               gain_scale=0.15, trial_timeout=40.0)
CASES = {
    "swarm4": dict(formation="swarm4", seed=3),
    "swarm6_3d": dict(formation="swarm6_3d", seed=1, dynamics="doubleint"),
    "simform8_sinkhorn_flooded": SIMFORM,
    "simform8_sinkhorn_flooded_warm": dict(SIMFORM, warm_gains=True),
}
# the cases flown with every observability field on
OBSERVED = ("swarm4", "simform8_sinkhorn_flooded")


class Recorder:
    """Wraps one package's `TrialFSM._next_state`, `sim.rollout` and
    `gains.solve_gains`: the transitions, each chunk's starting tick and
    the iterations of every gain design (from a second, telemetry solve
    whose result is dropped, so the trial's own solve is untouched)."""

    def __init__(self, monkeypatch, fsm_cls, sim_mod, gains_mod, tick_of):
        self.transitions, self.chunk_ticks, self.admm_iters = [], [], []
        self.final_state = None
        next_state, rollout = fsm_cls._next_state, sim_mod.rollout
        solve = gains_mod.solve_gains

        def _next_state(fsm, state, reset=True):
            self.transitions.append((int(state), int(fsm.tick_count)))
            return next_state(fsm, state, reset)

        def _rollout(state, *args, **kw):
            self.chunk_ticks.append(tick_of(state))
            self.final_state, metrics = rollout(state, *args, **kw)
            return self.final_state, metrics

        def _solve(*args, **kw):
            out = solve(*args, **kw)
            self.admm_iters.append(
                int(solve(*args, **dict(kw, telemetry=True))[-1].iters))
            return out

        monkeypatch.setattr(fsm_cls, "_next_state", _next_state)
        monkeypatch.setattr(sim_mod, "rollout", _rollout)
        monkeypatch.setattr(gains_mod, "solve_gains", _solve)

    def dispatch_ticks(self, chunk: int) -> list:
        """Trial ticks at which a dispatch took effect: the chunks that
        start on a re-phased tick 0."""
        return [i * chunk for i, t in enumerate(self.chunk_ticks)
                if i > 0 and t == 0]


def _port_recorder(monkeypatch):
    return Recorder(monkeypatch, tsup.TrialFSM, tsim_mod, tgains,
                    lambda s: int(s.tick))


def _jax_recorder(monkeypatch):
    return Recorder(monkeypatch, jsup.TrialFSM, jsim_mod, jgains,
                    lambda s: int(np.asarray(s.tick)))


def _assert_rows_equal(row_t, row_j, n):
    assert len(row_t) == len(row_j)
    assert row_t[0] == row_j[0]
    np.testing.assert_allclose(row_t[1:1 + n], row_j[1:1 + n], rtol=0,
                               atol=1e-9)
    assert row_t[1 + n:] == row_j[1 + n:]


def _published(monkeypatch, dev_mod) -> list:
    """Every (trial, snapshot) one package's `ChunkPublisher` folds in."""
    seen, publish = [], dev_mod.ChunkPublisher.publish

    def _publish(self, key, tel):
        seen.append((key, dict(tel)))
        return publish(self, key, tel)

    monkeypatch.setattr(dev_mod.ChunkPublisher, "publish", _publish)
    return seen


def _observed_fields(root, tag) -> dict:
    """Every observability field; the reference's run skips the profiler
    (its trace is no parity quantity, and its capture costs seconds)."""
    fields = dict(check_mode="on", telemetry="on",
                  telemetry_dump=str(root / f"{tag}.jsonl"),
                  record_dir=str(root / f"rec_{tag}"))
    if tag == "t":
        fields["profile_dir"] = str(root / "prof_t")
    return fields


def _trial_counters(path) -> dict:
    rows = [json.loads(line) for line in open(path)]
    return {r["name"]: r["value"] for r in rows
            if r["name"].startswith("trial_") and r["kind"] != "histogram"}


def _assert_observed_equal(root, tfsm, jfsm, tpub, jpub):
    assert [k for k, _ in tpub] == [k for k, _ in jpub] and tpub
    for (_, a), (_, b) in zip(tpub, jpub):
        np.testing.assert_allclose(a.pop("admm_residual"),
                                   b.pop("admm_residual"), rtol=1e-12,
                                   atol=0)
        assert a == b
    assert _trial_counters(root / "t.jsonl") \
        == _trial_counters(root / "j.jsonl")
    trec = np.load(root / "rec_t" / "trial_0.npz")
    jrec = np.load(root / "rec_j" / "trial_0.npz")
    assert sorted(trec.files) == sorted(jrec.files)
    for k in trec.files:
        if k in ("q", "distcmd_norm"):
            np.testing.assert_allclose(trec[k], jrec[k], rtol=0, atol=1e-9)
        else:
            np.testing.assert_array_equal(trec[k], jrec[k], err_msg=k)
    n_forms = len(tfsm.times)
    tre = treview.review(str(root / "rec_t" / "trial_0.npz"), n_forms)
    jre = jreview.review(str(root / "rec_j" / "trial_0.npz"), n_forms)
    for live, replay, names in ((tfsm, tre, tsup.NAMES),
                                (jfsm, jre, jsup.NAMES)):
        assert names[replay.state] == names[live.state]
        assert replay.tick_count == live.tick_count
        assert replay.times == live.times
    assert list(tre.times) == list(jre.times)
    traces = list((root / "prof_t").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


@pytest.mark.parametrize("case", list(CASES))
def test_trial_matches_reference(case, monkeypatch, tmp_path):
    kw = dict(CASES[case], verbose=False)
    observed = case in OBSERVED
    if observed:
        ttel.reset_registry()
        jtel.reset_registry()
        tpub = _published(monkeypatch, tdev)
        jpub = _published(monkeypatch, jdev)
    jrec = _jax_recorder(monkeypatch)
    jfsm = jtrials.run_trial(jtrials.TrialConfig(
        **kw, **(_observed_fields(tmp_path, "j") if observed else {})), 0)
    trec = _port_recorder(monkeypatch)
    tfsm = ttrials.run_trial(ttrials.TrialConfig(
        **kw, **CPU64, **(_observed_fields(tmp_path, "t") if observed
                          else {})), 0)
    if observed:
        # the dump is `run_trials`' last step; a lone `run_trial` leaves it
        ttel.get_registry().dump(tmp_path / "t.jsonl")
        jtel.get_registry().dump(tmp_path / "j.jsonl")
        _assert_observed_equal(tmp_path, tfsm, jfsm, tpub, jpub)

    assert tsup.NAMES[tfsm.state] == jsup.NAMES[jfsm.state]
    assert trec.transitions == jrec.transitions
    chunk = ttrials.TrialConfig().chunk_ticks
    assert trec.dispatch_ticks(chunk) == jrec.dispatch_ticks(chunk)
    assert trec.dispatch_ticks(chunk), "no dispatch took effect"
    _assert_rows_equal(tfsm.csv_row(0), jfsm.csv_row(0), tfsm.n)
    assert tfsm.execution == {}
    assert trec.admm_iters == jrec.admm_iters
    if case.startswith("swarm"):
        assert tfsm.completed and trec.admm_iters == []  # library gains
    if case.endswith("_warm"):
        assert len(trec.admm_iters) == 2
        assert trec.admm_iters[1] < trec.admm_iters[0]


# ------------------------------------------------- checkpoint and resume

RESUME = dict(SIMFORM, warm_gains=True, trial_timeout=12.5,
              checkpoint_every=4, check_mode="on", telemetry="on",
              verbose=False, **CPU64)


def _state_leaves(state) -> dict:
    return tckpt._leaves(convert.sim_state_to_numpy(state))


def test_resume_after_crash_is_bit_identical(tmp_path, monkeypatch):
    """A scripted crash at chunk 24 (after the first dispatch, so the
    gains cache, the warm carry and the dispatch's solve in the counter
    carry ride the checkpoint), then a resume from that checkpoint, both
    the invariant and the counter carries on: the same CSV row and the
    same final `SimState` bits as the uninterrupted trial."""
    rec = _port_recorder(monkeypatch)
    whole = ttrials.run_trial(ttrials.TrialConfig(**RESUME), 0)
    whole_state = rec.final_state
    assert rec.dispatch_ticks(50) == [1050]

    cfg = ttrials.TrialConfig(**RESUME, checkpoint_dir=str(tmp_path))
    tcrash.arm(tcrash.CrashPlan("trial", 24))
    try:
        with pytest.raises(tcrash.InjectedCrash):
            ttrials.run_trial(cfg, 0)
    finally:
        tcrash.arm(None)
    assert tckpt.latest_checkpoint(tmp_path, "trial00000").name \
        == "trial00000.c00000024.ckpt"
    rec.chunk_ticks.clear()
    resumed = ttrials.run_trial(cfg, 0)
    assert len(rec.chunk_ticks) == whole.tick_count // 50 + 1 - 24
    assert resumed.csv_row(0) == whole.csv_row(0)
    assert resumed.state == whole.state == tsup.TrialState.TERMINATE
    got, want = _state_leaves(rec.final_state), _state_leaves(whole_state)
    assert got.keys() == want.keys()
    assert int(want["tel.admm_iters"]) > 0 and int(want["inv.code"]) == 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a finished trial leaves no interim checkpoint behind
    assert tckpt.latest_checkpoint(tmp_path, "trial00000") is None


def test_checkpoint_of_another_dtype_is_refused(tmp_path, monkeypatch):
    """A float32 checkpoint does not resume a float64 run: the manifest's
    fingerprint (and the config hash) disagree, loudly. The crash is armed
    the way a command-line drill arms it, through ``ACLSWARM_CRASH``."""
    argv = ["-f", "swarm4", "-s", "3", "-o", str(tmp_path / "t.csv"),
            "--set", "verbose=false", "--set", "device=cpu",
            "--set", f"checkpoint_dir={tmp_path}",
            "--set", "checkpoint_every=1"]
    monkeypatch.setenv(tcrash.ENV_VAR, "trial:2:raise")
    with pytest.raises(tcrash.InjectedCrash):
        ttrials.main(argv + ["--set", "dtype=float32"])
    assert tcrash.ENV_VAR not in os.environ        # one-shot
    with pytest.raises(tckpt.CheckpointMismatch) as err:
        ttrials.main(argv + ["--set", "dtype=float64"])
    fields = [m[0] for m in err.value.mismatches]
    assert "dtype" in fields and "config_hash" in fields
    assert tckpt.dtype_fingerprint(torch.float32, "cuda") \
        == "torch=float32,device=cuda"


def test_checkpoint_frames_equal_the_reference_codec(tmp_path):
    """The port writes the reference's frame format byte for byte, and
    each package reads the other's frames."""
    rng = np.random.default_rng(0)
    payload = {"a": rng.normal(size=(3, 4)), "i": np.int32(7),
               "none": None, "nested": {"b": [1, 2.5, True, "x"],
                                        "z": np.zeros((), bool)}}
    manifest = {"kind": "t", "chunk": 3}
    frame = tckpt.dumps(payload, manifest)
    assert frame == jckpt.dumps(payload, manifest)
    for loads in (tckpt.loads, jckpt.loads):
        back, man = loads(frame)
        assert man == manifest
        np.testing.assert_array_equal(back["a"], payload["a"])
        assert back["nested"]["b"] == [1, 2.5, True, "x"]
    bad = bytearray(frame)
    bad[-1] ^= 1
    with pytest.raises(tckpt.CheckpointCorrupt):
        tckpt.loads(bytes(bad))


def test_carry_payload_roundtrips_codec(tmp_path):
    """`_carry_payload`/`_carry_restore`: the warm carry crosses a
    checkpoint file bit for bit, None stays None, and the restored carry
    seeds the next solve like the live one."""
    rng = np.random.default_rng(2)
    n = 8
    pts = rng.normal(size=(n, 3)) * 4
    adj = np.ones((n, n)) - np.eye(n)
    carry0 = tgains.init_carry(n, tgains.planar_of(pts),
                               dtype=torch.float64, device="cpu")
    _, carry = tgains.solve_gains(pts, adj, carry=carry0, device="cpu")
    assert ttrials._carry_payload(None) is None
    assert ttrials._carry_restore(None, "cpu", torch.float64) is None
    path = tckpt.write_checkpoint(
        tmp_path, "t", {"c": ttrials._carry_payload(carry)},
        tckpt.make_manifest("t", "h", 0, "fp"))
    loaded, _ = tckpt.load_checkpoint(path)
    back = ttrials._carry_restore(loaded["c"], "cpu", torch.float64)
    for a, b in zip(back, carry):
        assert torch.equal(a, b)
    g_live, _ = tgains.solve_gains(pts, adj, carry=carry, device="cpu")
    g_back, _ = tgains.solve_gains(pts, adj, carry=back, device="cpu")
    assert torch.equal(g_live, g_back)


# ----------------------------------------- the observability fields alone

@pytest.mark.parametrize("field,value", [
    ("check_mode", "on"),
    ("telemetry", "on"),
    ("telemetry_dump", "m.jsonl"),
    ("profile_dir", "prof"),
    ("record_dir", "bags"),
])
def test_observability_field_runs(field, value, tmp_path, monkeypatch):
    """Each field that used to raise, alone, on a `swarm4` trial cut at
    0.5 s (two chunks), and its effect: the codes checked at every chunk,
    the counters published, the registry dumped, the chunk profiled, the
    trial recorded and replayed to the same outcome."""
    if value != "on":
        value = str(tmp_path / value)
    checked = []
    raise_on = tinv.raise_on_violation
    monkeypatch.setattr(tinv, "raise_on_violation",
                        lambda codes, **kw: (checked.append(codes),
                                             raise_on(codes, **kw)))
    ttel.reset_registry()
    cfg = ttrials.TrialConfig(formation="swarm4", seed=3, trial_timeout=0.5,
                              verbose=False, **{field: value}, **CPU64)
    if field == "telemetry_dump":      # `run_trials` writes it at the end
        ttrials.run_trials(cfg)
    else:
        fsm = ttrials.run_trial(cfg, 0)
    chunks = 2                       # the watchdog fires in the second
    if field == "check_mode":
        assert len(checked) == chunks
        assert all(c.shape == (50,) and not c.any() for c in checked)
    else:
        assert not checked
    snap = ttel.get_registry().snapshot()["metrics"]
    assert ("trial_flood_stale_max_ticks" in snap) == (field == "telemetry")
    if field == "telemetry_dump":
        assert "spans_dropped_total" in open(value).read()
    if field == "profile_dir":
        (trace,) = os.listdir(value)
        assert trace.endswith(".pt.trace.json")
    if field == "record_dir":
        assert os.listdir(value) == ["trial_0.npz"]
        rec = treview.Recording(os.path.join(value, "trial_0.npz"))
        assert rec.n_ticks == chunks * 50 and rec.n == 4
        assert float(rec.meta["trial_timeout"]) == 0.5
        replay = treview.review(os.path.join(value, "trial_0.npz"))
        assert (replay.state, replay.tick_count) \
            == (fsm.state, fsm.tick_count)


def test_scenario_field_is_ported():
    """`scenario` (item 13) no longer raises; a family the registry does
    not know is refused before the trial flies, as the reference's is.
    `tests/test_torch_scenarios_trials.py` flies scenarios."""
    cfg = ttrials.TrialConfig(formation="swarm4", verbose=False,
                              scenario="wind", **CPU64)
    ttrials._check_dtype(cfg)
    with pytest.raises(ValueError, match="unknown scenario family"):
        ttrials.run_trial(cfg, 0)


