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

Seeds: the reference's own test seeds for the library groups
(`tests/test_trials.py`: swarm4 seed 3, swarm6_3d seed 1); seed 1 for
`simform8`, which completes inside the cut in both packages. Avoidance is
dense (`colavoid_neighbors=None`, the default at these sizes), which keeps
the k-pruned avoidance's duplicate-sector coin flip (ROADMAP.md §3) off
every path here.

Port-only cases: checkpoint/resume after a scripted crash (same CSV row,
same final `SimState` bits), a dtype mismatch refused, the codec's bytes
against the reference's, the CLI, the fields that still raise, the
library copy, the loader and generator against the reference's, and the
supervisor stepped on scripted signals against the reference's.

Serial time of this file on one CPU host: ~100 s, most of it the port's
trials (2-5 ms per tick of Python-dispatched tensor code).
"""
import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference runs on the CPU under conftest)

import aclswarm_torch.sim as tsim_mod
import aclswarm_tpu.sim as jsim_mod
from aclswarm_torch import convert
from aclswarm_torch import gains as tgains
from aclswarm_torch.harness import formations as tformations
from aclswarm_torch.harness import formgen as tformgen
from aclswarm_torch.harness import supervisor as tsup
from aclswarm_torch.harness import trials as ttrials
from aclswarm_torch.resilience import checkpoint as tckpt
from aclswarm_torch.resilience import crash as tcrash
from aclswarm_tpu import gains as jgains
from aclswarm_tpu.harness import formations as jformations
from aclswarm_tpu.harness import formgen as jformgen
from aclswarm_tpu.harness import supervisor as jsup
from aclswarm_tpu.harness import trials as jtrials
from aclswarm_tpu.resilience import checkpoint as jckpt

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


@pytest.mark.parametrize("case", list(CASES))
def test_trial_matches_reference(case, monkeypatch):
    kw = dict(CASES[case], verbose=False)
    jrec = _jax_recorder(monkeypatch)
    jfsm = jtrials.run_trial(jtrials.TrialConfig(**kw), 0)
    trec = _port_recorder(monkeypatch)
    tfsm = ttrials.run_trial(ttrials.TrialConfig(**kw, **CPU64), 0)

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


def test_run_trials_matches_reference(tmp_path, monkeypatch):
    """`run_trials` over two seeds of `simform6` (the reference's CLI
    test group): the same stats and the same CSV."""
    kw = dict(formation="simform6", trials=2, seed=2, verbose=False)
    jstats = jtrials.run_trials(jtrials.TrialConfig(
        **kw, out=str(tmp_path / "j.csv")))
    tstats = ttrials.run_trials(ttrials.TrialConfig(
        **kw, out=str(tmp_path / "t.csv"), **CPU64))
    assert tstats.keys() == jstats.keys()
    for k, v in jstats.items():
        np.testing.assert_allclose(tstats[k], v, rtol=0, atol=1e-9,
                                   err_msg=k)
    jrows = np.loadtxt(tmp_path / "j.csv", delimiter=",", ndmin=2)
    trows = np.loadtxt(tmp_path / "t.csv", delimiter=",", ndmin=2)
    assert trows.shape == jrows.shape
    for rt, rj in zip(trows, jrows):
        _assert_rows_equal(rt.tolist(), rj.tolist(), 6)


# ------------------------------------------------- checkpoint and resume

RESUME = dict(SIMFORM, warm_gains=True, trial_timeout=12.5,
              checkpoint_every=4, verbose=False, **CPU64)


def _state_leaves(state) -> dict:
    return tckpt._leaves(convert.sim_state_to_numpy(state))


def test_resume_after_crash_is_bit_identical(tmp_path, monkeypatch):
    """A scripted crash at chunk 24 (after the first dispatch, so the
    gains cache and the warm carry ride the checkpoint), then a resume
    from that checkpoint: the same CSV row and the same final `SimState`
    bits as the uninterrupted trial."""
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


# --------------------------------------------------------------- the CLI

def test_cli_runs_analyzes_and_saves_config(tmp_path, capsys):
    out = tmp_path / "cli.csv"
    rc = ttrials.main(["-f", "simform6", "-m", "1", "-s", "2", "-o",
                       str(out), "--set", "verbose=false", "--set",
                       "device=cpu", "--set", "dtype=float64"])
    assert rc == 0 and out.exists()
    rc = ttrials.main(["--analyze", str(out), "-n", "6", "-m", "1"])
    assert rc == 0
    assert "Completion: 100.00 % (1/1)" in capsys.readouterr().out

    saved = tmp_path / "cfg.yaml"
    assert ttrials.main(["-f", "simform6", "--set", "gain_scale=0.15",
                         "--set", "device=cpu", "--save-config",
                         str(saved)]) == 0
    cfg = ttrials.TrialConfig(formation="simform6", gain_scale=0.15,
                              device="cpu")
    from aclswarm_torch.core import config as configlib
    assert configlib.load_layers(ttrials.TrialConfig, file=saved) == cfg
    again = configlib.load_layers(ttrials.TrialConfig, file=saved,
                                  overrides=["dtype=float64", "seed=4"])
    assert again == dataclasses.replace(cfg, dtype="float64", seed=4)
    with pytest.raises(KeyError, match="unknown TrialConfig key"):
        ttrials.main(["--set", "nonsense=1"])


def test_config_layers_match_the_reference(tmp_path):
    """Both packages resolve the same yaml + overrides to the same field
    values (the port's config has two fields more)."""
    from aclswarm_torch.core import config as tconfig
    from aclswarm_tpu.core import config as jconfig
    path = tmp_path / "c.yaml"
    path.write_text("formation: simform10\nsim_fc: true\nkd: 0.01\n")
    over = ["trials=3", "gain_scale=none", "warm_gains=yes", "tau=0.2"]
    tc = tconfig.load_layers(ttrials.TrialConfig, file=path, overrides=over)
    jc = jconfig.load_layers(jtrials.TrialConfig, file=path, overrides=over)
    td = dataclasses.asdict(tc)
    assert {k: td.pop(k) for k in ("device", "dtype")} \
        == {"device": None, "dtype": "float32"}
    assert td == dataclasses.asdict(jc)


# ------------------------------------------------ fields that still raise

@pytest.mark.parametrize("field,value,item", [
    ("check_mode", "on", "item 12"),
    ("telemetry", "on", "item 12"),
    ("telemetry_dump", "m.jsonl", "item 12"),
    ("profile_dir", "prof", "item 12"),
    ("record_dir", "bags", "item 12"),
])
def test_unported_fields_raise(field, value, item):
    cfg = ttrials.TrialConfig(formation="swarm4", verbose=False,
                              **{field: value}, **CPU64)
    for run in (lambda: ttrials.run_trial(cfg, 0),
                lambda: ttrials.run_trials(cfg)):
        with pytest.raises(NotImplementedError, match=item):
            run()


def test_scenario_field_is_ported():
    """`scenario` (item 13) no longer raises; a family the registry does
    not know is refused before the trial flies, as the reference's is.
    `tests/test_torch_scenarios_trials.py` flies scenarios."""
    cfg = ttrials.TrialConfig(formation="swarm4", verbose=False,
                              scenario="wind", **CPU64)
    ttrials._check_ported(cfg)
    with pytest.raises(ValueError, match="unknown scenario family"):
        ttrials.run_trial(cfg, 0)


# ------------------------------------------------ library, loader, formgen

def test_library_copy_equals_the_reference():
    assert tformations.DEFAULT_LIBRARY != jformations.DEFAULT_LIBRARY
    assert filecmp.cmp(tformations.DEFAULT_LIBRARY,
                       jformations.DEFAULT_LIBRARY, shallow=False)


def _groups():
    import yaml
    with open(jformations.DEFAULT_LIBRARY) as f:
        lib = yaml.safe_load(f)
    return [k for k, v in lib.items() if isinstance(v, dict)]


def _assert_specs_equal(tspecs, jspecs):
    assert [s.name for s in tspecs] == [s.name for s in jspecs]
    for t, j in zip(tspecs, jspecs):
        for f in ("points", "adjmat"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
            assert getattr(t, f).dtype == getattr(j, f).dtype
        assert (t.gains is None) == (j.gains is None)
        if t.gains is not None:
            np.testing.assert_array_equal(t.gains, j.gains)


@pytest.mark.parametrize("group", _groups())
def test_load_group_matches_reference(group):
    _assert_specs_equal(tformations.load_group(None, group),
                        jformations.load_group(None, group))


def test_group_adjmat_override_and_fc_quirk(tmp_path):
    """A group-level ``adjmat`` overrides every formation's own, and the
    string ``fc`` forces full connectivity, in both packages."""
    lib = tmp_path / "lib.yaml"
    lib.write_text(
        "g:\n  agents: 3\n  adjmat: fc\n  formations:\n"
        "    - name: A\n      scale: 2.0\n"
        "      points: [[0,0,0],[3,0,0],[0,3,0]]\n"
        "      adjmat: [[0,1,0],[1,0,1],[0,1,0]]\n"
        "h:\n  agents: 3\n  formations:\n"
        "    - name: B\n      points: [[0,0,0],[3,0,0],[0,3,1]]\n"
        "      adjmat: [[0,1,0],[1,0,1],[0,1,0]]\n")
    for group in ("g", "h"):
        _assert_specs_equal(tformations.load_group(lib, group),
                            jformations.load_group(lib, group))
    (spec,) = tformations.load_group(lib, "g")
    np.testing.assert_array_equal(spec.adjmat, np.ones((3, 3)) - np.eye(3))
    np.testing.assert_array_equal(spec.points[1], [6.0, 0.0, 0.0])
    with pytest.raises(KeyError, match="not in"):
        tformations.load_group(lib, "missing")
    assert tformations.load_formation("B", lib, "h").name == "B"
    form = spec.to_device(device="cpu", dtype=torch.float64)
    assert form.gains.shape == (3, 3, 3, 3) and not form.gains.any()


def test_feasibility_matches_reference():
    stacked = dict(name="stack", points=np.array([[0.0, 0, 0], [0, 0, 2],
                                                  [3, 0, 0]]),
                   adjmat=np.ones((3, 3)) - np.eye(3), gains=None)
    for mod in (tformations, jformations):
        with pytest.raises(ValueError, match="permanent mutual collision"):
            mod.check_feasible(mod.FormationSpec(**stacked), 1.2)
    for spec in tformations.load_group(None, "swarm15"):
        assert tformations.min_planar_separation(spec.points) \
            == jformations.min_planar_separation(spec.points)


@pytest.mark.parametrize("n,seed,fc", [(8, 1, False), (10, 7, False),
                                       (12, 3, True), (4, 2, False)])
def test_generate_specs_matches_reference(n, seed, fc):
    kw = dict(l=15.0, w=15.0, h=2.0, min_dist=2.0, k=3, fc=fc)
    tspecs = tformgen.generate_specs(n, seed=seed, **kw)
    _assert_specs_equal(tspecs, jformgen.generate_specs(n, seed=seed, **kw))
    for s in tspecs:
        assert tformgen.rigidity_rank_2d(s.points, s.adjmat) \
            == jformgen.rigidity_rank_2d(s.points, s.adjmat)
        assert tformgen.is_rigid_2d(s.points, s.adjmat) \
            == jformgen.is_rigid_2d(s.points, s.adjmat)


# ------------------------------------------------------- the supervisor

def _script(kind: str, n: int, dt: float):
    """Per-tick (q, distcmd, ca, event, in_formation) signals of a scripted
    trial: ground, takeoff, hover, then the formation phase that ``kind``
    names; noise from a seed puts values on both sides of each threshold."""
    rng = np.random.default_rng(len(kind))
    ground, air = np.zeros((n, 3)), np.array([[0.0, 0.0, 1.0]] * n)
    quiet, loud = np.zeros(n), np.full(n, 5.0)
    no_ca, all_ca = np.zeros(n, bool), np.ones(n, bool)

    def ticks(secs, q=air, dn=quiet, ca=no_ca, ev=False, inf=None):
        return [(q, dn, ca, ev, inf)] * int(round(secs / dt))

    def noisy(secs, p_event=0.1):
        return [(air + rng.normal(0, 0.5, (n, 3)),
                 np.abs(rng.normal(0.95, 0.1, n)), rng.random(n) < 0.9,
                 bool(rng.random() < p_event), None)
                for _ in range(int(round(secs / dt)))]

    s = ticks(0.6, q=ground)
    s += [(air + rng.normal(0, 0.02, (n, 3)), quiet, no_ca, False, None)
          for _ in range(4)]
    s += ticks(5.1) + ticks(0.1, ev=True)                 # -> FLYING
    if kind == "happy":
        s += noisy(3.0) + ticks(8.0) + noisy(3.0) + ticks(10.0)
    elif kind == "timeout":
        s[-1] = s[-2]
        s += ticks(25.0)
    elif kind == "gridlock":
        s += ticks(2.2, dn=loud, ca=all_ca) + noisy(2.0, 0.0)
        s += ticks(2.0, dn=loud, ca=all_ca) + ticks(10.0)
    elif kind == "in_formation":
        s += ticks(0.5, dn=loud, inf=False) + ticks(0.3, dn=loud, inf=True)
        s += ticks(7.0)
    elif kind == "watchdog":
        s += ticks(45.0, dn=loud)
    return s


@pytest.mark.parametrize("kind", ["happy", "timeout", "gridlock",
                                  "in_formation", "watchdog"])
def test_trial_fsm_matches_reference(kind):
    """Both FSMs stepped on the same signals agree on every action and
    every field each tick; the port's FSM snapshotted mid-way and restored
    into a fresh one continues identically."""
    n, dt, n_form = 3, 0.1, 2 if kind == "happy" else 1
    ctor = dict(n_vehicles=n, n_formations=n_form, takeoff_alt=1.0, dt=dt,
                trial_timeout=40.0)
    t_fsm, j_fsm = tsup.TrialFSM(**ctor), jsup.TrialFSM(**ctor)
    script = _script(kind, n, dt)
    half = len(script) // 2
    for i, (q, dn, ca, ev, inf) in enumerate(script):
        if i == half:
            snap = tckpt.loads(tckpt.dumps(t_fsm.snapshot(), {}))[0]
            t_fsm = tsup.TrialFSM(**ctor).restore(snap)
        assert t_fsm.step(q, dn, ca, ev, inf) == j_fsm.step(q, dn, ca, ev,
                                                            inf), i
        for f in ("state", "timer_ticks", "tick_count", "curr_formation_idx",
                  "received_assignment", "is_logging", "times",
                  "time_avoidance", "assignments"):
            assert getattr(t_fsm, f) == getattr(j_fsm, f), (i, f)
        np.testing.assert_array_equal(t_fsm.dist, j_fsm.dist)
    assert t_fsm.done and j_fsm.done
    assert t_fsm.csv_row(5) == j_fsm.csv_row(5)
    assert tsup.NAMES == jsup.NAMES
