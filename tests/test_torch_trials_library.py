"""The trial harness's host side against the reference, float64 on the
CPU: `run_trials` over two seeds and the CLI (the port's trials, the JAX
run as its own tests run it), the config layers, the formation library
copy, its loader, the random formation generator, and the supervisor
`TrialFSM` stepped on scripted signals. `test_torch_trials.py` holds the
trials themselves, tick for tick.

Serial time of this file on one CPU host: ~110 s, most of it the two
trial-driving tests.
"""
import dataclasses
import filecmp

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference runs on the CPU under conftest)

from aclswarm_torch.harness import formations as tformations
from aclswarm_torch.harness import formgen as tformgen
from aclswarm_torch.harness import supervisor as tsup
from aclswarm_torch.harness import trials as ttrials
from aclswarm_torch.resilience import checkpoint as tckpt
from aclswarm_tpu.harness import formations as jformations
from aclswarm_tpu.harness import formgen as jformgen
from aclswarm_tpu.harness import supervisor as jsup
from aclswarm_tpu.harness import trials as jtrials

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

CPU64 = dict(device="cpu", dtype="float64")


def _assert_rows_equal(row_t, row_j, n):
    assert len(row_t) == len(row_j)
    assert row_t[0] == row_j[0]
    np.testing.assert_allclose(row_t[1:1 + n], row_j[1:1 + n], rtol=0,
                               atol=1e-9)
    assert row_t[1 + n:] == row_j[1 + n:]


# ----------------------------------------------------- run_trials, the CLI

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



# ------------------------------------------------------- config layers

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
