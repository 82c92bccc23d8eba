"""The comparison that decides ``correct``, on the CPU at a tiny size with
each cell's own limits: the port passes it, and the control (the
reference in bfloat16 in the program's place) and a broken timed path
fail it."""
import dataclasses

import pytest
import torch

from swarmbench import run as runmod
from swarmbench import harness, judge
from tiny import CELLS, tiny_cell

SEED = 2**31 + 977


def run(cell):
    return runmod.run_cell(cell.name, SEED, 0.5, False, device="cpu",
                           bench={"per_layer": []}, cell=cell)


@pytest.mark.parametrize("name", CELLS)
def test_port_passes_the_reference(name):
    res = run(tiny_cell(name))
    bad = {k: v for k, v in res["checks"].items()
           if v["value"] is None or v["value"] > v["limit"]}
    assert res["correct"], bad
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails(name):
    cell = tiny_cell(name)
    S = harness.build(cell.config, cell.traffic, SEED, "cpu")
    cap, recs, carry = judge.replay(S, SEED, 3)
    nums = judge.tick_numbers(S, cap, recs, carry, control=torch.bfloat16)
    nums.update(judge.gain_numbers(S, S.gains, SEED))
    nums["replay_diff"] = 0
    ok, checks = judge.checks(nums, cell.workload["limits"])
    assert not ok, checks
    failing = [k for k, v in checks.items() if v["value"] > v["limit"]]
    assert {"state_err", "align_excess"} <= set(failing)


def _broken_step(kind):
    from aclswarm_torch.sim import engine

    orig = engine.step

    def step(state, *a, **kw):
        new, m = orig(state, *a, **kw)
        if kind == "unchanged":
            return dataclasses.replace(new, swarm=state.swarm,
                                       goal=state.goal, loc=state.loc), m
        if kind == "half_batch":
            half = state.swarm.q.shape[0] // 2

            def keep(x, y):
                x = x.clone()
                x[half:] = y[half:]
                return x
            swarm = dataclasses.replace(
                new.swarm, q=keep(new.swarm.q, state.swarm.q),
                vel=keep(new.swarm.vel, state.swarm.vel))
            return dataclasses.replace(new, swarm=swarm), m
        q = new.swarm.q.clone()
        q[..., 3, 0] += 0.05                    # one answer altered
        return dataclasses.replace(
            new, swarm=dataclasses.replace(new.swarm, q=q)), m
    return step


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_broken_timed_path_fails(name, kind, monkeypatch):
    from aclswarm_torch.sim import engine

    monkeypatch.setattr(engine, "step", _broken_step(kind))
    res = run(tiny_cell(name))
    assert not res["correct"]
    assert res["checks"]["state_err"]["value"] > \
        res["checks"]["state_err"]["limit"]


def test_reference_design_is_the_ports_in_float64():
    import numpy as np

    from aclswarm_torch.gains import solve_gains
    from swarmbench.reference import gains as refgains

    cell = tiny_cell(CELLS[0])
    tr = harness.build(cell.config, cell.traffic, SEED, "cpu").trials[0]
    n = tr["points"].shape[0]
    R = refgains.design(torch.as_tensor(tr["points"]),
                        torch.as_tensor(tr["adj"]))
    P = solve_gains(np.asarray(tr["points"], np.float64), tr["adj"],
                    max_nonedges=n - 4, device="cpu")
    assert float(torch.linalg.matrix_norm(P - R)
                 / torch.linalg.matrix_norm(R)) < 1e-12


def _broken_design(kind):
    orig = harness.design_gains
    seen = []

    def design(cfg, trial, device):
        g = orig(cfg, trial, device)
        seen.append(g)
        if kind == "scale":
            return g * 1.01
        if kind == "other_trial" and len(seen) > 1:
            return seen[0]
        return g
    return design


@pytest.mark.parametrize("kind", ["scale", "other_trial"])
def test_broken_gain_design_fails(kind, monkeypatch):
    monkeypatch.setattr(harness, "design_gains", _broken_design(kind))
    res = run(tiny_cell(CELLS[0]))
    assert not res["correct"]
    bad = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    assert bad & {"gain_gap", "gain_trace", "gain_kernel", "gain_offgraph"}


def test_sampled_ticks_lie_in_the_flown_chunks():
    traffic = {"chunk": 10, "segment_ticks": 100}
    for seed in range(2**31, 2**31 + 50):
        ticks, sc = judge.sample_ticks(seed, traffic, 4)
        assert (0, 0) in ticks and max(k for k, _ in ticks) < 4 and sc < 4
        ticks, sc = judge.sample_ticks(seed, traffic, 40)
        assert max(k for k, _ in ticks) < 10 and sc < 10
