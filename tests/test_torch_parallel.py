"""`aclswarm_torch.parallel` against `aclswarm_tpu.parallel`, float64 on
the CPU.

- The pure functions, parametrised: the mesh's rank count against the
  reference's device count on the virtual 8-device mesh (conftest), the
  worker slices, and every placement tree (all 64 combinations of the
  state's six carries, the formation's, the batched trees) placement for
  placement against the reference's `NamedSharding` trees.
- One spawned two-rank gloo world (a module fixture, `file://` rendezvous
  in a temporary directory, 120 s limit) runs every sharded case once;
  each test then holds one case against the JAX package: the sharded step
  (n=16, an auction every tick), a 50-tick rollout, the batched rollout
  (B=2, n=16, T=40), `sinkhorn_assign` replicated and staged (n=64), the
  flooded CBAA rollout with ``flood_phases`` 1 and 2 (n=8 ring, 60 ticks
  rather than the reference's slow 300), the ``kitchen_sink`` scenario
  (n=16, 16 ticks) and a ``check_mode='on'`` rollout.
- A three-rank world at n=16: the mesh takes two ranks and the third
  holds no rows; every rank's metrics and the gathered final state equal
  the reference's.
- The batch as one program, in both worlds: a B=3 flooded, faulted,
  checked and counted batch (n=16, 24 ticks) through `batched_rollout_fn`
  bit for bit against the unsharded `sim.batched_rollout` and within atol
  1e-12 of the reference's; the same collective calls per tick as trial
  0 alone through `sharded_rollout_fn` (B times the bytes); and the raise
  on trials whose ticks disagree modulo ``assign_every``.

Beyond the reference's cases, a faulted fleet (dead rows, lossy links,
checked and counted) and CBAA with its carried warm tables.

Tolerances: positions, |distcmd|, estimates and CBAA prices atol 1e-12
(float64, the summation order of a row block only); assignments, CBAA
winners, flight modes, ages, the per-tick flags, the invariant codes and
the counters exact; the scenario rollout bit for bit against the
unsharded port and at the scenario tests' atol 1e-9 against the
reference (`tests/test_torch_scenarios.py`).
"""
import dataclasses
import itertools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aclswarm_torch import convert, sim
from aclswarm_torch.core import types as ttypes
from aclswarm_torch.parallel import mesh as tmesh
from aclswarm_torch.parallel import rollout as trollout
from aclswarm_tpu import faults as jfaults
from aclswarm_tpu import gains as jgains
from aclswarm_tpu import scenarios as jscn
from aclswarm_tpu import sim as jsim
from aclswarm_tpu.assignment import sinkhorn as jsinkhorn
from aclswarm_tpu.core.types import ControlGains as JControlGains
from aclswarm_tpu.core.types import SafetyParams as JSafetyParams
from aclswarm_tpu.core.types import make_formation as jmake_formation
from aclswarm_tpu.parallel import mesh as jmesh
from aclswarm_tpu.parallel import rollout as jrollout

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

REPO = Path(__file__).resolve().parents[1]
CPU64 = dict(device="cpu", dtype=torch.float64)
ATOL = 1e-12
WORLD_TIMEOUT_S = 120


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------- problems

def _ring(n, seed):
    """The reference's `tests/test_parallel.py` problem."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    points = np.stack([4 * np.cos(ang), 4 * np.sin(ang),
                       1.0 + 0.3 * np.sin(3 * ang)], 1)
    adj = np.ones((n, n)) - np.eye(n)
    gains = rng.normal(size=(n, n, 3, 3)) * 0.05
    form = jmake_formation(points, adj, gains)
    sp = JSafetyParams(bounds_min=jnp.asarray([-50.0, -50.0, 0.0]),
                       bounds_max=jnp.asarray([50.0, 50.0, 10.0]))
    return form, sp, rng.normal(size=(n, 3)) * 5 + [0, 0, 2.0]


def _flooded_ring():
    """The reference's flooded sharding problem: n=8, ring +-1 +-2
    adjacency, designed gains."""
    rng = np.random.default_rng(2)
    n = 8
    adj = np.zeros((n, n))
    for i in range(n):
        for d in (1, 2):
            adj[i, (i + d) % n] = adj[(i + d) % n, i] = 1
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([3 * np.cos(ang), 3 * np.sin(ang), np.full(n, 1.5)], 1)
    form = jmake_formation(pts, adj, np.asarray(jgains.solve_gains(pts,
                                                                   adj)))
    q0 = rng.normal(size=(n, 3)) * 2.0
    q0[:, 2] = 1.5
    return form, JSafetyParams(), q0


def _kitchen_sink():
    """The reference's `test_sharded_scenario_rollout_bit_parity`."""
    n = 16
    rng = np.random.default_rng(0)
    q0 = rng.normal(size=(n, 3)) * 3
    q0[:, 2] = np.abs(q0[:, 2]) + 2.0
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([6 * np.cos(ang), 6 * np.sin(ang), np.full(n, 2.0)], 1)
    form = jmake_formation(pts, np.ones((n, n)) - np.eye(n))
    sp = JSafetyParams(bounds_min=jnp.asarray([-50.0, -50.0, 0.0]),
                       bounds_max=jnp.asarray([50.0, 50.0, 10.0]))
    return form, sp, q0, jscn.sample("kitchen_sink", 3, n, horizon=16)


FLOODED = dict(assignment="cbaa", localization="flooded",
               dynamics="firstorder")
CHECKED = dict(assignment="sinkhorn", localization="flooded",
               flood_phases=2, colavoid_neighbors=4, assign_every=8,
               check_mode="on", telemetry="on")
CASES = {
    # name: (problem, cfg, init_state kwargs, kind, ticks)
    "step": (lambda: _ring(16, 0), dict(assignment="auction",
                                        assign_every=1), {}, "step", 1),
    "rollout": (lambda: _ring(16, 2), dict(assignment="auction"), {},
                "rollout", 50),
    "flooded_p1": (_flooded_ring, FLOODED, dict(localization=True),
                   "rollout", 60),
    "flooded_p2": (_flooded_ring, dict(FLOODED, flood_phases=2),
                   dict(localization=True), "rollout", 60),
    "checked": (lambda: _ring(16, 4), CHECKED,
                dict(localization=True, checks=True, telemetry=True),
                "rollout", 24),
    # beyond the reference's own cases: a faulted fleet (dead rows, lossy
    # links) and CBAA's carried warm tables
    "faulted": (lambda: _ring(16, 6),
                dict(assignment="sinkhorn", localization="flooded",
                     assign_every=6, check_mode="on", telemetry="on"),
                dict(localization=True, checks=True, telemetry=True,
                     faults=dict(dropout_frac=0.25, drop_tick=3,
                                 rejoin_tick=15, link_loss=0.3)),
                "rollout", 24),
    "cbaa_warm": (lambda: _ring(16, 7),
                  dict(assignment="cbaa", localization="flooded",
                       assign_every=5, colavoid_neighbors=4),
                  dict(localization=True, cbaa_warm=True), "rollout", 16),
}
UNEVEN = {
    "step": CASES["step"],
    "flooded": (lambda: _ring(16, 5),
                dict(assignment="sinkhorn", localization="flooded",
                     flood_phases=2, assign_every=4),
                dict(localization=True), "rollout", 10),
}
BATCH = dict(B=2, n=16, T=40, cfg=dict(assignment="auction",
                                       assign_every=20))
# the batch as one program: flooded, faulted, checked and counted
BATCH3 = dict(B=3, n=16, T=24, cfg=dict(
    assignment="sinkhorn", localization="flooded", flood_phases=2,
    assign_every=6, colavoid_neighbors=4, check_mode="on",
    telemetry="on"))
BATCH3_FAULTS = dict(dropout_frac=0.25, drop_tick=3, rejoin_tick=15,
                     link_loss=0.3)
SINKHORN_N = 64


def _jcase(case):
    problem, cfg, kw, kind, ticks = case
    form, sp, q0 = problem()
    if "faults" in kw:
        kw = dict(kw, faults=jfaults.sample_schedule(
            9, len(q0), dtype=jnp.float64, **kw["faults"]))
    return form, sp, jsim.init_state(jnp.asarray(q0), **kw), \
        jsim.SimConfig(**cfg), kind, ticks


def _port(form, sp, state):
    return (convert.formation_from_numpy(_np(form), **CPU64),
            convert.safety_params_from_numpy(_np(sp)),
            convert.sim_state_from_numpy(_np(state), **CPU64))


def _batch_problem():
    probs = [_ring(BATCH["n"], 10 + b) for b in range(BATCH["B"])]
    form = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in probs])
    state = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[jsim.init_state(jnp.asarray(p[2]))
                           for p in probs])
    return form, probs[0][1], state


def _batch3_problem():
    """B=3 rings, each with its own start and fault schedule."""
    probs = [_ring(BATCH3["n"], 20 + b) for b in range(BATCH3["B"])]
    form = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in probs])
    state = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jsim.init_state(jnp.asarray(p[2]), localization=True, checks=True,
                        telemetry=True, faults=jfaults.sample_schedule(
                            30 + b, BATCH3["n"], dtype=jnp.float64,
                            **BATCH3_FAULTS))
        for b, p in enumerate(probs)])
    return form, probs[0][1], state


def _batch3_inputs() -> dict:
    """The batch, trial 0 alone (the B=1 collective calls) and the batch
    with trial 1 one tick ahead (the phase raise)."""
    form, sp, state = _batch3_problem()
    tform, tsp, tstate = _port(form, sp, state)
    out = {"batch3": dict(kind="batched_any", ticks=BATCH3["T"],
                          cfg=BATCH3["cfg"], form=tform, sp=tsp,
                          state=tstate),
           "batch3_trial0": dict(kind="rollout", ticks=BATCH3["T"],
                                 cfg=BATCH3["cfg"],
                                 form=ttypes.row(tform, 0), sp=tsp,
                                 state=sim.trial(tstate, 0))}
    late = dataclasses.replace(tstate, tick=tstate.tick + np.asarray(
        [0, 1, 0]))
    out["batch3_phase"] = dict(kind="batched_bad", ticks=2,
                               cfg=BATCH3["cfg"], form=tform, sp=tsp,
                               state=late)
    return out


def _sinkhorn_problem():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(SINKHORN_N, 3)) * 10,
            rng.normal(size=(SINKHORN_N, 3)) * 10)


def _inputs(cases) -> dict:
    """Every case's port inputs, from the reference's objects."""
    out = {}
    for name, case in cases.items():
        form, sp, state, cfg, kind, ticks = _jcase(case)
        tform, tsp, tstate = _port(form, sp, state)
        out[name] = dict(kind=kind, ticks=ticks, cfg=case[1],
                         form=tform, sp=tsp, state=tstate)
    return out


def _all_inputs() -> dict:
    out = _inputs(CASES)
    form, sp, q0, scen = _kitchen_sink()
    tform, tsp, tstate = _port(form, sp, jsim.init_state(jnp.asarray(q0),
                                                         scenario=scen))
    out["kitchen_sink"] = dict(kind="rollout", ticks=16,
                               cfg=dict(assignment="auction",
                                        assign_every=4),
                               form=tform, sp=tsp, state=tstate)
    form, sp, state = _batch_problem()
    tform, tsp, tstate = _port(form, sp, state)
    out["batched"] = dict(kind="batched", ticks=BATCH["T"], cfg=BATCH["cfg"],
                          form=tform, sp=tsp, state=tstate)
    q, p = _sinkhorn_problem()
    out["sinkhorn"] = dict(kind="sinkhorn", q=torch.as_tensor(q),
                           p=torch.as_tensor(p))
    out.update(_batch3_inputs())
    return out


# --------------------------------------------------------------- the world

# one rank of the world: every case of inputs.pt, results to out<rank>.pt
WORKER = r"""
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                        rank=rank, world_size=world)
from aclswarm_torch import sim
from aclswarm_torch.assignment import sinkhorn
from aclswarm_torch.core.types import ControlGains
from aclswarm_torch.parallel import collectives as coll
from aclswarm_torch.parallel import mesh as M
from aclswarm_torch.parallel import rollout as R

out = {}
for name, c in torch.load(f"{d}/inputs.pt", weights_only=False).items():
    if c["kind"] == "sinkhorn":
        q, p = c["q"], c["p"]
        mesh = M.make_mesh(n_agents=q.shape[0], device="cpu")
        lo, hi = mesh.rows(q.shape[0])
        whole = coll.gather(q[lo:hi], mesh)
        out[name] = {
            "replicated": sinkhorn.sinkhorn_assign(whole, p).row_to_col,
            "staged": sinkhorn.sinkhorn_assign(q, p, stage_shardings=(
                M.row_sharding(mesh), M.replicated(mesh))).row_to_col}
        continue
    if c["kind"] == "staged":
        mesh = M.make_mesh(n_agents=c["q"].shape[0], device="cpu")
        out[name] = {"mesh": mesh.size, "result": sinkhorn.sinkhorn_assign(
            c["q"], c["p"], stage_shardings=(M.row_sharding(mesh),
                                             M.replicated(mesh)))}
        continue
    n = c["form"].points.shape[-2]
    mesh = M.make_mesh(n_agents=n, device="cpu")
    cfg = sim.SimConfig(**c["cfg"])
    args = (ControlGains(), c["sp"], cfg)
    if c["kind"] == "batched":
        st_sh = R.batched_sim_state_sharding(mesh)
        form = M.place(c["form"], R.batched_formation_sharding(mesh), n)
        local = M.place(c["state"], st_sh, n)
        fn = R.batched_rollout_fn(mesh, form, *args, c["ticks"])
    else:
        local, form, st_sh, _ = M.shard_problem(c["state"], c["form"], mesh)
        fn = (R.sharded_step_fn(mesh, form, *args) if c["kind"] == "step"
              else R.sharded_rollout_fn(mesh, form, *args, c["ticks"])
              if c["kind"] == "rollout"
              else R.batched_rollout_fn(mesh, form, *args, c["ticks"]))
    if c["kind"] == "batched_bad":
        try:
            fn(local)
        except ValueError as e:
            out[name] = {"raised": str(e)}
        else:
            out[name] = {"raised": None}
        continue
    coll.reset_stats()
    final, metrics = fn(local)
    moved = coll.stats()
    out[name] = {"final": M.gather_state(final, st_sh), "metrics": metrics,
                 "mesh": mesh.size, "rows": mesh.rows(n), "stats": moved}
torch.save(out, f"{d}/out{rank}.pt")
dist.destroy_process_group()
"""


def _world(tmp: Path, world: int, inputs: dict) -> list[dict]:
    """Run every case of ``inputs`` on a ``world``-rank gloo world; each
    rank's results."""
    torch.save(inputs, tmp / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(tmp),
                               str(r), str(world)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=WORLD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (o, e)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o}\n{e[-4000:]}"
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _world(tmp_path_factory.mktemp("world2"), 2, _all_inputs())


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    q, p = _sinkhorn_problem()
    return _world(tmp_path_factory.mktemp("world3"), 3,
                  dict(_inputs(UNEVEN), **_batch3_inputs(),
                       staged=dict(kind="staged", q=torch.as_tensor(q),
                                   p=torch.as_tensor(p))))


# --------------------------------------------------------------- reference

def _jrun(case):
    form, sp, state, cfg, kind, ticks = _jcase(case)
    if kind == "step":
        out, m = jax.jit(lambda s: jsim.step(s, form, JControlGains(), sp,
                                             cfg))(state)
        return out, jax.tree.map(lambda x: x[None], m)
    return jsim.rollout(state, form, JControlGains(), sp, cfg, ticks)


def _check_final(final, jfinal, est=False):
    np.testing.assert_allclose(final.swarm.q.numpy(),
                               np.asarray(jfinal.swarm.q), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(final.v2f.numpy(), np.asarray(jfinal.v2f))
    np.testing.assert_array_equal(final.flight.mode.numpy(),
                                  np.asarray(jfinal.flight.mode))
    if est:
        np.testing.assert_allclose(final.loc.est.numpy(),
                                   np.asarray(jfinal.loc.est), rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(final.loc.age.numpy(),
                                      np.asarray(jfinal.loc.age))


def _check_metrics(m, jm, step=False):
    for k in ("q", "distcmd_norm"):
        got = getattr(m, k).numpy()
        np.testing.assert_allclose(got[None] if step else got,
                                   np.asarray(getattr(jm, k)), rtol=0,
                                   atol=ATOL, err_msg=k)
    for k in ("v2f", "mode", "ca_active", "auctioned", "assign_valid",
              "reassigned"):
        got = getattr(m, k).numpy()
        np.testing.assert_array_equal(got[None] if step else got,
                                      np.asarray(getattr(jm, k)), err_msg=k)


def _same_on_every_rank(results, name):
    for r in results[1:]:
        for k in ("q", "v2f", "distcmd_norm", "mode"):
            assert torch.equal(getattr(results[0][name]["metrics"], k),
                               getattr(r[name]["metrics"], k)), k


# --------------------------------------------------------------- pure

@pytest.mark.parametrize("n_devices,n_agents",
                         [(None, None), (None, 16), (None, 12), (None, 7),
                          (4, None), (4, 6), (3, 16), (1, 8), (8, 1000)])
def test_mesh_size_matches_reference(n_devices, n_agents):
    ref = jmesh.make_mesh(n_devices=n_devices, n_agents=n_agents)
    assert tmesh.mesh_size(len(jax.devices()), n_devices, n_agents) \
        == len(ref.devices.ravel())


def test_make_mesh_without_runtime_is_one_rank():
    mesh = tmesh.make_mesh(n_agents=12, device="cpu")
    assert (mesh.size, mesh.index, mesh.rows(12), mesh.group) \
        == (1, 0, (0, 12), None)


@pytest.mark.parametrize("n_slices,n_devs", [(1, 1), (4, 1), (2, 8),
                                             (3, 8), (8, 8), (5, 2),
                                             (3, 4)])
def test_slice_devices_matches_reference(n_slices, n_devs):
    devs = list(range(n_devs))
    assert tmesh.slice_devices(n_slices, devs) \
        == jmesh.slice_devices(n_slices, devs)


def _specs(tree, path=""):
    """{field path: the leaf's spec as a tuple} of a placement tree of
    either package (None for an absent carry)."""
    if tree is None:
        return {path: None}
    if isinstance(tree, tmesh.Placement):
        return {path: tree.spec}
    if hasattr(tree, "spec") and hasattr(tree, "mesh"):    # NamedSharding
        return {path: tuple(tree.spec)}
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
    else:
        names = list(tree._fields)
    out = {}
    for k in names:
        out.update(_specs(getattr(tree, k), f"{path}.{k}"))
    return out


FLAGS = ("localization", "faults", "checks", "telemetry", "scenario",
         "cbaa_warm")


@pytest.mark.parametrize("on", list(itertools.product((False, True),
                                                      repeat=6)),
                         ids=lambda on: "".join("01"[b] for b in on))
def test_sim_state_sharding_matches_reference(on):
    kw = dict(zip(FLAGS, on))
    ref = _specs(jmesh.sim_state_sharding(jmesh.make_mesh(), **kw))
    got = _specs(tmesh.sim_state_sharding(
        tmesh.make_mesh(device="cpu"), **kw))
    assert got == ref


def test_formation_and_batched_shardings_match_reference():
    jm, tm = jmesh.make_mesh(), tmesh.make_mesh(device="cpu")
    assert _specs(tmesh.formation_sharding(tm)) \
        == _specs(jmesh.formation_sharding(jm))
    assert _specs(trollout.batched_formation_sharding(tm)) \
        == _specs(jrollout.batched_formation_sharding(jm))
    for loc, chk in itertools.product((False, True), repeat=2):
        assert _specs(trollout.batched_sim_state_sharding(
            tm, localization=loc, checks=chk)) == _specs(
            jrollout.batched_sim_state_sharding(jm, localization=loc,
                                                checks=chk))


def test_place_and_gather_round_trip_one_rank():
    form, sp, state = _port(*_batch_problem())
    mesh = tmesh.make_mesh(device="cpu")
    st_sh = trollout.batched_sim_state_sharding(mesh)
    back = tmesh.gather_state(tmesh.place(state, st_sh, 16), st_sh)
    assert torch.equal(back.swarm.q, state.swarm.q)
    assert np.array_equal(back.tick, state.tick)


def test_staged_sinkhorn_rejects_other_placements():
    from aclswarm_torch.assignment import sinkhorn
    mesh = tmesh.make_mesh(device="cpu")
    q = torch.zeros(4, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="stage_shardings"):
        sinkhorn.sinkhorn_assign(q, q, stage_shardings=(
            tmesh.replicated(mesh), tmesh.replicated(mesh)))


# --------------------------------------------------------------- two ranks

@pytest.mark.parametrize("name", ["step", "rollout", "flooded_p1",
                                  "flooded_p2", "checked", "faulted",
                                  "cbaa_warm"])
def test_sharded_rollout_matches_reference(two_ranks, name):
    jfinal, jm = _jrun(CASES[name])
    res = two_ranks[0][name]
    assert [r[name]["mesh"] for r in two_ranks] == [2, 2]
    for r in two_ranks:
        _check_final(r[name]["final"], jfinal,
                     est=CASES[name][2].get("localization", False))
    _check_metrics(res["metrics"], jm, step=name == "step")
    _same_on_every_rank(two_ranks, name)
    if name == "faulted":
        np.testing.assert_array_equal(res["metrics"].alive.numpy(),
                                      np.asarray(jm.alive))
        np.testing.assert_array_equal(res["metrics"].fault_event.numpy(),
                                      np.asarray(jm.fault_event))
        assert not np.asarray(jm.alive).all()
    if name == "cbaa_warm":
        warm = res["final"].cbaa_warm
        np.testing.assert_array_equal(warm.who.numpy(),
                                      np.asarray(jfinal.cbaa_warm.who))
        np.testing.assert_allclose(warm.price.numpy(),
                                   np.asarray(jfinal.cbaa_warm.price),
                                   rtol=0, atol=ATOL)
    if name in ("checked", "faulted"):
        final = res["final"]
        assert int(final.inv.code) == int(jfinal.inv.code)
        assert int(final.inv.tick) == int(jfinal.inv.tick)
        for k in ("auctions", "assign_rounds", "reassigns", "ca_ticks",
                  "flood_stale_max"):
            assert int(getattr(final.tel, k)) \
                == int(np.asarray(getattr(jfinal.tel, k))), k
        np.testing.assert_array_equal(res["metrics"].inv_code.numpy(),
                                      np.asarray(jm.inv_code))


def test_sharded_batched_rollout_matches_reference(two_ranks):
    form, sp, state = _batch_problem()
    cfg = jsim.SimConfig(**BATCH["cfg"])
    jfinal, jm = jsim.batched_rollout(jax.tree.map(jnp.copy, state), form,
                                      JControlGains(), sp, cfg, BATCH["T"])
    res = two_ranks[0]["batched"]
    np.testing.assert_allclose(res["final"].swarm.q.numpy(),
                               np.asarray(jfinal.swarm.q), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(res["final"].v2f.numpy(),
                                  np.asarray(jfinal.v2f))
    assert res["metrics"].q.shape == (BATCH["T"], BATCH["B"], BATCH["n"], 3)
    _check_metrics(res["metrics"], jm)
    _same_on_every_rank(two_ranks, "batched")


def test_sharded_and_staged_sinkhorn_match_reference(two_ranks):
    q, p = _sinkhorn_problem()
    ref = np.asarray(jsinkhorn.sinkhorn_assign(jnp.asarray(q),
                                               jnp.asarray(p)).row_to_col)
    for r in two_ranks:
        for k in ("replicated", "staged"):
            np.testing.assert_array_equal(r["sinkhorn"][k].numpy(), ref,
                                          err_msg=k)


def test_sharded_scenario_rollout_bit_parity(two_ranks):
    form, sp, q0, scen = _kitchen_sink()
    cfg = dict(assignment="auction", assign_every=4)
    jstate = jsim.init_state(jnp.asarray(q0), scenario=scen)
    jfinal, jm = jsim.rollout(jstate, form, JControlGains(), sp,
                              jsim.SimConfig(**cfg), 16)
    tform, tsp, tstate = _port(form, sp, jstate)
    final, m = sim.rollout(tstate, tform, ttypes.ControlGains(), tsp,
                           sim.SimConfig(**cfg), 16)
    res = two_ranks[0]["kitchen_sink"]
    assert torch.equal(res["final"].swarm.q, final.swarm.q)
    assert torch.equal(res["metrics"].v2f, m.v2f)
    assert torch.equal(res["metrics"].q, m.q)
    np.testing.assert_array_equal(m.v2f.numpy(), np.asarray(jm.v2f))
    np.testing.assert_allclose(m.q.numpy(), np.asarray(jm.q), rtol=0,
                               atol=1e-9)


# --------------------------------------------------------------- uneven

@pytest.mark.parametrize("name", list(UNEVEN))
def test_uneven_world_third_rank_holds_nothing(three_ranks, name):
    jfinal, jm = _jrun(UNEVEN[name])
    assert [r[name]["mesh"] for r in three_ranks] == [2, 2, 2]
    assert three_ranks[2][name]["rows"] == (0, 0)
    for r in three_ranks:
        _check_final(r[name]["final"], jfinal,
                     est=UNEVEN[name][2].get("localization", False))
        _check_metrics(r[name]["metrics"], jm, step=name == "step")


def test_staged_sinkhorn_uneven_world(three_ranks):
    """The staged solve on a mesh of two ranks of three: the rank outside
    the mesh receives the mesh's result (`collectives.spill`)."""
    q, p = _sinkhorn_problem()
    ref = jsinkhorn.sinkhorn_assign(jnp.asarray(q), jnp.asarray(p))
    assert [r["staged"]["mesh"] for r in three_ranks] == [2, 2, 2]
    first = three_ranks[0]["staged"]["result"]
    for r in three_ranks:
        got = r["staged"]["result"]
        np.testing.assert_array_equal(got.row_to_col.numpy(),
                                      np.asarray(ref.row_to_col))
        assert torch.equal(got.plan_log, first.plan_log)
        assert torch.equal(got.err, first.err)
    np.testing.assert_allclose(first.plan_log.numpy(),
                               np.asarray(ref.plan_log), rtol=0, atol=1e-10)


# --------------------------------------------------------------- the batch

WORLDS = ["two_ranks", "three_ranks"]


@pytest.fixture(scope="module")
def batch3_reference():
    """The unsharded port's and the reference's batched rollouts."""
    form, sp, state = _batch3_problem()
    tform, tsp, tstate = _port(form, sp, state)
    port = sim.batched_rollout(tstate, tform, ttypes.ControlGains(), tsp,
                               sim.SimConfig(**BATCH3["cfg"]), BATCH3["T"])
    ref = jsim.batched_rollout(jax.tree.map(jnp.copy, state), form,
                               JControlGains(), sp,
                               jsim.SimConfig(**BATCH3["cfg"]), BATCH3["T"])
    return port, ref


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_batch_equals_unsharded_batch(world, batch3_reference,
                                              request):
    results = request.getfixturevalue(world)
    (final, m), _ = batch3_reference
    for r in results:
        got, gm = r["batch3"]["final"], r["batch3"]["metrics"]
        for a, b in ((got.swarm.q, final.swarm.q), (got.v2f, final.v2f),
                     (got.loc.est, final.loc.est),
                     (got.loc.age, final.loc.age),
                     (got.flight.mode, final.flight.mode),
                     (got.inv.code, final.inv.code),
                     (got.tel.ca_ticks, final.tel.ca_ticks)):
            assert torch.equal(a, b)
        for k in ("q", "distcmd_norm", "v2f", "mode", "ca_active",
                  "auctioned", "assign_valid", "reassigned", "alive",
                  "fault_event", "inv_code"):
            assert torch.equal(getattr(gm, k), getattr(m, k)), k
        assert np.array_equal(got.tick, final.tick)
    assert not m.alive.all() and m.auctioned.any()


def test_sharded_batch_matches_reference(two_ranks, batch3_reference):
    _, (jfinal, jm) = batch3_reference
    res = two_ranks[0]["batch3"]
    assert res["metrics"].q.shape == (BATCH3["T"], BATCH3["B"],
                                      BATCH3["n"], 3)
    _check_final(res["final"], jfinal, est=True)
    _check_metrics(res["metrics"], jm)
    np.testing.assert_array_equal(res["metrics"].alive.numpy(),
                                  np.asarray(jm.alive))
    np.testing.assert_array_equal(res["metrics"].inv_code.numpy(),
                                  np.asarray(jm.inv_code))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_batch_calls_do_not_depend_on_batch(world, request):
    """B=3 makes trial 0's collective calls per tick and moves B times
    its bytes (the spill's shape header excepted)."""
    for r in request.getfixturevalue(world):
        one, three = r["batch3_trial0"]["stats"], r["batch3"]["stats"]
        assert {k: v["calls"] for k, v in three.items()} \
            == {k: v["calls"] for k, v in one.items()}
        for k in ("gather", "reduce", "broadcast"):
            assert three[k]["bytes"] == BATCH3["B"] * one[k]["bytes"], k
        kinds = ("spill",) if r["batch3"]["rows"] == (0, 0) \
            else ("gather", "reduce", "broadcast")
        assert all(one[k]["calls"] > 0 for k in kinds), one


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_batch_rejects_disagreeing_phases(world, request):
    for r in request.getfixturevalue(world):
        assert "assign_every=6" in r["batch3_phase"]["raised"]


def test_disagreeing_phases_raise_before_any_collective():
    form, sp, state = _port(*_batch3_problem())
    mesh = tmesh.make_mesh(device="cpu")
    cfg = sim.SimConfig(**BATCH3["cfg"])
    fn = trollout.batched_rollout_fn(mesh, form, ttypes.ControlGains(), sp,
                                     cfg, 1)
    for ticks, what in (([0, 6, 12], None), ([0, 2, 4], "assign_every=6"),
                        ([0, 6, 7], "assign_every=6")):
        st = dataclasses.replace(state, tick=np.asarray(ticks, np.int64))
        if what is None:
            fn(st)
        else:
            with pytest.raises(ValueError, match=what):
                fn(st)
    truth = sim.SimConfig(assignment="sinkhorn", assign_every=6,
                          flood_every=4)
    trollout._check_phases(np.asarray([0, 6]), truth)
    with pytest.raises(ValueError, match="flood_every=4"):
        trollout._check_phases(np.asarray([0, 6]), dataclasses.replace(
            truth, localization="flooded"))
