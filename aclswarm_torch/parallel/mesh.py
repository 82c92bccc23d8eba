"""The agent-axis layout over `torch.distributed` (port of
`aclswarm_tpu/parallel/mesh.py`).

The model is torch's own: one process per device, every rank running the
same program over a process group. The 1-D ``agents`` axis is the group's
ranks: a row-sharded leaf holds the rank's own contiguous block of agent
rows, a replicated leaf is whole on every rank. `sim_state_sharding` and
`formation_sharding` give a `SimState`- or `Formation`-shaped tree of
`Placement`s, leaf for leaf the reference's `NamedSharding` trees; a
`Placement`'s ``spec`` is the reference's `PartitionSpec` as a tuple
(``("agents",)`` row-sharded, ``()`` replicated).

A `DeviceMesh` with `Shard(0)`/`Replicate()` would say the same, but the
engine's stages are not DTensor ops (K1/K2/K3 launches, host-polled
loops, `torch.where` masks), so the layout is only a description here:
`parallel.rollout` moves the data, each collective an explicit call in
`parallel.collectives`.

`make_mesh` takes the largest rank count that divides the agents, as the
reference takes the largest device count. Ranks past it hold no rows and
receive every replicated output from the mesh's first rank
(`collectives.spill`).
"""
from __future__ import annotations

import dataclasses
import os

import torch

from aclswarm_torch import sim
from aclswarm_torch.analysis.invariants import InvariantState
from aclswarm_torch.assignment.cbaa import CbaaTables
from aclswarm_torch.control import TrajGoal
from aclswarm_torch.core.types import Formation, SwarmState, resolve_device
from aclswarm_torch.faults.schedule import FaultSchedule
from aclswarm_torch.parallel import collectives as coll
from aclswarm_torch.scenarios.timeline import Scenario
from aclswarm_torch.telemetry.device import ChunkTelemetry

AGENT_AXIS = "agents"


@dataclasses.dataclass(eq=False)
class AgentMesh:
    """The ranks ``ranks`` (world ranks, in agent order) over the agent
    axis, seen from one process: its world ``rank``, its ``device``, the
    mesh's process ``group`` (None without a distributed runtime: a
    one-process mesh whose collectives are the identity) and the
    ``spill_group`` joining the mesh's first rank to the ranks outside it
    (None when there are none)."""

    ranks: tuple
    rank: int
    world_size: int
    device: torch.device
    group: object = None
    spill_group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int | None:
        """This process's position on the agent axis (None: outside)."""
        return self.ranks.index(self.rank) if self.rank in self.ranks \
            else None

    def rows(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's agent rows; (0, 0) outside the mesh."""
        if n % self.size:
            raise ValueError(f"{n} agents do not divide over a mesh of "
                             f"{self.size} ranks (make_mesh(n_agents=n))")
        if self.index is None:
            return 0, 0
        per = n // self.size
        return self.index * per, (self.index + 1) * per


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """How a leaf lies on ``mesh``: ``spec`` names each axis's mesh axis
    (the reference's `PartitionSpec`): ``("agents",)`` row-sharded, ``()``
    replicated, ``(None, "agents")`` a trial-batched row-sharded leaf."""

    mesh: AgentMesh
    spec: tuple

    @property
    def axis(self) -> int | None:
        """The agent-sharded axis, None when replicated."""
        return self.spec.index(AGENT_AXIS) if AGENT_AXIS in self.spec \
            else None

    def __eq__(self, other) -> bool:
        return isinstance(other, Placement) and other.mesh is self.mesh \
            and other.spec == self.spec

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))


def mesh_size(n_ranks: int, n_devices: int | None = None,
              n_agents: int | None = None) -> int:
    """The reference's rule (`mesh.py:28-46`): the first ``n_devices`` of
    ``n_ranks``, then the largest count that divides ``n_agents``."""
    k = n_ranks if n_devices is None else min(n_ranks, n_devices)
    if n_agents is not None:
        while k > 1 and n_agents % k != 0:
            k -= 1
    return max(1, k)


def rank_device(device=None) -> torch.device:
    """This process's device: ``device`` if given, else its card
    (``LOCAL_RANK`` modulo the visible cards; two ranks on one card share
    it). No card and no ``device`` raises (`resolve_device`)."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", _world()[1]))
    return torch.device("cuda", local % torch.cuda.device_count())


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: int | None = None, n_agents: int | None = None,
              device=None) -> AgentMesh:
    """A 1-D agent mesh over the process group's first ranks (all by
    default; `mesh_size`). Under a distributed runtime every rank must
    call it, in the same order as its other group calls: a mesh smaller
    than the world makes its groups with `torch.distributed.new_group`."""
    import torch.distributed as dist

    world, rank = _world()
    k = mesh_size(world, n_devices, n_agents)
    group = spill = None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if k == world \
            else dist.new_group(list(range(k)))
        if k < world:
            spill = dist.new_group([0] + list(range(k, world)))
    return AgentMesh(ranks=tuple(range(k)), rank=rank, world_size=world,
                     device=rank_device(device), group=group,
                     spill_group=spill)


def slice_devices(n_slices: int, devices: list | None = None
                  ) -> list[list]:
    """Partition ``devices`` (default: every visible card) into
    ``n_slices`` worker slices, the reference's rule (`mesh.py:49-73`):
    with at least one device per slice a contiguous split, the remainder
    over the leading slices; with fewer devices than slices, slices share
    devices round-robin (every slice still names one)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    n_slices = max(1, int(n_slices))
    if not devs:
        return [[] for _ in range(n_slices)]
    if len(devs) >= n_slices:
        base, extra = divmod(len(devs), n_slices)
        out, at = [], 0
        for i in range(n_slices):
            take = base + (1 if i < extra else 0)
            out.append(devs[at:at + take])
            at += take
        return out
    return [[devs[i % len(devs)]] for i in range(n_slices)]


def row_sharding(mesh: AgentMesh) -> Placement:
    """Leading axis = agents, sharded."""
    return Placement(mesh, (AGENT_AXIS,))


def replicated(mesh: AgentMesh) -> Placement:
    return Placement(mesh, ())


def sim_state_sharding(mesh: AgentMesh, localization: bool = False,
                       faults: bool = False, checks: bool = False,
                       telemetry: bool = False, scenario: bool = False,
                       cbaa_warm: bool = False) -> sim.SimState:
    """Placement tree for `sim.SimState`, each flag matching the state's
    optional carry as in the reference: per-agent rows row-sharded (q,
    vel, goal, v2f, flight, the estimate tables by owning agent, the fault
    timelines and ``link_loss`` by receiver, ``byz_mask``, the CBAA
    tables by owning agent); the tick, keys, scenario tracks and scalars,
    and the ``inv`` and ``tel`` carries replicated."""
    row = row_sharding(mesh)
    rep = replicated(mesh)
    loc = sim.EstimateTable(est=row, age=row) if localization else None
    fsched = FaultSchedule(drop_tick=row, rejoin_tick=row, link_loss=row,
                           key=rep) if faults else None
    scen = Scenario(
        obs_center=rep, obs_vel=rep, obs_radius=rep, obs_appear=rep,
        obs_vanish=rep, wind_vel=rep, gust_std=rep, wind_tick=rep,
        noise_std=rep, noise_tick=rep, seq_points=rep, seq_tick=rep,
        byz_mask=row, byz_std=rep, byz_tick=rep, drift_vel=rep,
        drift_tick=rep, rematch_every=rep, key=rep) if scenario else None
    return sim.SimState(
        swarm=SwarmState(q=row, vel=row),
        goal=TrajGoal(pos=row, vel=row, yaw=row, dyaw=row),
        v2f=row, tick=rep,
        flight=sim.FlightState(mode=row, ticks_in_mode=row,
                               initial_alt=row, takeoff_alt=row),
        loc=loc, first_auction=rep, assign_enabled=rep, faults=fsched,
        scenario=scen,
        inv=InvariantState(code=rep, tick=rep) if checks else None,
        tel=ChunkTelemetry(auctions=rep, assign_rounds=rep, reassigns=rep,
                           ca_ticks=rep, flood_stale_max=rep,
                           admm_iters=rep, admm_residual=rep)
        if telemetry else None,
        cbaa_warm=CbaaTables(price=row, who=row) if cbaa_warm else None)


def formation_sharding(mesh: AgentMesh) -> Formation:
    """Placement tree for `Formation`: adjmat, gains and the desired
    distances row-sharded by formation point, the points replicated."""
    row = row_sharding(mesh)
    return Formation(points=replicated(mesh), adjmat=row, gains=row,
                     dstar_xy=row, dstar_z=row)


def batch_axis(placements):
    """A placement tree lifted to trial-batched leaves (a leading (B,)
    axis): the trial axis replicated, the agent axis placed as before."""
    return map_placements(
        lambda p: Placement(p.mesh, (None,) + p.spec), placements)


def state_sharding_of(state: sim.SimState, mesh: AgentMesh) -> sim.SimState:
    """`sim_state_sharding` with every flag read off ``state``, lifted by
    `batch_axis` for a batch of trials (a (B, n) ``v2f``)."""
    sh = sim_state_sharding(
        mesh, localization=state.loc is not None,
        faults=state.faults is not None, checks=state.inv is not None,
        telemetry=state.tel is not None,
        scenario=state.scenario is not None,
        cbaa_warm=state.cbaa_warm is not None)
    return batch_axis(sh) if state.v2f.ndim > 1 else sh


def _local(x: torch.Tensor, p: Placement, n: int) -> torch.Tensor:
    x = x.to(p.mesh.device)
    if p.axis is None:
        return x
    lo, hi = p.mesh.rows(n)
    return x.narrow(p.axis, lo, hi - lo).contiguous()


def place(tree, placements, n: int):
    """This rank's part of a global ``tree`` of ``n`` agents: the rows of
    each row-sharded leaf, the whole of each replicated one, on the
    mesh's device."""
    return coll.map_tree(lambda x, p: _local(x, p, n), tree, placements)


def shard_problem(state: sim.SimState, formation: Formation,
                  mesh: AgentMesh):
    """Place a global state and formation on the mesh with the standard
    layout: ``(local state, local formation, state placements, formation
    placements)``. A batch of trials (leaves (B, ...)) takes the batched
    layout, the trial axis replicated."""
    st_sh = state_sharding_of(state, mesh)
    f_sh = formation_sharding(mesh)
    if formation.points.ndim > 2:
        f_sh = batch_axis(f_sh)
    n = formation.points.shape[-2]
    return (place(state, st_sh, n), place(formation, f_sh, n), st_sh,
            f_sh)


def _global(x: torch.Tensor, p: Placement) -> torch.Tensor:
    if p.axis is None or p.mesh.index is None:
        return x
    return coll.gather(x, p.mesh, axis=p.axis)


def gather_state(tree, placements):
    """The global tree from every rank's part (`place`'s inverse): each
    row-sharded leaf gathered over the mesh, on every rank of the world
    (the ranks outside the mesh receive it from the first)."""
    meshes = []
    map_placements(meshes.append, placements)
    out = coll.map_tree(_global, tree, placements)
    return coll.spill(out, meshes[0].mesh)


def map_placements(fn, placements):
    """``fn`` over every `Placement` of a placement tree."""
    if isinstance(placements, Placement):
        return fn(placements)
    if dataclasses.is_dataclass(placements):
        return type(placements)(**{
            f.name: map_placements(fn, getattr(placements, f.name))
            for f in dataclasses.fields(placements)})
    if isinstance(placements, tuple) and hasattr(placements, "_fields"):
        return type(placements)(*(map_placements(fn, x)
                                  for x in placements))
    return placements
