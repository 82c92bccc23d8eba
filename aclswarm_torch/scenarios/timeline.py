"""Scenario timelines as data (port of `aclswarm_tpu/scenarios/timeline.py`):
the `FaultSchedule` pattern, generalized.

A `Scenario` is tensors, never control flow: every axis is a mask or a
`where` of the per-trial tick against the baseline value, so every trial
of a batch may fly a different scenario (stack them: a leading (B,) axis
on every tensor, the trials' ticks a (B,) tensor). The five axes:

- (a) pop-up / moving cylinder obstacles, tracks ``center + vel * t``,
  cast avoidance sectors with their own keep-out radii
  (`control.collision_avoidance`);
- (b) steady wind plus per-vehicle gusts displace the integrated positions
  (before the fault freeze); sensor noise perturbs the flooded estimates
  as consumed (`localization.noised_view`), never the carried table;
- (c) tick-scheduled formation stages replace the formation points and
  their desired distances;
- (d) byzantine agents report seeded lies to every assignment solver;
- (e) goal drift translates the formation, and ``rematch_every``
  throttles which scheduled auctions are accepted.

Per-tick draws are JAX's threefry stream (`core.prng`): ``fold_in(key,
tick)`` then ``fold_in(., salt)``, one salt per axis. Uniform bits equal
the reference's; normals differ in a few ulp (`core.prng`).

`no_scenario` (every axis inert) is bit-identical to ``scenario=None``.
Where the reference draws a tensor and discards it with ``where(on, ...)``
the engine skips the draw when the axis is off for every trial of the
batch. It decides from a host copy of the scenario's onset ticks
(`host_view`), as it decides the auction cadence from the host tick, so
the result is the reference's by construction.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from aclswarm_torch.core import prng
from aclswarm_torch.core.types import resolve_device
from aclswarm_torch.faults.schedule import tick_tensor

NEVER = np.int32(2**31 - 1)

# the static axis capacities every Scenario of a given n shares, so any two
# scenarios (or a scenario and `no_scenario`) stack into one batch
DEFAULT_MAX_OBSTACLES = 4
DEFAULT_MAX_STAGES = 2

# per-tick key salts: each axis draws from its own fold of the key
_SALT_BYZ = 1
_SALT_GUST = 2
_SALT_NOISE = 3

_INT_FIELDS = ("obs_appear", "obs_vanish", "wind_tick", "noise_tick",
               "seq_tick", "byz_tick", "drift_tick", "rematch_every")


@dataclass
class Scenario:
    """One trial's scenario script ([B,] leading axis for a batch). Inert
    encodings: tick fields `NEVER`, masks all False, magnitudes zero."""

    # (a) obstacles: cylinder tracks pos(t) = center + vel * (t * dt)
    obs_center: torch.Tensor   # (K, 3) track origin at tick 0
    obs_vel: torch.Tensor      # (K, 3) track velocity (m/s)
    obs_radius: torch.Tensor   # (K,) keep-out radius (m)
    obs_appear: torch.Tensor   # (K,) int32 pop-up tick; NEVER = inert
    obs_vanish: torch.Tensor   # (K,) int32 disappear tick; NEVER = stays
    # (b) disturbances
    wind_vel: torch.Tensor     # (3,) steady wind (m/s)
    gust_std: torch.Tensor     # () per-tick per-vehicle gust std (m/s)
    wind_tick: torch.Tensor    # () int32 wind onset; NEVER = off
    noise_std: torch.Tensor    # () flood-estimate noise std (m)
    noise_tick: torch.Tensor   # () int32 noise onset; NEVER = off
    # (c) formation sequence: stage s becomes active at seq_tick[s]
    seq_points: torch.Tensor   # (S, n, 3) stage formation point tables
    seq_tick: torch.Tensor     # (S,) int32 ascending; NEVER = unused
    # (d) byzantine bidders
    byz_mask: torch.Tensor     # (n,) bool dishonest agents
    byz_std: torch.Tensor      # () reported-position corruption std (m)
    byz_tick: torch.Tensor     # () int32 corruption onset; NEVER = off
    # (e) goal drift + re-matching cadence
    drift_vel: torch.Tensor    # (3,) formation drift velocity (m/s)
    drift_tick: torch.Tensor   # () int32 drift onset; NEVER = off
    rematch_every: torch.Tensor  # () int32 accepted-auction cadence (0 =
    #                              every scheduled auction)
    key: torch.Tensor          # (2,) int64 threefry key words

    @property
    def n(self) -> int:
        return self.byz_mask.shape[-1]

    @property
    def max_obstacles(self) -> int:
        return self.obs_radius.shape[-1]

    @property
    def max_stages(self) -> int:
        return self.seq_tick.shape[-1]


def no_scenario_numpy(n: int, max_obstacles: int = DEFAULT_MAX_OBSTACLES,
                      max_stages: int = DEFAULT_MAX_STAGES,
                      dtype=np.float32) -> dict:
    """The identity scenario's leaves as host arrays, the reference's
    field names and dtypes (uint32 key words)."""
    K, S = int(max_obstacles), int(max_stages)
    return dict(
        obs_center=np.zeros((K, 3), dtype), obs_vel=np.zeros((K, 3), dtype),
        obs_radius=np.zeros((K,), dtype),
        obs_appear=np.full((K,), NEVER, np.int32),
        obs_vanish=np.full((K,), NEVER, np.int32),
        wind_vel=np.zeros((3,), dtype), gust_std=np.zeros((), dtype),
        wind_tick=np.asarray(NEVER, np.int32),
        noise_std=np.zeros((), dtype), noise_tick=np.asarray(NEVER, np.int32),
        seq_points=np.zeros((S, n, 3), dtype),
        seq_tick=np.full((S,), NEVER, np.int32),
        byz_mask=np.zeros((n,), bool), byz_std=np.zeros((), dtype),
        byz_tick=np.asarray(NEVER, np.int32),
        drift_vel=np.zeros((3,), dtype),
        drift_tick=np.asarray(NEVER, np.int32),
        rematch_every=np.zeros((), np.int32),
        key=np.zeros((2,), np.uint32))


def from_numpy(leaves, device=None, dtype=torch.float32) -> Scenario:
    """A `Scenario` from host leaves (a mapping or an object with the
    reference's field names; a batch with a leading axis) on ``device``
    (None = the card): floats in ``dtype``, ticks int32, the mask bool,
    the key words int64. Keeps the host copy of the onsets (`host_view`)."""
    dev = resolve_device(device)

    def get(name):
        v = leaves[name] if isinstance(leaves, dict) else getattr(leaves,
                                                                  name)
        return np.asarray(v)

    out = {}
    for f in fields(Scenario):
        v = get(f.name)
        if f.name == "byz_mask":
            t = torch.as_tensor(v.astype(bool))
        elif f.name == "key":
            t = torch.as_tensor(v.astype(np.int64))
        elif f.name in _INT_FIELDS:
            t = torch.as_tensor(v.astype(np.int32))
        else:
            t = torch.as_tensor(np.array(v)).to(dtype)
        out[f.name] = t.to(dev)
    scen = Scenario(**out)
    scen._host = _host_leaves(get)
    return scen


def no_scenario(n: int, max_obstacles: int = DEFAULT_MAX_OBSTACLES,
                max_stages: int = DEFAULT_MAX_STAGES, device=None,
                dtype=torch.float32) -> Scenario:
    """The identity scenario: every axis inert. Bit-identical to
    ``scenario=None`` through the whole engine (the parity contract)."""
    return from_numpy(no_scenario_numpy(n, max_obstacles, max_stages),
                      device=device, dtype=dtype)


def key_leaves(seed: int) -> np.ndarray:
    """Raw threefry key words for ``seed`` (uint32, the reference's)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


# ---------------------------------------------------------------------------
# the host copy of the onsets: which axes are on is host data

def _host_leaves(get) -> dict:
    return dict(obs_appear=get("obs_appear").astype(np.int64),
                obs_vanish=get("obs_vanish").astype(np.int64),
                byz_tick=get("byz_tick").astype(np.int64),
                byz_any=get("byz_mask").astype(bool).any(axis=-1),
                wind_tick=get("wind_tick").astype(np.int64),
                noise_tick=get("noise_tick").astype(np.int64),
                noise_on=np.asarray(get("noise_std")) > 0,
                seq_tick=get("seq_tick").astype(np.int64),
                drift_tick=get("drift_tick").astype(np.int64))


def host_view(scen: Scenario) -> dict:
    """Host arrays of the onset ticks and on-flags, read once per
    `Scenario` object (one device-to-host read per field if the object was
    not built from host data) and kept on it."""
    host = getattr(scen, "_host", None)
    if host is None:
        host = _host_leaves(lambda k: getattr(scen, k).cpu().numpy())
        scen._host = host
    return host


def attach_host(scen: Scenario, leaves: dict) -> Scenario:
    """Give ``scen`` the host copy of its onsets from ``leaves`` (host
    arrays of its own fields, by name), with no device read."""
    scen._host = _host_leaves(lambda k: np.asarray(leaves[k]))
    return scen


def stack_host(scens: list, out: Scenario) -> Scenario:
    """Give the stacked ``out`` the stacked host copies of ``scens``."""
    views = [host_view(s) for s in scens]
    out._host = {k: np.stack([v[k] for v in views]) for k in views[0]}
    return out


def take_host(scen: Scenario, idx, out: Scenario) -> Scenario:
    """Give ``out`` (rows ``idx`` of the batched ``scen``) their host
    copies; ``idx`` an int (one trial) or a host sequence of ints."""
    out._host = {k: v[idx] for k, v in host_view(scen).items()}
    return out


def axes_on(scen: Scenario, tick) -> dict:
    """Host bools per axis the engine may skip: on for any trial at
    ``tick`` (a host int, or the batch's (B,) host array of ticks)."""
    h, t = host_view(scen), np.asarray(tick, np.int64)
    stage = (h["seq_tick"] <= t[..., None]).sum(axis=-1) - 1
    return dict(
        obstacles=bool(np.any((t[..., None] >= h["obs_appear"])
                              & (t[..., None] < h["obs_vanish"]))),
        byz=bool(np.any((t >= h["byz_tick"]) & h["byz_any"])),
        wind=bool(np.any(t >= h["wind_tick"])),
        noise=bool(np.any((t >= h["noise_tick"]) & h["noise_on"])),
        formation=bool(np.any((stage >= 0) | (t >= h["drift_tick"]))))


# ---------------------------------------------------------------------------
# per-tick evaluators: ``tick`` is a host int or a ([B,]) int32 tensor of
# the trials' ticks; a batched scenario's leaves carry the trial axis

def _folded(scen: Scenario, tick, salt: int) -> torch.Tensor:
    k = prng.fold_in(scen.key, tick_tensor(tick, scen.key))
    return prng.fold_in(k, salt)


def _seconds(t: torch.Tensor, dt: float, dtype) -> torch.Tensor:
    """``t * dt`` in ``dtype``, both factors rounded to it first."""
    return t.to(dtype) * prng.rounded(dt, dtype)


def obstacles_at(scen: Scenario, tick, dt: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(([B,] K, 3) obstacle positions, ([B,] K) active mask) at ``tick``.
    Tracks advance regardless of activity; inert slots are masked out."""
    t = tick_tensor(tick, scen.obs_appear)[..., None]
    active = (t >= scen.obs_appear) & (t < scen.obs_vanish)
    tf = _seconds(t, dt, scen.obs_center.dtype)
    return scen.obs_center + scen.obs_vel * tf[..., None], active


def stage_at(scen: Scenario, tick) -> torch.Tensor:
    """([B,]) int32 active formation stage at ``tick`` (-1 = the dispatched
    base formation)."""
    t = tick_tensor(tick, scen.seq_tick)[..., None]
    return torch.sum((scen.seq_tick <= t).to(torch.int32), dim=-1,
                     dtype=torch.int32) - 1


def formation_points_at(scen: Scenario, base_points: torch.Tensor, tick,
                        dt: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(([B,] n, 3) effective formation points, ([B,]) bool changed) at
    ``tick``: the active stage's table (else the base points) translated
    by the goal drift; unchanged rows pass ``base_points`` through."""
    t = tick_tensor(tick, scen.seq_tick)
    dtc = base_points.dtype
    stage = stage_at(scen, t)
    idx = torch.clamp(stage, 0, scen.max_stages - 1).long()
    staged = torch.gather(
        scen.seq_points, -3,
        idx[..., None, None, None].expand(*idx.shape, 1,
                                          *scen.seq_points.shape[-2:]))
    staged = staged[..., 0, :, :].to(dtc)
    pts = torch.where((stage >= 0)[..., None, None], staged, base_points)
    drift_on = t >= scen.drift_tick
    tf = _seconds(torch.clamp(t - scen.drift_tick, min=0), dt, dtc)
    pts = torch.where(drift_on[..., None, None],
                      pts + scen.drift_vel.to(dtc)[..., None, :]
                      * tf[..., None, None], pts)
    return pts, (stage >= 0) | drift_on


def reported_positions(scen: Scenario, q: torch.Tensor, tick
                       ) -> torch.Tensor:
    """([B,] n, 3) positions as reported to the assignment layer:
    byzantine agents add a per-tick seeded lie of scale ``byz_std``,
    honest rows pass through bitwise."""
    t = tick_tensor(tick, scen.byz_tick)
    on = t >= scen.byz_tick
    lie = scen.byz_std.to(q.dtype)[..., None, None] * prng.normal(
        _folded(scen, t, _SALT_BYZ), q.shape[-2:], q.dtype)
    return torch.where((on[..., None] & scen.byz_mask)[..., None], q + lie,
                       q)


def wind_at(scen: Scenario, tick, dt: float, n: int, dtype
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(([B,] n, 3) per-tick position displacement, ([B,]) bool active):
    steady wind plus per-vehicle gusts over one control tick."""
    t = tick_tensor(tick, scen.wind_tick)
    on = t >= scen.wind_tick
    gust = scen.gust_std.to(dtype)[..., None, None] * prng.normal(
        _folded(scen, t, _SALT_GUST), (n, 3), dtype)
    dq = (scen.wind_vel.to(dtype)[..., None, :] + gust) \
        * prng.rounded(dt, dtype)
    return dq, on


def est_noise_at(scen: Scenario, tick, n: int, dtype
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(([B,] n, n, 3) additive estimate noise, ([B,]) bool active) at
    ``tick``, for `localization.noised_view`."""
    t = tick_tensor(tick, scen.noise_tick)
    on = (t >= scen.noise_tick) & (scen.noise_std > 0)
    draw = scen.noise_std.to(dtype)[..., None, None, None] * prng.normal(
        _folded(scen, t, _SALT_NOISE), (n, n, 3), dtype)
    return draw, on


def rematch_ok_at(scen: Scenario, tick) -> torch.Tensor:
    """([B,]) bool: may a scheduled auction's result be accepted at
    ``tick``? ``rematch_every <= 0`` keeps the engine's cadence."""
    t = tick_tensor(tick, scen.rematch_every)
    every = scen.rematch_every
    return (every <= 0) | (torch.remainder(t, torch.clamp(every, min=1))
                           == 0)


def scenario_event_at(scen: Scenario, tick) -> torch.Tensor:
    """([B,]) bool: any axis flips state at ``tick`` (an obstacle appears
    or vanishes, a stage lands, a wind / noise / byzantine / drift onset
    fires), which (re)starts the recovery clock (`sim.summary`)."""
    t = tick_tensor(tick, scen.obs_appear)

    def obs_active(tt):
        tt = tt[..., None]
        return (tt >= scen.obs_appear) & (tt < scen.obs_vanish)

    ev = torch.any(obs_active(t) != obs_active(t - 1), dim=-1)
    ev = ev | (stage_at(scen, t) != stage_at(scen, t - 1))
    for onset in (scen.wind_tick, scen.noise_tick, scen.byz_tick,
                  scen.drift_tick):
        ev = ev | (t == onset)
    return ev
