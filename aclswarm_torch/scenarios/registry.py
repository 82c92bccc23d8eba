"""Named scenario families (port of `aclswarm_tpu/scenarios/registry.py`):
declarative parameter spaces and their seeded generators.

Host numpy, copied from the reference so that the same ``(family, seed,
n)`` draws the same leaves; only `compose` differs, building the port's
`Scenario` (`timeline.from_numpy`) on ``device`` in ``dtype``. A family's
ranges stay inside the engine's safety envelope (wind under the 0.5 m/s
velocity authority, events inside the horizon), and `validate` refuses an
override outside them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

import torch

from aclswarm_torch.scenarios import timeline
from aclswarm_torch.scenarios.timeline import (DEFAULT_MAX_OBSTACLES,
                                               DEFAULT_MAX_STAGES, NEVER,
                                               Scenario)

# default scripting horizon in control ticks: family event fractions
# scale to this (override per call for longer suites)
DEFAULT_HORIZON = 1200

# wind magnitudes cap well under the reference 0.5 m/s velocity
# saturation (`SafetyParams.max_vel_xy`): the controller must keep
# positive authority against the worst in-space wind + gusts
_WIND_MAX = 0.25
_GUST_MAX = 0.05


def _ring_points(n: int, radius: float, z: float = 2.0,
                 phase: float = 0.0) -> np.ndarray:
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False) + phase
    return np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     np.full(n, z)], 1)


def _split_points(n: int, radius: float, gap: float,
                  z: float = 2.0) -> np.ndarray:
    """Two half-fleet clusters ``gap`` apart — the split/merge stage."""
    h = n // 2
    a = _ring_points(h, radius, z)
    b = _ring_points(n - h, radius, z)
    a[:, 0] -= gap / 2.0
    b[:, 0] += gap / 2.0
    return np.concatenate([a, b], axis=0)


def formation_scale(n: int) -> float:
    """Ring radius keeping neighbor spacing ~2x the 1.2 m keep-out."""
    return max(3.0, 0.4 * n)


# ---------------------------------------------------------------------------
# axis samplers: each returns a field dict to `Scenario.replace` onto
# `no_scenario` — the composition algebra the fuzzer sweeps

def sample_obstacles(rng: np.random.Generator, n: int, horizon: int,
                     caps: tuple, dtype, *, count: int = 2,
                     radius: float = 1.0, speed: float = 0.0,
                     appear_frac: float = 0.25,
                     vanish_frac: float = 0.75) -> dict:
    K = caps[0]
    count = min(int(count), K)
    span = formation_scale(n)
    center = np.zeros((K, 3))
    vel = np.zeros((K, 3))
    rad = np.zeros((K,))
    appear = np.full((K,), NEVER, np.int32)
    vanish = np.full((K,), NEVER, np.int32)
    for k in range(count):
        ang = rng.uniform(0, 2 * np.pi)
        if speed > 0:
            # crossing track: start outside the cloud, transit through
            center[k] = [-1.5 * span * np.cos(ang),
                         -1.5 * span * np.sin(ang), 2.0]
            vel[k] = [speed * np.cos(ang), speed * np.sin(ang), 0.0]
        else:
            r = rng.uniform(0.3 * span, 0.9 * span)
            center[k] = [r * np.cos(ang), r * np.sin(ang), 2.0]
        rad[k] = radius * rng.uniform(0.7, 1.3)
        appear[k] = np.int32(int(appear_frac * horizon))
        vanish[k] = (np.int32(int(vanish_frac * horizon))
                     if vanish_frac < 1.0 else NEVER)
    return dict(obs_center=np.asarray(center, dtype),
                obs_vel=np.asarray(vel, dtype),
                obs_radius=np.asarray(rad, dtype),
                obs_appear=appear, obs_vanish=vanish)


def sample_wind(rng: np.random.Generator, n: int, horizon: int,
                caps: tuple, dtype, *, wind: float = 0.15,
                gust: float = 0.02, onset_frac: float = 0.3) -> dict:
    wind = min(float(wind), _WIND_MAX)
    ang = rng.uniform(0, 2 * np.pi)
    return dict(
        wind_vel=np.asarray([wind * np.cos(ang), wind * np.sin(ang),
                             0.0], dtype),
        gust_std=np.asarray(min(float(gust), _GUST_MAX), dtype),
        wind_tick=np.int32(int(onset_frac * horizon)))


def sample_noise(rng: np.random.Generator, n: int, horizon: int,
                 caps: tuple, dtype, *, sigma: float = 0.15,
                 onset_frac: float = 0.25) -> dict:
    return dict(noise_std=np.asarray(float(sigma), dtype),
                noise_tick=np.int32(int(onset_frac * horizon)))


def sample_sequence(rng: np.random.Generator, n: int, horizon: int,
                    caps: tuple, dtype, *, stages: int = 2,
                    split: bool = False) -> dict:
    S = caps[1]
    stages = min(int(stages), S)
    base_r = formation_scale(n)
    pts = np.zeros((S, n, 3))
    ticks = np.full((S,), NEVER, np.int32)
    fr = np.linspace(0.35, 0.7, max(stages, 1))
    for s in range(stages):
        if split and s == stages - 1:
            pts[s] = _split_points(n, 0.7 * base_r, 2.5 * base_r)
        else:
            scale = rng.uniform(0.6, 1.4)
            pts[s] = _ring_points(n, scale * base_r,
                                  phase=rng.uniform(0, 2 * np.pi))
        ticks[s] = np.int32(int(fr[s] * horizon))
    return dict(seq_points=np.asarray(pts, dtype), seq_tick=ticks)


def sample_byzantine(rng: np.random.Generator, n: int, horizon: int,
                     caps: tuple, dtype, *, frac: float = 0.2,
                     sigma: float = 1.5, onset_frac: float = 0.3) -> dict:
    k = max(1, int(round(float(frac) * n)))
    mask = np.zeros((n,), bool)
    mask[rng.choice(n, size=min(k, n), replace=False)] = True
    return dict(byz_mask=mask, byz_std=np.asarray(float(sigma), dtype),
                byz_tick=np.int32(int(onset_frac * horizon)))


def sample_drift(rng: np.random.Generator, n: int, horizon: int,
                 caps: tuple, dtype, *, speed: float = 0.05,
                 onset_frac: float = 0.25,
                 rematch_every: int = 0) -> dict:
    speed = min(float(speed), _WIND_MAX)  # same authority argument
    ang = rng.uniform(0, 2 * np.pi)
    return dict(
        drift_vel=np.asarray([speed * np.cos(ang), speed * np.sin(ang),
                              0.0], dtype),
        drift_tick=np.int32(int(onset_frac * horizon)),
        rematch_every=np.int32(int(rematch_every)))


AXES: dict[str, Callable] = {
    "obstacles": sample_obstacles,
    "wind": sample_wind,
    "noise": sample_noise,
    "sequence": sample_sequence,
    "byzantine": sample_byzantine,
    "drift": sample_drift,
}


def compose(n: int, seed: int, parts: dict, *, dtype=torch.float32,
            device=None, max_obstacles: int = DEFAULT_MAX_OBSTACLES,
            max_stages: int = DEFAULT_MAX_STAGES,
            horizon: int = DEFAULT_HORIZON) -> Scenario:
    """Build a Scenario by composing axis samplers: ``parts`` maps axis
    name (`AXES`) -> kwargs dict for its sampler. Axes are independent
    field groups, so composition is a plain merge onto `no_scenario`. The
    samplers round to ``dtype`` on the host, as the reference's do."""
    npdtype = np.dtype(str(dtype).split(".")[-1])
    rng = np.random.default_rng(seed)
    caps = (int(max_obstacles), int(max_stages))
    fields: dict = {}
    for axis in sorted(parts):       # order-stable rng consumption
        if axis not in AXES:
            raise ValueError(f"unknown scenario axis {axis!r} "
                             f"(registered: {sorted(AXES)})")
        fields.update(AXES[axis](rng, n, int(horizon), caps, npdtype,
                                 **parts[axis]))
    leaves = timeline.no_scenario_numpy(n, caps[0], caps[1], npdtype)
    leaves.update({k: np.asarray(v, leaves[k].dtype)
                   for k, v in fields.items()},
                  key=timeline.key_leaves(seed))
    return timeline.from_numpy(leaves, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# named families: the committed scenario vocabulary

@dataclasses.dataclass(frozen=True)
class ScenarioFamily:
    """One named region of scenario space. ``space`` documents every
    overridable parameter as axis.param -> (lo, hi) range or choice
    tuple; ``localization`` names the information model the family's
    axes bite in (the suite runs it accordingly)."""

    name: str
    summary: str
    parts: dict                  # axis -> default sampler kwargs
    space: dict                  # "axis.param" -> (lo, hi) | choices
    localization: str = "truth"


FAMILIES: dict[str, ScenarioFamily] = {f.name: f for f in (
    ScenarioFamily(
        "popup_obstacles",
        "static cylinder obstacles pop up mid-trial and vanish",
        parts={"obstacles": dict(count=2, radius=1.0, speed=0.0)},
        space={"obstacles.count": (1, DEFAULT_MAX_OBSTACLES),
               "obstacles.radius": (0.5, 1.5)}),
    ScenarioFamily(
        "crossing_obstacle",
        "a moving obstacle transits straight through the formation",
        parts={"obstacles": dict(count=1, radius=1.2, speed=0.4,
                                 appear_frac=0.2, vanish_frac=1.0)},
        space={"obstacles.radius": (0.8, 1.5),
               "obstacles.speed": (0.2, 0.6)}),
    ScenarioFamily(
        "wind_gust",
        "steady wind + per-vehicle gusts switch on mid-trial",
        parts={"wind": dict(wind=0.15, gust=0.02)},
        space={"wind.wind": (0.05, _WIND_MAX),
               "wind.gust": (0.0, _GUST_MAX)}),
    ScenarioFamily(
        "sensor_noise",
        "flooded-localization estimate noise switches on mid-trial",
        parts={"noise": dict(sigma=0.15)},
        space={"noise.sigma": (0.05, 0.3)},
        localization="flooded"),
    ScenarioFamily(
        "formation_morph",
        "tick-scheduled formation sequence (morph, then split/merge)",
        parts={"sequence": dict(stages=2, split=True)},
        space={"sequence.stages": (1, DEFAULT_MAX_STAGES)}),
    ScenarioFamily(
        "byzantine_bidders",
        "a masked fraction of the fleet bids on corrupted positions",
        parts={"byzantine": dict(frac=0.2, sigma=1.5)},
        space={"byzantine.frac": (0.1, 0.3),
               "byzantine.sigma": (0.5, 3.0)}),
    ScenarioFamily(
        "goal_drift",
        "the formation drifts; re-matching is throttled to a cadence",
        parts={"drift": dict(speed=0.05, rematch_every=240)},
        space={"drift.speed": (0.02, 0.1),
               "drift.rematch_every": (0, 480)}),
    ScenarioFamily(
        "kitchen_sink",
        "obstacles + wind + morph + byzantine + drift composed",
        parts={"obstacles": dict(count=1, radius=0.8),
               "wind": dict(wind=0.08, gust=0.01),
               "sequence": dict(stages=1, split=False),
               "byzantine": dict(frac=0.15, sigma=1.0),
               "drift": dict(speed=0.03, rematch_every=240)},
        space={}),
)}


def validate(family: str, params: dict | None = None) -> ScenarioFamily:
    """Admission-time check (serve; ValueError = refuse at the door):
    the family exists and every override names a parameter in its
    space as ``"axis.param"`` AND holds a value inside the documented
    range — the safety-envelope claim above is only true for in-space
    scenarios, so an out-of-range override (a 1e6 m noise sigma, an
    arena-spanning obstacle) is a refused request, not a served one."""
    fam = FAMILIES.get(family)
    if fam is None:
        raise ValueError(f"unknown scenario family {family!r} "
                         f"(registered: {sorted(FAMILIES)})")
    for key, val in (params or {}).items():
        if key not in fam.space:
            raise ValueError(
                f"scenario family {family!r} has no parameter {key!r} "
                f"(space: {sorted(fam.space)})")
        lo, hi = fam.space[key]
        if isinstance(val, bool) or not isinstance(val, (int, float)) \
                or not lo <= val <= hi:
            raise ValueError(
                f"scenario override {key}={val!r} outside the "
                f"{family!r} space [{lo}, {hi}]")
    return fam


def sample(family: str, seed: int, n: int, *, dtype=torch.float32,
           device=None, max_obstacles: int = DEFAULT_MAX_OBSTACLES,
           max_stages: int = DEFAULT_MAX_STAGES,
           horizon: int = DEFAULT_HORIZON,
           params: dict | None = None) -> Scenario:
    """One seeded draw from a family: defaults from the family's
    ``parts``, overridden by ``params`` ("axis.param" keys, validated
    against the space). Deterministic from (family, seed, n, caps). The
    scenario lives on ``device`` (None = the card) in ``dtype``."""
    fam = validate(family, params)
    parts = {axis: dict(kw) for axis, kw in fam.parts.items()}
    for key, val in (params or {}).items():
        axis, pname = key.split(".", 1)
        parts.setdefault(axis, {})[pname] = val
    return compose(n, seed, parts, dtype=dtype, device=device,
                   max_obstacles=max_obstacles, max_stages=max_stages,
                   horizon=horizon)
