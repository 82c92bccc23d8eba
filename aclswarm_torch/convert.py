"""Carry formations, parameters and simulation state between the reference
package and the port, through numpy.

The ``*_from_numpy`` functions take the reference's objects with numpy
leaves (e.g. ``jax.tree.map(np.asarray, formation)``; any object with the
same attribute names, or a mapping, will do) and build the port's objects
on ``device`` in ``dtype``. `sim_state_to_numpy` goes the other way, to a
nested dict of numpy arrays with the reference's field names. This module
imports neither JAX nor the reference package.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import fields

import numpy as np
import torch

from aclswarm_torch.assignment.cbaa import CbaaTables
from aclswarm_torch.control.safety import TrajGoal
from aclswarm_torch.core.types import (ControlGains, Formation, SafetyParams,
                                       SwarmState, as_float, resolve_device)
from aclswarm_torch.gains.admm import AdmmCarry
from aclswarm_torch.gains.params import AdmmParams
from aclswarm_torch.sim.engine import SimState
from aclswarm_torch.sim.localization import EstimateTable
from aclswarm_torch.sim.vehicle import FlightState


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _floats(obj, names, device, dtype) -> dict:
    return {k: as_float(np.array(_get(obj, k)), device, dtype)
            for k in names}


def _ints(obj, names, device) -> dict:
    return {k: torch.as_tensor(np.array(_get(obj, k)), dtype=torch.int32,
                               device=device) for k in names}


def formation_from_numpy(f, device=None, dtype=torch.float32) -> Formation:
    """points, adjmat, gains (n, n, 3, 3), dstar_xy, dstar_z — carried as
    they are (the desired distances are not recomputed)."""
    return Formation(**_floats(f, ("points", "adjmat", "gains", "dstar_xy",
                                   "dstar_z"), resolve_device(device), dtype))


def control_gains_from_numpy(g) -> ControlGains:
    return ControlGains(**{k.name: float(np.asarray(_get(g, k.name)))
                           for k in fields(ControlGains)})


def safety_params_from_numpy(sp) -> SafetyParams:
    kw = {}
    for k in fields(SafetyParams):
        v = np.asarray(_get(sp, k.name))
        if k.name in ("bounds_min", "bounds_max"):
            kw[k.name] = tuple(float(x) for x in v)
        elif k.name == "takeoff_rel":
            kw[k.name] = bool(v)
        else:
            kw[k.name] = float(v)
    return SafetyParams(**kw)


def cbaa_tables_from_numpy(t, device=None, dtype=torch.float32
                           ) -> CbaaTables:
    """price (n, n) float, who (n, n) int32."""
    dev = resolve_device(device)
    return CbaaTables(price=_floats(t, ("price",), dev, dtype)["price"],
                      who=_ints(t, ("who",), dev)["who"])


def admm_params_from_numpy(p) -> AdmmParams:
    """The reference's `AdmmParams`, field by field."""
    return AdmmParams(**{k.name: _get(p, k.name) for k in fields(AdmmParams)})


def admm_carry_from_numpy(c, device=None, dtype=torch.float32) -> AdmmCarry:
    """x2, s2, x1, s1 float, iters () int32."""
    dev = resolve_device(device)
    return AdmmCarry(**_floats(c, ("x2", "s2", "x1", "s1"), dev, dtype),
                     iters=_ints(c, ("iters",), dev)["iters"])


def admm_carry_to_numpy(carry: AdmmCarry) -> dict:
    """The port's carry as a dict of numpy arrays, the reference's field
    names."""
    return {k: v.cpu().numpy() for k, v in carry._asdict().items()}


def _optional(obj, name):
    if isinstance(obj, Mapping):
        return obj.get(name)
    return getattr(obj, name, None)


def sim_state_from_numpy(s, device=None, dtype=torch.float32) -> SimState:
    """swarm, goal, v2f, tick, flight, loc, first_auction, assign_enabled,
    cbaa_warm. The reference's other optional carries (faults, scenario,
    inv, tel) are not ported yet and must be absent."""
    for extra in ("faults", "scenario", "inv", "tel"):
        if _optional(s, extra) is not None:
            raise NotImplementedError(
                f"SimState.{extra} is not ported yet")
    dev = resolve_device(device)
    swarm, goal, flight = _get(s, "swarm"), _get(s, "goal"), _get(s, "flight")
    loc, warm = _get(s, "loc"), _optional(s, "cbaa_warm")
    return SimState(
        swarm=SwarmState(**_floats(swarm, ("q", "vel"), dev, dtype)),
        goal=TrajGoal(**_floats(goal, ("pos", "vel", "yaw", "dyaw"), dev,
                                dtype)),
        v2f=_ints(s, ("v2f",), dev)["v2f"],
        tick=int(np.asarray(_get(s, "tick"))),
        flight=FlightState(
            **_ints(flight, ("mode", "ticks_in_mode"), dev),
            **_floats(flight, ("initial_alt", "takeoff_alt"), dev, dtype)),
        loc=None if loc is None else EstimateTable(
            est=_floats(loc, ("est",), dev, dtype)["est"],
            age=_ints(loc, ("age",), dev)["age"]),
        first_auction=torch.as_tensor(
            bool(np.asarray(_get(s, "first_auction"))), device=dev),
        assign_enabled=torch.as_tensor(
            bool(np.asarray(_get(s, "assign_enabled"))), device=dev),
        cbaa_warm=None if warm is None else cbaa_tables_from_numpy(
            warm, dev, dtype))


def _np(obj) -> dict:
    return {f.name: getattr(obj, f.name).cpu().numpy() for f in fields(obj)}


def sim_state_to_numpy(state: SimState) -> dict:
    """The port's state as a nested dict of numpy arrays, keyed by the
    reference's field names."""
    return {
        "swarm": _np(state.swarm), "goal": _np(state.goal),
        "v2f": state.v2f.cpu().numpy(), "tick": np.int32(state.tick),
        "flight": _np(state.flight),
        "loc": None if state.loc is None else _np(state.loc),
        "first_auction": state.first_auction.cpu().numpy(),
        "assign_enabled": state.assign_enabled.cpu().numpy(),
        "cbaa_warm": None if state.cbaa_warm is None
        else {k: v.cpu().numpy()
              for k, v in state.cbaa_warm._asdict().items()},
    }
