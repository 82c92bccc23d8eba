"""Carry formations, parameters and simulation state between the reference
package and the port, through numpy.

The ``*_from_numpy`` functions take the reference's objects with numpy
leaves (e.g. ``jax.tree.map(np.asarray, formation)``; any object with the
same attribute names, or a mapping, will do) and build the port's objects
on ``device`` in ``dtype``. `sim_state_to_numpy` goes the other way, to a
nested dict of numpy arrays with the reference's field names. A batch of
trials crosses the same way, every leaf with a leading (B,) axis (the
reference's batched `SimState`, `Formation` and `SummaryCarry`); a
batched state's tick is then a (B,) array. Fault schedules and scenarios
cross with their leaves (the reference's uint32 key words become int64).
This module imports neither JAX nor the reference package.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import fields

import numpy as np
import torch

from aclswarm_torch.analysis.invariants import InvariantState
from aclswarm_torch.assignment.cbaa import CbaaTables
from aclswarm_torch.control.safety import TrajGoal
from aclswarm_torch.core.types import (ControlGains, Formation, SafetyParams,
                                       SwarmState, as_float, resolve_device)
from aclswarm_torch.faults import schedule as faultlib
from aclswarm_torch.faults.schedule import FaultSchedule
from aclswarm_torch.scenarios import timeline as scenlib
from aclswarm_torch.scenarios.timeline import Scenario
from aclswarm_torch.gains.admm import AdmmCarry
from aclswarm_torch.gains.params import AdmmParams
from aclswarm_torch.sim.engine import SimState
from aclswarm_torch.sim.localization import EstimateTable
from aclswarm_torch.sim.summary import SummaryCarry
from aclswarm_torch.sim.vehicle import FlightState
from aclswarm_torch.telemetry import device as devtel
from aclswarm_torch.telemetry.device import ChunkTelemetry


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


def fault_schedule_from_numpy(f, device=None, dtype=torch.float32
                              ) -> FaultSchedule:
    """The reference's `FaultSchedule` (one trial or a batch): drop_tick,
    rejoin_tick, link_loss in ``dtype``, the key words."""
    return faultlib.from_numpy(*(np.asarray(_get(f, k)) for k in (
        "drop_tick", "rejoin_tick", "link_loss", "key")), device=device,
        dtype=dtype)


def scenario_from_numpy(sc, device=None, dtype=torch.float32) -> Scenario:
    """The reference's `Scenario` (one trial or a batch), every leaf."""
    return scenlib.from_numpy(
        {f.name: np.asarray(_get(sc, f.name)) for f in fields(Scenario)},
        device=device, dtype=dtype)


def invariant_state_from_numpy(inv, device=None) -> InvariantState:
    """The reference's `InvariantState` (one trial or a batch): code and
    tick, int32."""
    return InvariantState(**_ints(inv, ("code", "tick"),
                                  resolve_device(device)))


def telemetry_from_numpy(tel, device=None, dtype=torch.float32
                         ) -> ChunkTelemetry:
    """The reference's `ChunkTelemetry` (one trial or a batch): the int32
    counters, the residual in ``dtype``."""
    dev = resolve_device(device)
    return ChunkTelemetry(**_ints(tel, devtel.INT_FIELDS, dev),
                          **_floats(tel, ("admm_residual",), dev, dtype))


def sim_state_from_numpy(s, device=None, dtype=torch.float32) -> SimState:
    """swarm, goal, v2f, tick, flight, loc, first_auction, assign_enabled,
    cbaa_warm, faults, scenario, inv, tel."""
    dev = resolve_device(device)
    swarm, goal, flight = _get(s, "swarm"), _get(s, "goal"), _get(s, "flight")
    loc, warm = _get(s, "loc"), _optional(s, "cbaa_warm")
    faults, scen = _optional(s, "faults"), _optional(s, "scenario")
    inv, tel = _optional(s, "inv"), _optional(s, "tel")
    tick = np.asarray(_get(s, "tick"))
    return SimState(
        swarm=SwarmState(**_floats(swarm, ("q", "vel"), dev, dtype)),
        goal=TrajGoal(**_floats(goal, ("pos", "vel", "yaw", "dyaw"), dev,
                                dtype)),
        v2f=_ints(s, ("v2f",), dev)["v2f"],
        tick=int(tick) if tick.ndim == 0 else tick.astype(np.int64),
        flight=FlightState(
            **_ints(flight, ("mode", "ticks_in_mode"), dev),
            **_floats(flight, ("initial_alt", "takeoff_alt"), dev, dtype)),
        loc=None if loc is None else EstimateTable(
            est=_floats(loc, ("est",), dev, dtype)["est"],
            age=_ints(loc, ("age",), dev)["age"]),
        first_auction=torch.as_tensor(
            np.array(_get(s, "first_auction"), bool), device=dev),
        assign_enabled=torch.as_tensor(
            np.array(_get(s, "assign_enabled"), bool), device=dev),
        cbaa_warm=None if warm is None else cbaa_tables_from_numpy(
            warm, dev, dtype),
        faults=None if faults is None else fault_schedule_from_numpy(
            faults, dev, dtype),
        scenario=None if scen is None else scenario_from_numpy(
            scen, dev, dtype),
        inv=None if inv is None else invariant_state_from_numpy(inv, dev),
        tel=None if tel is None else telemetry_from_numpy(tel, dev, dtype))


def _np(obj) -> dict:
    return {f.name: getattr(obj, f.name).cpu().numpy() for f in fields(obj)}


def _np_keyed(obj) -> dict | None:
    """`_np` with the key words as the reference's uint32."""
    if obj is None:
        return None
    out = _np(obj)
    out["key"] = out["key"].astype(np.uint32)
    return out


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
        "faults": _np_keyed(state.faults),
        "scenario": _np_keyed(state.scenario),
        "inv": None if state.inv is None else _np(state.inv),
        "tel": None if state.tel is None else _np(state.tel),
    }


def summary_carry_from_numpy(c, device=None, dtype=torch.float32
                             ) -> SummaryCarry:
    """The reference's `SummaryCarry` (one trial or a batch): the float
    histories and filters in ``dtype``, the recovery clock as it is."""
    dev = resolve_device(device)
    return SummaryCarry(
        **_floats(c, ("dn_hist", "ca_hist", "fx", "fy", "cumdist"), dev,
                  dtype),
        **{k: torch.as_tensor(np.array(_get(c, k), bool), device=dev)
           for k in ("inited", "rec_pending")},
        **_ints(c, ("rec_since", "rec_churn"), dev))


def summary_carry_to_numpy(carry: SummaryCarry) -> dict:
    """The port's carry as a dict of numpy arrays, the reference's field
    names."""
    return _np(carry)
