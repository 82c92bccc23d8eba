"""Closed-loop swarm simulation (port of `aclswarm_tpu.sim`)."""
from aclswarm_torch.sim import localization, vehicle
from aclswarm_torch.sim.engine import (SimConfig, SimState, StepMetrics,
                                       assign, init_state, rollout, step)
from aclswarm_torch.sim.localization import EstimateTable
from aclswarm_torch.sim.vehicle import ExternalInputs, FlightState

__all__ = ["SimConfig", "SimState", "StepMetrics", "init_state", "rollout",
           "step", "assign", "vehicle", "ExternalInputs", "FlightState",
           "localization", "EstimateTable"]
