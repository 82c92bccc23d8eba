"""Closed-loop swarm simulation (port of `aclswarm_tpu.sim`)."""
from aclswarm_torch.sim import localization, vehicle
from aclswarm_torch.sim.engine import (SimConfig, SimState, StepMetrics,
                                       assign, batched_rollout, init_state,
                                       rollout, stack_states, step,
                                       take_trials, trial)
from aclswarm_torch.sim.localization import EstimateTable
from aclswarm_torch.sim.vehicle import ExternalInputs, FlightState

__all__ = ["SimConfig", "SimState", "StepMetrics", "init_state", "rollout",
           "step", "assign", "vehicle", "ExternalInputs", "FlightState",
           "localization", "EstimateTable", "batched_rollout",
           "stack_states", "take_trials", "trial"]
