"""Scenario timelines (port of `aclswarm_tpu.scenarios`): five composable
axes (pop-up and moving obstacles, wind and sensor noise, tick-scheduled
formation stages, byzantine bidders, goal drift with a re-matching
cadence) as data riding `SimState.scenario`, and the registry of named
families they are sampled from."""
from aclswarm_torch.scenarios.registry import (AXES, FAMILIES,
                                               ScenarioFamily, compose,
                                               sample, validate)
from aclswarm_torch.scenarios.timeline import (DEFAULT_MAX_OBSTACLES,
                                               DEFAULT_MAX_STAGES, NEVER,
                                               Scenario, est_noise_at,
                                               formation_points_at,
                                               no_scenario, obstacles_at,
                                               rematch_ok_at,
                                               reported_positions,
                                               scenario_event_at, stage_at,
                                               wind_at)

__all__ = ["Scenario", "no_scenario", "NEVER", "DEFAULT_MAX_OBSTACLES",
           "DEFAULT_MAX_STAGES", "obstacles_at", "stage_at",
           "formation_points_at", "reported_positions", "wind_at",
           "est_noise_at", "rematch_ok_at", "scenario_event_at",
           "AXES", "FAMILIES", "ScenarioFamily", "compose", "sample",
           "validate"]
