"""Telemetry (port of the parts of `aclswarm_tpu.telemetry` the trial
drivers use).

- host metrics (`telemetry.registry`, a copy of the reference's):
  thread-safe counters, gauges, bounded histograms and spans with a
  ring-buffer flight recorder, exported as a snapshot dict, JSONL
  (`MetricsRegistry.dump`, the trial driver's ``telemetry_dump``) and
  Prometheus text;
- device chunk counters (`telemetry.device`, imported explicitly — it
  pulls in torch): the `ChunkTelemetry` carry of the rollout and the
  `ChunkPublisher` that folds its chunk-boundary snapshots into the
  registry.

This package __init__ stays stdlib-only, as the reference's does. The
reference's serving-side tiers (lifecycle, postmortem, time series, SLOs,
watch) are not ported.
"""
from aclswarm_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                               MetricsRegistry, get_registry,
                                               reset_registry)
from aclswarm_torch.telemetry.spans import FlightRecorder, Span

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "reset_registry", "FlightRecorder", "Span"]
