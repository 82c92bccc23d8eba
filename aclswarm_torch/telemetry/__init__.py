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
  registry;
- the serving layer's trace ids and lifecycle-event stream
  (`telemetry.lifecycle`) and the postmortem that rebuilds each
  request's timeline from the journal alone (`telemetry.postmortem`,
  ``python -m aclswarm_torch.telemetry.postmortem <journal> --all``);
- the health tier: a bounded `TimeSeriesStore` fed by a cadenced
  `Sampler` (persisted to ``timeseries.log``), a declarative SLO catalog
  evaluated by a multi-window burn-rate engine with a
  pending -> firing -> resolved alert machine (`telemetry.slo`), and the
  `watch` CLI (``--tcp HOST:PORT`` or ``--log <timeseries.log>``).

Each is a copy of the reference's module. This package __init__ stays
stdlib-only, as the reference's does.
"""
from aclswarm_torch.telemetry.lifecycle import (LifecycleLog, TraceContext,
                                                make_event, mint_trace_id)
from aclswarm_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                               MetricsRegistry, get_registry,
                                               reset_registry)
from aclswarm_torch.telemetry.slo import (SloEngine, SloSpec, SwarmWatch,
                                          default_slos)
from aclswarm_torch.telemetry.spans import (FlightRecorder, Span,
                                            install_crash_dump)
from aclswarm_torch.telemetry.timeseries import (Sampler, TimeSeriesStore,
                                                 load_store)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "reset_registry", "FlightRecorder", "Span",
           "install_crash_dump", "LifecycleLog", "TraceContext",
           "make_event", "mint_trace_id", "TimeSeriesStore", "Sampler",
           "load_store", "SloSpec", "SloEngine", "SwarmWatch",
           "default_slos"]
