"""Timing and profiling (port of `aclswarm_tpu/utils/timing.py`).

The reference's tracing story is wall-clock log lines around the gain
solve (`coordination_ros.cpp:113-118`) and MATLAB tic/toc. This module is
the benchmark timer and the profiler hook:

- `readback_sync`: the completion barrier: one scalar copied to the host
  cannot arrive before the work that produced it has finished (on a CUDA
  tensor the copy waits for the stream);
- `timing_stats` / `median_time`: timing of a call that returns a small
  digest, read back each rep;
- `trace`: `torch.profiler` around a block (CPU and CUDA activities), a
  Chrome trace written into the log directory (Perfetto,
  ``chrome://tracing``);
- `Stopwatch`: the reference's log-line pattern (wall clock of a named
  phase), for host-side code.

torch is imported inside the functions that need it, so importing
`aclswarm_torch.utils` stays light.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np


def _first_leaf(x):
    """The first leaf of a container tree, in the reference's
    `jax.tree.leaves` order: tuple and list items in order, dict values by
    sorted key, dataclass fields in order; None drops out."""
    import dataclasses

    if x is None:
        return None
    if isinstance(x, dict):
        items = [x[k] for k in sorted(x)]
    elif isinstance(x, (tuple, list)):
        items = list(x)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        items = [getattr(x, f.name) for f in dataclasses.fields(x)]
    else:
        return x
    for item in items:
        leaf = _first_leaf(item)
        if leaf is not None:
            return leaf
    return None


def readback_sync(x) -> float:
    """Block until ``x`` is computed by fetching one scalar of its first
    leaf to the host. A device-to-host copy cannot complete before the
    producing kernels do, so no separate synchronize is needed."""
    leaf = _first_leaf(x)
    if hasattr(leaf, "detach"):          # a torch tensor
        return float(leaf.detach().reshape(-1)[0].item())
    return float(np.asarray(leaf).ravel()[0])


def timing_stats(fn, arg, per: int = 1, reps: int = 5,
                 name: str | None = None, registry=None) -> dict:
    """Wall-second statistics of ``fn(arg)`` divided by ``per``, after one
    warmup call; ``fn`` should return a small digest (see
    `readback_sync`). For device work, chain ``per`` distinct instances
    inside ``fn`` so fixed launch overhead amortizes.

    Returns the median plus the rep spread (min/max).

    ``name`` additionally records every rep into the ``timing_<name>_s``
    histogram of the port's telemetry registry (the default process
    registry unless ``registry`` overrides it). The returned dict's key set
    is unchanged."""
    readback_sync(fn(arg))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        readback_sync(fn(arg))
        times.append((time.perf_counter() - t0) / per)
    if name is not None:
        if registry is None:
            from aclswarm_torch.telemetry import get_registry
            registry = get_registry()
        hist = registry.histogram(f"timing_{name}_s")
        for t in times:
            hist.observe(t)
    return {"median_s": float(np.median(times)),
            "min_s": float(np.min(times)), "max_s": float(np.max(times)),
            "reps": reps}


def median_time(fn, arg, per: int = 1, reps: int = 5) -> float:
    """Median-only convenience wrapper over `timing_stats`."""
    return timing_stats(fn, arg, per=per, reps=reps)["median_s"]


@contextlib.contextmanager
def trace(logdir: str):
    """`torch.profiler` trace around a block::

        with timing.trace("prof"):
            rollout(...)  # then open prof/trace.json in Perfetto

    Records CPU and CUDA activity (CUDA only when a card is present) and
    writes the Chrome trace ``<logdir>/trace.json``: per-kernel device
    timelines, launches and copies."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Stopwatch:
    """Named wall-clock phases, the `coordination_ros.cpp:113-118` log
    pattern::

        sw = Stopwatch()
        with sw.phase("gains"):
            solve(...)
        sw.report(logger.info)
    """

    def __init__(self):
        self.phases: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases.append((name, time.perf_counter() - t0))

    def report(self, sink=print) -> None:
        for name, secs in self.phases:
            sink(f"{name}: {secs * 1e3:.2f} ms")
