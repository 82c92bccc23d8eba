"""The port's timer (`aclswarm_torch.utils.timing`) on the reference's own
timing cases (`tests/test_utils.py`), with torch tensors in place of JAX
arrays; the reference's functions beside it on the same digests."""
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aclswarm_torch.telemetry import MetricsRegistry
from aclswarm_torch.utils import (Stopwatch, median_time, readback_sync,
                                  timing)
from aclswarm_tpu.utils import timing as ref_timing

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers


class TestTiming:
    def test_readback_sync_returns_scalar(self):
        assert readback_sync(torch.arange(5.0)) == 0.0
        assert readback_sync((torch.full((2, 2), 3.0),
                              torch.zeros(1))) == 3.0

    def test_median_time_measures(self):
        def fn(x):
            time.sleep(0.01)
            return x
        dt = median_time(fn, torch.zeros(1), per=1, reps=3)
        assert 0.005 < dt < 0.5

    def test_median_time_divides_by_per(self):
        def fn(x):
            time.sleep(0.02)
            return x
        dt = median_time(fn, torch.zeros(1), per=10, reps=2)
        assert dt < 0.01

    def test_stopwatch_phases(self):
        sw = Stopwatch()
        with sw.phase("a"):
            time.sleep(0.005)
        with sw.phase("b"):
            pass
        names = [n for n, _ in sw.phases]
        assert names == ["a", "b"]
        assert sw.phases[0][1] >= 0.005
        lines = []
        sw.report(lines.append)
        assert len(lines) == 2 and lines[0].startswith("a:")


class TestTimingStats:
    def test_keys_and_ordering(self):
        stats = timing.timing_stats(lambda x: x, torch.zeros(1), reps=4)
        ref = ref_timing.timing_stats(lambda x: x, jnp.zeros(1), reps=4)
        assert set(stats) == set(ref) == {"median_s", "min_s", "max_s",
                                          "reps"}
        assert stats["min_s"] <= stats["median_s"] <= stats["max_s"]
        assert stats["reps"] == 4

    def test_warmup_not_measured(self):
        """The first (warmup) call must not pollute the stats."""
        calls = []

        def fn(x):
            calls.append(time.perf_counter())
            if len(calls) == 1:
                time.sleep(0.05)        # a cold first call
            return x

        stats = timing.timing_stats(fn, torch.zeros(1), reps=3)
        assert len(calls) == 4          # 1 warmup + 3 reps
        assert stats["max_s"] < 0.05

    def test_per_divides_every_stat(self):
        def fn(x):
            time.sleep(0.02)
            return x

        s1 = timing.timing_stats(fn, torch.zeros(1), per=1, reps=2)
        s10 = timing.timing_stats(fn, torch.zeros(1), per=10, reps=2)
        assert s10["median_s"] < s1["median_s"] / 5
        assert s10["max_s"] < 0.01

    def test_median_time_matches_stats(self):
        dt = median_time(lambda x: x, torch.zeros(1), reps=3)
        assert isinstance(dt, float) and dt >= 0.0

    def test_readback_sync_is_a_barrier(self):
        """readback_sync returns a host float of the FIRST leaf, in the
        reference's leaf order (dict values by sorted key)."""
        out = readback_sync({"b": torch.zeros(2),
                             "a": torch.full((3,), 7.5)})
        assert isinstance(out, float) and out == 7.5

    def test_named_stats_land_in_the_histogram(self):
        """``name=`` records every rep into ``timing_<name>_s`` of the
        registry given; the returned key set is unchanged."""
        reg = MetricsRegistry()
        stats = timing.timing_stats(lambda x: x, torch.zeros(1), reps=3,
                                    name="probe", registry=reg)
        assert set(stats) == {"median_s", "min_s", "max_s", "reps"}
        hist = reg.snapshot()["metrics"]["timing_probe_s"]
        assert hist["count"] == 3


@pytest.mark.parametrize("x", [
    np.arange(4.0) + 2.5,
    (np.full((2, 2), -1.25), np.zeros(3)),
    {"z": np.zeros(2), "m": np.full(3, 4.0)},
    [None, np.array([[9.0]])],
])
def test_readback_sync_equals_the_reference(x):
    """The same host digests give the same float in both packages; the
    port's on torch tensors too."""
    def as_torch(t):
        if isinstance(t, dict):
            return {k: as_torch(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(as_torch(v) for v in t)
        return None if t is None else torch.from_numpy(np.asarray(t))

    want = ref_timing.readback_sync(x)
    assert readback_sync(x) == want
    assert readback_sync(as_torch(x)) == want


def test_trace_writes_a_chrome_trace(tmp_path):
    """`timing.trace` wraps `torch.profiler`: the log directory holds a
    Chrome trace naming the profiled operation."""
    logdir = tmp_path / "prof"
    with timing.trace(str(logdir)):
        readback_sync(torch.arange(8.0) * 2.0)
    trace = logdir / "trace.json"
    assert trace.exists()
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]}
    assert "aten::mul" in names
