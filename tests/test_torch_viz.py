"""The port's offline and live plots (`aclswarm_torch.harness.viz`,
`.liveplot`): the aligned desired formation against the reference
package's, and the reference's `tests/test_viz.py` cases on the port
(PNGs of a port rollout, the rolling multiplot, the wire consumer over
injected channels and over the port's shm rings)."""
import fcntl
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from aclswarm_torch import gains as t_gains
from aclswarm_torch import sim
from aclswarm_torch.core.types import (ControlGains, SafetyParams,
                                       make_formation)
from aclswarm_torch.harness import liveplot, viz
from aclswarm_torch.interop import messages as m
from aclswarm_tpu.harness import viz as j_viz

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers


@pytest.mark.parametrize("seed", range(4))
def test_aligned_formation_matches_the_references(seed):
    """Random swarms, formations and assignments (float64): the port's
    d=2 Arun alignment in vehicle order equals the reference's."""
    rng = np.random.default_rng(seed)
    n = 5 + seed
    pts = rng.uniform(-5, 5, size=(n, 3))
    q = rng.uniform(-20, 20, size=(n, 3))
    v2f = rng.permutation(n)
    got = viz.aligned_formation(q, pts, v2f)
    want = j_viz.aligned_formation(q, pts, v2f)
    assert got.shape == (n, 3) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # tensors in, the same array out
    np.testing.assert_array_equal(
        viz.aligned_formation(torch.from_numpy(q), torch.from_numpy(pts),
                              torch.from_numpy(v2f)), got)


@pytest.fixture(scope="module")
def short_rollout():
    """`tests/test_viz.py`'s rollout on the port (float64, CPU)."""
    n = 4
    pts = np.array([[0., 0, 1], [2, 0, 1], [2, 2, 1], [0, 2, 1]])
    adj = np.ones((n, n)) - np.eye(n)
    G = t_gains.solve_gains(pts, adj, device="cpu")
    formation = make_formation(pts, adj, G, device="cpu",
                               dtype=torch.float64)
    rng = np.random.default_rng(0)
    q0 = rng.normal(size=(n, 3))
    q0[:, 2] = 1.0
    state = sim.init_state(q0, device="cpu", dtype=torch.float64)
    cfg = sim.SimConfig(dynamics="firstorder")
    _, metrics = sim.rollout(state, formation, ControlGains(),
                             SafetyParams(), cfg, 600)
    return metrics, formation


def test_aligned_formation_properties(short_rollout):
    metrics, formation = short_rollout
    q = metrics.q[-1].numpy()
    v2f = metrics.v2f[-1].numpy()
    pts = formation.points.numpy()
    goal = viz.aligned_formation(q, pts, v2f)
    # rigid alignment: the displayed goal keeps the formation's shape
    # (pairwise distances) in vehicle order
    want = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    have = np.linalg.norm(goal[:, None] - goal[None, :], axis=-1)
    np.testing.assert_allclose(have, want[np.ix_(v2f, v2f)], atol=1e-8)
    # d=2 alignment matches the swarm's xy centroid
    np.testing.assert_allclose(goal[:, :2].mean(0), q[:, :2].mean(0),
                               atol=1e-8)


def test_plot_rollout(short_rollout, tmp_path):
    pytest.importorskip("matplotlib")
    metrics, formation = short_rollout
    out = viz.plot_rollout(metrics, formation, str(tmp_path / "r.png"))
    assert out == str(tmp_path / "r.png")
    assert (tmp_path / "r.png").stat().st_size > 10_000


def test_plot_timeseries(short_rollout, tmp_path):
    pytest.importorskip("matplotlib")
    metrics, _ = short_rollout
    viz.plot_timeseries(metrics, str(tmp_path / "t.png"))
    assert (tmp_path / "t.png").stat().st_size > 10_000


def _messages(n, ticks, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 3))
    out = []
    for k in range(ticks):
        t = k * 0.01
        out.append(m.DistCmd(header=m.Header(seq=k, stamp=t),
                             vel=rng.normal(size=(n, 3))))
        out.append(m.SafetyStatusArray(
            header=m.Header(seq=k, stamp=t),
            active=(rng.random(n) < 0.2).astype(np.uint8)))
        out.append(m.VehicleEstimates(
            header=m.Header(seq=k, stamp=t), positions=q + 0.01 * k,
            stamps=np.full(n, t)))
    return out


class TestLivePlot:
    def test_ingest_and_render(self, tmp_path):
        """The rqt_multiplot-equivalent consumer: wire messages in, a
        multiplot frame out."""
        pytest.importorskip("matplotlib")
        lp = liveplot.LivePlot(n=4, window_s=0.5)
        assert all(lp.ingest(msg) for msg in _messages(4, 120))
        assert not lp.ingest(m.FlightMode(header=m.Header(seq=0, stamp=0.0),
                                          mode=1))
        out = tmp_path / "live.png"
        lp.render(str(out))
        assert out.exists() and out.stat().st_size > 5000
        # rolling window: only the trailing 0.5 s stays buffered
        ts, vel = lp._window(lp._cmd)
        assert ts[0] >= ts[-1] - 0.5 and vel.shape[1:] == (4, 3)
        assert not (tmp_path / "live.png.tmp.png").exists()

    def test_observe_over_injected_channels(self, tmp_path):
        """End to end over injected channels (the shm deployment shape is
        the same recv loop)."""
        pytest.importorskip("matplotlib")

        class FakeChannel:
            def __init__(self, msgs):
                self.msgs = list(msgs)

            def recv(self):
                return self.msgs.pop(0) if self.msgs else None

        n = 3
        msgs = _messages(n, 50, seed=1)
        out = tmp_path / "obs.png"
        frames = liveplot.observe(
            "/unused", n, str(out), interval_s=0.1, duration_s=0.4,
            channels={"distcmd": FakeChannel(msgs[0::3]),
                      "safety": FakeChannel(msgs[1::3]),
                      "estimates": FakeChannel([])})
        assert frames >= 2 and out.exists()

    def test_observe_over_the_ports_shm_rings(self, tmp_path):
        """`observe` opens the ``<ns>-*`` rings of the port's transport
        itself and drains what a producer wrote there."""
        pytest.importorskip("matplotlib")
        from aclswarm_torch.interop import native as nat
        from aclswarm_torch.interop.transport import Channel

        lock = Path(nat._LIB_PATH).parent
        lock.mkdir(parents=True, exist_ok=True)
        with open(lock / ".build.lock", "a+b") as f:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            ok = nat.build()
        if not ok:
            pytest.skip("native transport not built (make -C native)")
        ns = "/asw-torchviz-" + uuid.uuid4().hex[:8]
        n = 3
        producers = {name: Channel(f"{ns}-{name}", create=True)
                     for name in ("distcmd", "safety", "estimates")}
        try:
            for msg in _messages(n, 40, seed=2):
                name = {m.DistCmd: "distcmd", m.SafetyStatusArray: "safety",
                        m.VehicleEstimates: "estimates"}[type(msg)]
                assert producers[name].send(msg)
            out = tmp_path / "shm.png"
            frames = liveplot.observe(ns, n, str(out), interval_s=0.1,
                                      duration_s=0.3)
            assert frames >= 2 and out.stat().st_size > 5000
            assert all(ch.queued_bytes == 0 for ch in producers.values())
        finally:
            for ch in producers.values():
                ch.close()
