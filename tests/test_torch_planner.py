"""The planner behind the wire: the port's `TorchPlanner` against the
reference's `TpuPlanner`, float64 on the CPU, driven purely through wire
messages.

Both planners take the same seeded formations, dispatches and estimate
streams tick by tick, in every assignment mode ('auction', 'sinkhorn' —
the reference's own CPU mode, as `tests/test_torch_assignment.py` runs it
— and 'cbaa' on a per-vehicle estimate table), with gains in the dispatch
and without (the ADMM design in both packages), in central-assignment
mode, through the first-accept publication and KILL/GO. At n=6 the
avoidance is dense; at n=80 the planner's "auto" rule prunes it to k=16.

Tolerances: permutations, `auction_valid` and the avoidance flags bit for
bit; distcmd within 1e-9 + 1e-9 |ref| (float64, summation order only).
The n=80 cases use seed 1, which is clear of the k-pruned avoidance's
duplicate-sector coin flip (ROADMAP.md, "Faults in the port";
`tests/test_torch_control.py::test_colavoid_duplicate_sector_coin_flip`):
the flags agree there tick for tick.

The rest ports the cases of `tests/test_interop.py::{TestPlanner,
TestPlannerFirstAcceptSemantics, TestCentralAssignment, TestOperator}` to
the port's planner, operator and `cbaa_ref`.
"""
import numpy as np
import pytest
import torch

from aclswarm_torch.interop import codec
from aclswarm_torch.interop import messages as m
from aclswarm_torch.interop.planner import TorchPlanner
from aclswarm_tpu.interop import messages as rm
from aclswarm_tpu.interop.planner import TpuPlanner

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

RTOL = ATOL = 1e-9


def _planner(n, **kw):
    return TorchPlanner(n, device="cpu", dtype="float64", **kw)


def _pair(n, **kw):
    return _planner(n, **kw), TpuPlanner(n, **kw)


def _formation(points, adj, gains, name="f"):
    """The same dispatch as each package's wire message."""
    kw = dict(name=name, points=points, adjmat=adj, gains=gains)
    return (m.Formation(header=m.Header(seq=1), **kw),
            rm.Formation(header=rm.Header(seq=1), **kw))


def _commit(pair, points, adj, gains):
    for pl, msg in zip(pair, _formation(points, adj, gains)):
        pl.handle_formation(msg)


def _same(out, ref, k=None):
    """One tick's outputs: discrete fields bit for bit, distcmd within
    the stated tolerance."""
    assert (out.assignment is None) == (ref.assignment is None), k
    if ref.assignment is not None:
        assert out.assignment.dtype == np.int32
        np.testing.assert_array_equal(out.assignment, ref.assignment)
    assert out.auction_valid == ref.auction_valid, k
    np.testing.assert_array_equal(out.safety, np.asarray(ref.safety))
    np.testing.assert_allclose(out.distcmd, np.asarray(ref.distcmd),
                               rtol=RTOL, atol=ATOL)


def _problem(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10, 10, size=(n, 3))
    pts[:, 2] = rng.uniform(1, 3, size=n)
    adj = np.ones((n, n), np.uint8) - np.eye(n, dtype=np.uint8)
    gains = (rng.normal(size=(3 * n, 3 * n)) * 0.01).astype(np.float32)
    q = pts[rng.permutation(n)] + rng.normal(size=(n, 3))
    return rng, pts, adj, gains, q


def _fly(pair, q, ticks, rng=None, est_noise=None, feed=None):
    """Tick both planners on one stream (integrated from the port's
    commands, velocity tracking at tau 0.15 s); ``est_noise`` adds a
    per-vehicle estimate table; ``feed(k)`` runs before tick k. Returns
    the ticks that published an assignment."""
    n = q.shape[0]
    vel = np.zeros((n, 3))
    published = []
    for k in range(ticks):
        if feed is not None:
            feed(k)
        est = None
        if est_noise is not None:
            est = q[None] + rng.normal(scale=est_noise, size=(n, n, 3))
            est[np.arange(n), np.arange(n)] = q
        out, ref = (pl.tick(q, vel=vel, est=est) for pl in pair)
        _same(out, ref, k)
        if out.assignment is not None:
            published.append(k)
        vel += (0.01 / 0.15) * (out.distcmd - vel)
        q = q + vel * 0.01
    return published


@pytest.mark.parametrize("n", [6, 80])
@pytest.mark.parametrize("mode", ["auction", "sinkhorn", "cbaa"])
def test_ticks_match_reference(mode, n):
    """Every tick of a 25-tick flight with an auction every 10 ticks:
    equal permutations, validity and flags, distcmd within tolerance;
    'cbaa' aligns on a per-vehicle estimate table."""
    rng, pts, adj, gains, q = _problem(n, seed=1)
    pair = _pair(n, assignment=mode, assign_every=10)
    assert pair[0].cfg.colavoid_neighbors == (16 if n > 64 else None)
    _commit(pair, pts, adj, gains)
    published = _fly(pair, q, 25, rng,
                     est_noise=0.05 if mode == "cbaa" else None)
    assert published and published[0] == 0


def test_dispatch_without_gains_designs_them_alike():
    """A dispatch without gains runs the ADMM design in both packages:
    the committed gains agree and the ticks after it too."""
    n = 6
    rng = np.random.default_rng(2)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([3 * np.cos(ang), 3 * np.sin(ang),
                    1.5 + 0.5 * np.sin(2 * ang)], 1)
    adj = np.ones((n, n), np.uint8) - np.eye(n, dtype=np.uint8)
    pair = _pair(n, assignment="sinkhorn", assign_every=10)
    _commit(pair, pts, adj, None)
    g_port = pair[0].formation.gains.numpy()
    g_ref = np.asarray(pair[1].formation.gains)
    assert np.any(g_port != 0.0)
    np.testing.assert_allclose(g_port, g_ref, rtol=1e-7, atol=1e-9)
    q = pts[rng.permutation(n)] + rng.normal(scale=0.5, size=(n, 3))
    assert _fly(pair, q, 15)[0] == 0


def test_central_assignment_matches_reference():
    """Comparison mode in both packages: no auction without a push, the
    push adopted at the cadence and published once, an unchanged push
    ignored, a changed one adopted, a malformed one refused."""
    n = 6
    rng, pts, adj, gains, q = _problem(n, seed=3)
    pair = _pair(n, assign_every=5, central_assignment=True)
    _commit(pair, pts, adj, gains)
    pushes = {2: np.roll(np.arange(n), 1), 9: np.roll(np.arange(n), 1),
              13: np.roll(np.arange(n), 3),
              17: np.array([0, 0, 1, 2, 3, 4])}

    def feed(k):
        if k in pushes:
            oks = [pl.handle_central_assignment(
                msgs.Assignment(header=msgs.Header(),
                                perm=pushes[k].astype(np.int32)))
                for pl, msgs in zip(pair, (m, rm))]
            assert oks[0] == oks[1] == (k != 17)

    published = _fly(pair, q, 22, feed=feed)
    assert published == [5, 15]
    np.testing.assert_array_equal(pair[0].v2f.numpy(),
                                  np.asarray(pair[1].v2f))


def test_first_accept_and_kill_go_match_reference():
    """The first valid auction after a commit publishes even unchanged;
    later unchanged auctions do not; KILL zeroes the command and holds
    the auction cadence until GO; a second commit re-arms the first
    publication."""
    n = 4
    pts = np.array([[0., 0, 1], [2, 0, 1], [2, 2, 1], [0, 2, 1]])
    adj = np.ones((n, n), np.uint8) - np.eye(n, dtype=np.uint8)
    pair = _pair(n, assign_every=10)
    for pl in pair:
        out = pl.tick(pts)
        assert np.all(np.asarray(out.distcmd) == 0)
        assert out.assignment is None
    _commit(pair, pts, adj, None)

    def mode(k, which):
        for pl, msgs in zip(pair, (m, rm)):
            pl.handle_flightmode(msgs.FlightMode(header=msgs.Header(),
                                                 mode=which))

    schedule = {12: m.MODE_KILL, 25: m.MODE_GO}
    killed = []

    def feed(k):
        if k in schedule:
            mode(k, schedule[k])
        if k == 32:
            _commit(pair, pts * 1.2, adj, None)
        killed.append(pair[0].killed)

    vel = np.zeros((n, 3))
    published = []
    for k in range(45):
        feed(k)
        out, ref = (pl.tick(pts + 0.2, vel=vel) for pl in pair)
        _same(out, ref, k)
        if killed[-1]:
            assert np.all(out.distcmd == 0) and out.assignment is None
        if out.assignment is not None:
            published.append(k)
    assert published == [0, 32]


def test_one_device_read_a_tick(monkeypatch):
    """A tick off the auction cadence reads the device once: one host
    copy of the tick's outputs, no scalar reads."""
    n = 6
    _, pts, adj, gains, q = _problem(n, seed=4)
    pl = _planner(n, assignment="sinkhorn", assign_every=10)
    pl.handle_formation(_formation(pts, adj, gains)[0])
    pl.tick(q)                                   # the auction tick
    reads = []
    for name in ("cpu", "item", "tolist", "numpy", "__bool__"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            reads.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    for _ in range(3):
        reads.clear()
        pl.tick(q)
        assert reads == ["cpu", "numpy"]


# -- the reference's TestPlanner, TestPlannerFirstAcceptSemantics ------------

def _ring(n=6):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([3 * np.cos(ang), 3 * np.sin(ang), np.full(n, 1.5)], 1)
    adj = np.ones((n, n), np.uint8) - np.eye(n, dtype=np.uint8)
    return pts, adj


class TestPlanner:
    """Drive the port's planner purely through the message-shaped API."""

    def test_formation_then_ticks(self):
        n = 6
        pts, adj = _ring(n)
        planner = _planner(n, assign_every=50)
        out = planner.tick(np.zeros((n, 3)))
        assert np.all(out.distcmd == 0) and out.assignment is None
        planner.handle_formation(m.Formation(
            header=m.Header(seq=1, stamp=0.0), name="ring6", points=pts,
            adjmat=adj))
        rng = np.random.default_rng(5)
        q = rng.normal(size=(n, 3)) * 2.0
        q[:, 2] = 1.5
        out = planner.tick(m.VehicleEstimates(
            header=m.Header(seq=1, stamp=0.0), positions=q,
            stamps=np.zeros(n)))
        assert out.assignment is not None
        assert sorted(out.assignment.tolist()) == list(range(n))
        assert out.auction_valid
        assert np.linalg.norm(out.distcmd) > 0
        dt, tau = 0.01, 0.15
        vel = np.zeros((n, 3))
        for k in range(2, 1500):
            out = planner.tick(m.VehicleEstimates(
                header=m.Header(seq=k, stamp=k * dt), positions=q,
                stamps=np.full(n, k * dt)), vel=vel)
            vel += (dt / tau) * (out.distcmd - vel)
            q = q + vel * dt
        assert np.linalg.norm(out.distcmd, axis=1).mean() < 0.3

    def test_formation_with_gains_skips_solve(self, monkeypatch):
        from aclswarm_torch import gains as gainslib
        n = 4
        pts = np.array([[0., 0, 1], [2, 0, 1], [2, 2, 1], [0, 2, 1]])
        adj = np.ones((n, n), np.uint8) - np.eye(n, dtype=np.uint8)
        G = gainslib.solve_gains(torch.as_tensor(pts), adj).numpy()
        fmsg = codec.decode(codec.encode(m.Formation(
            header=m.Header(), name="sq", points=pts, adjmat=adj,
            gains=G.astype(np.float32))))

        def no_solve(*a, **kw):
            raise AssertionError("a dispatch with gains must not design")
        monkeypatch.setattr(gainslib, "solve_gains", no_solve)
        planner = _planner(n)
        planner.handle_formation(fmsg)
        assert planner.tick(pts + 0.1).assignment is not None

    def test_wrong_size_rejected(self):
        pts, adj = _ring(6)
        with pytest.raises(ValueError):
            _planner(5).handle_formation(m.Formation(
                header=m.Header(), name="x", points=pts, adjmat=adj))

    def test_large_swarm_assignment_is_exact_int32(self):
        """n > 255 publishes an int32 permutation (a uint8 payload would
        wrap indices >= 256)."""
        n = 300
        rng = np.random.default_rng(0)
        pts = rng.normal(size=(n, 3)) * 20.0
        adj = np.ones((n, n), np.uint8) - np.eye(n, dtype=np.uint8)
        planner = _planner(n, assignment="sinkhorn")
        planner.handle_formation(m.Formation(
            header=m.Header(), name="big", points=pts, adjmat=adj,
            gains=np.zeros((3 * n, 3 * n), np.float32)))
        out = planner.tick(rng.normal(size=(n, 3)) * 20.0)
        assert out.assignment is not None
        assert out.assignment.dtype == np.int32
        assert sorted(out.assignment.tolist()) == list(range(n))

    def test_unchanged_assignment_after_commit_is_published(self):
        n = 4
        pts = np.array([[0., 0, 1], [2, 0, 1], [2, 2, 1], [0, 2, 1]])
        adj = np.ones((n, n), np.uint8) - np.eye(n, dtype=np.uint8)
        planner = _planner(n, assign_every=10)
        planner.handle_formation(m.Formation(
            header=m.Header(), name="sq", points=pts, adjmat=adj))
        assert planner.tick(pts).assignment is not None
        for _ in range(10):
            out = planner.tick(pts)
        assert out.assignment is None


# -- the reference's TestCentralAssignment ------------------------------------

class TestCentralAssignment:
    def _planner(self, n=6, assign_every=10):
        pts, adj = _ring(n)
        pl = _planner(n, assign_every=assign_every,
                      central_assignment=True)
        pl.handle_formation(m.Formation(
            header=m.Header(), name="ring", points=pts, adjmat=adj,
            gains=np.zeros((3 * n, 3 * n), np.float32)))
        return pl, pts

    def test_pushed_assignment_overrides_auction(self):
        pl, pts = self._planner()
        q = pts[np.random.default_rng(1).permutation(6)]
        pushed = np.roll(np.arange(6), 1).astype(np.int32)
        assert pl.handle_central_assignment(
            m.Assignment(header=m.Header(), perm=pushed))
        out = pl.tick(q)
        np.testing.assert_array_equal(out.assignment, pushed)
        np.testing.assert_array_equal(pl.v2f.numpy(), pushed)
        assert out.auction_valid

    def test_cadence_and_change_gating(self):
        pl, pts = self._planner(assign_every=10)
        ident = np.arange(6, dtype=np.int32)
        pl.handle_central_assignment(ident)
        assert pl.tick(pts).assignment is not None
        pl.handle_central_assignment(ident)
        for _ in range(10):
            assert pl.tick(pts).assignment is None
        newp = np.roll(ident, 2).astype(np.int32)
        pl.handle_central_assignment(newp)
        emitted = [out.assignment for _ in range(10)
                   if (out := pl.tick(pts)).assignment is not None]
        assert len(emitted) == 1
        np.testing.assert_array_equal(emitted[0], newp)

    def test_new_formation_discards_pending_push(self):
        pl, pts = self._planner(assign_every=10)
        pl.handle_central_assignment(np.roll(np.arange(6), 3)
                                     .astype(np.int32))
        adj = np.ones((6, 6), np.uint8) - np.eye(6, dtype=np.uint8)
        pl.handle_formation(m.Formation(
            header=m.Header(), name="ring2", points=pts * 1.5, adjmat=adj,
            gains=np.zeros((18, 18), np.float32)))
        for _ in range(12):
            assert pl.tick(pts).assignment is None
        np.testing.assert_array_equal(pl.v2f.numpy(), np.arange(6))

    def test_malformed_push_rejected(self):
        pl, pts = self._planner()
        assert not pl.handle_central_assignment(
            np.array([0, 0, 1, 2, 3, 4], np.int32))
        assert not pl.handle_central_assignment(np.arange(5,
                                                          dtype=np.int32))
        assert pl.tick(pts).assignment is None
        np.testing.assert_array_equal(pl.v2f.numpy(), np.arange(6))

    def test_no_auction_without_push(self):
        pl, pts = self._planner()
        q = pts[np.random.default_rng(2).permutation(6)]
        for _ in range(25):
            assert pl.tick(q).assignment is None
        np.testing.assert_array_equal(pl.v2f.numpy(), np.arange(6))

    def test_operator_central_matches_lap_oracle(self):
        from aclswarm_torch.assignment.cbaa_ref import arun_np
        from aclswarm_torch.assignment.lapjv import solve_assignment_host
        from aclswarm_torch.interop.operator import Operator
        from aclswarm_tpu.assignment import cbaa_ref as ref_cbaa_ref
        op = Operator("swarm4")
        assert op.central_assignment(np.zeros((4, 3))) is None
        p = np.asarray(op.next_formation().points, np.float64)
        rng = np.random.default_rng(3)
        q = p[rng.permutation(4)] + rng.normal(scale=0.05, size=(4, 3)) \
            + [5.0, 0.0, 0.0]
        msg = op.central_assignment(q)
        assert sorted(msg.perm.tolist()) == list(range(4))
        R, t = arun_np(p, q, d=2)
        Rr, tr = ref_cbaa_ref.arun_np(p, q, d=2)
        np.testing.assert_array_equal(R, Rr)
        np.testing.assert_array_equal(t, tr)
        np.testing.assert_array_equal(
            msg.perm, solve_assignment_host(q, p @ R.T + t))


class TestOperator:
    def test_cycles_group_like_reference(self):
        from aclswarm_torch.interop.operator import Operator
        from aclswarm_tpu.interop.operator import Operator as RefOperator
        op, ref = Operator("swarm4"), RefOperator("swarm4")
        sent, ref_sent = [], []
        for _ in range(4):
            op.dispatch(sent.append)
            ref.dispatch(ref_sent.append)
        names = [s.name for s in sent]
        assert names == [s.name for s in ref_sent]
        assert names[0] != names[1] and names[0] == names[2]
        for a, b in zip(sent, ref_sent):
            np.testing.assert_array_equal(a.points, b.points)
            np.testing.assert_array_equal(a.gains, b.gains)
        assert Operator("swarm4", send_gains=False).next_formation() \
            .gains is None

    def test_flight_mode_service(self):
        """START takes off (GO), then cycles formations; END lands; KILL
        is always honored — the same broadcasts as the reference's."""
        from aclswarm_torch.interop.operator import Operator
        from aclswarm_tpu.interop.operator import Operator as RefOperator
        logs = []
        for cls in (Operator, RefOperator):
            op, modes, forms = cls("swarm4"), [], []
            assert op.start(modes.append) is None and op.flying
            assert op.start(modes.append, forms.append) is not None
            op.end(modes.append)
            op.end(modes.append)             # only in flight
            op.kill(modes.append)
            logs.append(([x.mode for x in modes], [f.name for f in forms]))
        assert logs[0] == logs[1]
        assert logs[0][0] == [m.MODE_GO, m.MODE_LAND, m.MODE_KILL]
