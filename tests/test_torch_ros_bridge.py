"""The port's ROS `aclswarm_msgs` adapter (`aclswarm_torch.interop.
ros_bridge`) on its rospy fakes, its viz markers and its vehicle registry:
the cases of `tests/test_ros_bridge.py` and `tests/test_registry.py`, on
the CPU in float64, and two cases more — `TorchCoordinationNode` against
the reference's `TpuCoordinationNode` on the same fake graph (equal
published assignments, distcmd within 1e-9 + 1e-9 |ref|), and the port's
`param/vehicles.yaml` equal to the reference's.

The shm two-process case runs the port's planner daemon as a subprocess
and needs the native library (``make -C native``); it skips without it.
"""
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from aclswarm_torch.interop import messages as m
from aclswarm_torch.interop import native as nat
from aclswarm_torch.interop import ros_bridge as rb
from aclswarm_torch.interop.ros_fakes import FakeMsgs, FakeRospy, Time

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(0)
CPU = dict(device="cpu", dtype="float64")
VEHS = ["SQ01s", "SQ02s", "SQ03s", "SQ04s"]


def _wire_formation(n=4, gains="zeros", name="sq"):
    pts = np.array([[0.0, 0, 1], [2, 0, 1], [2, 2, 1], [0, 2, 1]])[:n]
    adj = np.ones((n, n), np.uint8) - np.eye(n, dtype=np.uint8)
    g = None
    if gains == "zeros":
        g = np.zeros((3 * n, 3 * n), np.float32)
    elif gains == "solve":
        from aclswarm_torch import gains as gainslib
        g = gainslib.solve_gains(torch.as_tensor(pts), adj).numpy() \
            .astype(np.float32)
    return m.Formation(header=m.Header(seq=1, stamp=0.5, frame_id="world"),
                       name=name, points=pts, adjmat=adj, gains=g)


def _run(ros=None, vehs=VEHS, **kw):
    ros = ros or FakeRospy(params={"/vehs": vehs})
    node = rb.run(ros, FakeMsgs, **({} if "planner" in kw else CPU), **kw)
    assert ros.node_name == "coordination_torch"
    assert len(ros.timers) == 1      # the control timer owns step()
    return ros, node


class TestConverters:
    def test_formation_roundtrip(self):
        fm = _wire_formation(gains="zeros")
        ros = rb.formation_to_ros(fm, FakeMsgs, stamp=Time(0.5))
        assert [d.label for d in ros.adjmat.layout.dim] == ["rows", "cols"]
        assert ros.adjmat.layout.dim[0].stride == 16
        assert ros.adjmat.layout.dim[1].stride == 4
        assert len(ros.points) == 4 and ros.points[1].x == 2.0
        back = rb.formation_from_ros(ros)
        np.testing.assert_array_equal(back.points, fm.points)
        np.testing.assert_array_equal(back.adjmat, fm.adjmat)
        np.testing.assert_array_equal(back.gains, fm.gains)
        assert back.name == "sq"

    def test_formation_without_gains(self):
        fm = _wire_formation(gains=None)
        back = rb.formation_from_ros(rb.formation_to_ros(fm, FakeMsgs))
        assert back.gains is None

    def test_multiarray_layout_faithful_decode(self):
        msg = FakeMsgs.UInt8MultiArray()
        rows, cols, stride, off = 2, 3, 5, 4
        d0, d1 = (FakeMsgs.MultiArrayDimension(),
                  FakeMsgs.MultiArrayDimension())
        d0.size, d0.stride = rows, rows * stride
        d1.size, d1.stride = cols, stride
        msg.layout.dim = [d0, d1]
        msg.layout.data_offset = off
        data = np.zeros(off + rows * stride, np.uint8)
        want = np.arange(1, 7, dtype=np.uint8).reshape(2, 3)
        for i in range(rows):
            data[off + i * stride: off + i * stride + cols] = want[i]
        msg.data = bytes(data)           # rospy hands uint8[] as bytes
        np.testing.assert_array_equal(
            rb._decode_multiarray(msg, np.uint8), want)

    def test_estimates_roundtrip(self):
        est = m.VehicleEstimates(header=m.Header(seq=3, stamp=1.25),
                                 positions=RNG.normal(size=(5, 3)),
                                 stamps=RNG.random(5))
        ros = rb.estimates_to_ros(est, FakeMsgs)
        assert len(ros.positions) == 5
        assert ros.positions[2].header.stamp.to_sec() == \
            pytest.approx(est.stamps[2])
        back = rb.estimates_from_ros(ros)
        np.testing.assert_allclose(back.positions, est.positions)
        np.testing.assert_allclose(back.stamps, est.stamps)
        with pytest.raises(ValueError):
            rb.estimates_from_ros(ros, n=4)

    def test_cbaa_roundtrip(self):
        bid = m.CBAA(header=m.Header(seq=2, stamp=0.1), auction_id=7,
                     iter=3, price=RNG.random(6).astype(np.float32),
                     who=RNG.integers(-1, 6, 6).astype(np.int32))
        back = rb.cbaa_from_ros(rb.cbaa_to_ros(bid, FakeMsgs))
        assert back.auction_id == 7 and back.iter == 3
        np.testing.assert_allclose(back.price, bid.price, rtol=1e-6)
        np.testing.assert_array_equal(back.who, bid.who)

    def test_assignment_roundtrip_uint8_limit_and_wide(self):
        perm = np.array([2, 0, 3, 1], np.int32)
        ros = rb.assignment_to_ros(perm, FakeMsgs)
        assert ros.data == [2, 0, 3, 1] and ros.layout.dim == []
        np.testing.assert_array_equal(rb.assignment_from_ros(ros), perm)
        with pytest.raises(ValueError):
            rb.assignment_to_ros(np.arange(300), FakeMsgs)
        wide = np.random.default_rng(5).permutation(300).astype(np.int32)
        ros = rb.assignment_to_ros(wide, FakeMsgs, wide=True)
        assert isinstance(ros, FakeMsgs.Int32MultiArray)
        np.testing.assert_array_equal(rb.assignment_from_ros(ros), wide)

    def test_flightmode_mapping(self):
        q = FakeMsgs.QuadFlightMode()
        for ros_mode, wire in ((q.GO, m.MODE_GO), (q.LAND, m.MODE_LAND),
                               (q.KILL, m.MODE_KILL)):
            q.mode = ros_mode
            assert rb.flightmode_from_ros(q).mode == wire
        q.mode = q.ESTOP
        assert rb.flightmode_from_ros(q).mode == 0

    def test_converters_encode_like_the_reference(self):
        """The port's converters fill the fake messages field for field as
        the reference's do."""
        from aclswarm_tpu.interop import messages as rm
        from aclswarm_tpu.interop import ros_bridge as ref_rb
        from aclswarm_tpu.interop.ros_fakes import FakeMsgs as RefMsgs
        fm = _wire_formation(gains="zeros")
        rfm = rm.Formation(header=rm.Header(seq=1, stamp=0.5,
                                            frame_id="world"),
                           name="sq", points=fm.points, adjmat=fm.adjmat,
                           gains=fm.gains)
        a = rb.formation_to_ros(fm, FakeMsgs)
        b = ref_rb.formation_to_ros(rfm, RefMsgs)
        assert a.adjmat.data == b.adjmat.data
        assert a.gains.data == b.gains.data
        assert [(p.x, p.y, p.z) for p in a.points] == \
            [(p.x, p.y, p.z) for p in b.points]
        assert a.header.seq == b.header.seq


class _SwarmSide:
    """The rest of the ROS graph, faked: per-vehicle localization
    publishers feeding `<veh>/vehicle_estimates`, and first-order
    vehicles consuming `<veh>/distcmd`."""

    def __init__(self, ros, vehs, q0, dt=0.01, tau=0.15, msgs=FakeMsgs,
                 bridge=rb, wire=m):
        self.ros, self.vehs, self.dt, self.tau = ros, vehs, dt, tau
        self.msgs, self.rb, self.m = msgs, bridge, wire
        self.q = np.asarray(q0, float).copy()
        self.vel = np.zeros_like(self.q)
        self.n = len(vehs)
        self.pub_est = [ros.Publisher(f"/{v}/vehicle_estimates",
                                      msgs.VehicleEstimates) for v in vehs]
        self.k = 0

    def publish_estimates(self):
        est = self.m.VehicleEstimates(
            header=self.m.Header(seq=self.k, stamp=self.k * self.dt),
            positions=self.q, stamps=np.full(self.n, self.k * self.dt))
        for pub in self.pub_est:
            pub.publish(self.rb.estimates_to_ros(est, self.msgs))

    def commands(self):
        out = np.zeros((self.n, 3))
        for v, veh in enumerate(self.vehs):
            pub = self.ros.pubs[f"/{veh}/distcmd"]
            if pub.published:
                c = pub.published[-1].vector
                out[v] = (c.x, c.y, c.z)
        return out

    def consume_distcmd(self, u=None):
        u = self.commands() if u is None else u
        self.vel += (self.dt / self.tau) * (u - self.vel)
        self.q += self.vel * self.dt
        self.k += 1
        return float(np.abs(u).max())


class TestLoopback:
    def test_formation_to_convergence_over_ros_graph(self):
        ros, node = _run(assign_every=50)
        fm = _wire_formation(gains="solve")
        rng = np.random.default_rng(4)
        q0 = np.asarray(fm.points)[rng.permutation(4)] \
            + rng.normal(scale=0.05, size=(4, 3)) + [3.0, 1.0, 0.0]
        swarm = _SwarmSide(ros, VEHS, q0)
        assert node.step() is None
        assert not ros.pubs["/SQ01s/distcmd"].published
        ros.Publisher("/formation", FakeMsgs.Formation).publish(
            rb.formation_to_ros(fm, FakeMsgs, stamp=Time(0.0)))
        for _ in range(1200):
            swarm.publish_estimates()
            node.step()
            swarm.consume_distcmd()
        asn = ros.pubs["/SQ03s/assignment"].published
        assert asn, "no assignment published"
        assert sorted(rb.assignment_from_ros(asn[0]).tolist()) \
            == list(range(4))
        last = ros.pubs["/SQ01s/distcmd"].published[-1].vector
        assert np.linalg.norm([last.x, last.y, last.z]) < 0.3
        from scipy.spatial.distance import pdist
        np.testing.assert_allclose(np.sort(pdist(swarm.q)),
                                   np.sort(pdist(np.asarray(fm.points))),
                                   atol=0.25)

    def test_kill_over_globalflightmode(self):
        ros, node = _run(assign_every=10)
        fm = _wire_formation(gains="zeros")
        swarm = _SwarmSide(ros, VEHS, np.asarray(fm.points) * 1.6)
        ros.Publisher("/formation", FakeMsgs.Formation).publish(
            rb.formation_to_ros(fm, FakeMsgs))
        swarm.publish_estimates()
        node.step()
        assert swarm.consume_distcmd() > 0.0
        kill = FakeMsgs.QuadFlightMode()
        kill.mode = FakeMsgs.QuadFlightMode.KILL
        ros.Publisher("/globalflightmode",
                      FakeMsgs.QuadFlightMode).publish(kill)
        swarm.publish_estimates()
        node.step()
        last = ros.pubs["/SQ02s/distcmd"].published[-1].vector
        assert last.x == last.y == last.z == 0.0

    def test_central_assignment_param_path(self):
        ros = FakeRospy(params={"/vehs": VEHS,
                                "/operator/central_assignment": True})
        ros, node = _run(ros=ros, assign_every=5)
        assert node.planner.central_assignment
        fm = _wire_formation(gains="zeros")
        rng = np.random.default_rng(9)
        swarm = _SwarmSide(ros, VEHS,
                           np.asarray(fm.points)[rng.permutation(4)])
        ros.Publisher("/formation", FakeMsgs.Formation).publish(
            rb.formation_to_ros(fm, FakeMsgs))
        pub_central = ros.Publisher("/central_assignment",
                                    FakeMsgs.UInt8MultiArray)
        for _ in range(8):
            swarm.publish_estimates()
            node.step()
            swarm.consume_distcmd()
        assert not ros.pubs["/SQ01s/assignment"].published
        pushed = np.array([1, 2, 3, 0], np.int32)
        pub_central.publish(rb.assignment_to_ros(pushed, FakeMsgs))
        got = None
        for _ in range(8):
            swarm.publish_estimates()
            got = node.step() or got
            swarm.consume_distcmd()
        assert got is not None
        np.testing.assert_array_equal(got.perm, pushed)
        np.testing.assert_array_equal(rb.assignment_from_ros(
            ros.pubs["/SQ04s/assignment"].published[-1]), pushed)

    def test_shm_backend_two_process_deployment(self):
        """fake ROS graph -> adapter node -> ShmPlannerClient -> shm rings
        -> the port's planner daemon subprocess -> back. The native library
        is built (under a file lock: test workers share the build
        directory) when the test runs, never at import, where another
        worker's build may still be writing it; the test skips only if the
        build fails."""
        if not nat.build_locked():
            pytest.skip("the shm rings need native/build/"
                        "libaclswarm_native.so (make -C native)")
        ns = f"/asw-torchros-{uuid.uuid4().hex[:8]}"
        n = 4
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        child = subprocess.Popen(
            [sys.executable, "-m", "aclswarm_torch.interop.bridge", "--n",
             str(n), "--ns", ns, "--assign-every", "5", "--device", "cpu",
             "--dtype", "float64", "--idle-timeout", "120"],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL)
        client = None
        try:
            client = rb.ShmPlannerClient(n, ns, connect_timeout_s=60)
            ros = FakeRospy(params={"/vehs": VEHS})
            node = rb.run(ros, FakeMsgs, planner=client)
            assert not node._use_est     # the shm wire carries (n, 3)
            fm = _wire_formation(gains="zeros")
            rng = np.random.default_rng(21)
            swarm = _SwarmSide(ros, VEHS,
                               np.asarray(fm.points)[rng.permutation(n)]
                               + [2.0, 1.0, 0.0])
            ros.Publisher("/formation", FakeMsgs.Formation).publish(
                rb.formation_to_ros(fm, FakeMsgs))
            deadline = time.time() + 120
            for _ in range(40):
                swarm.publish_estimates()
                node.step()
                swarm.consume_distcmd()
                if ros.pubs["/SQ01s/assignment"].published \
                        or time.time() > deadline:
                    break
            asn = ros.pubs["/SQ01s/assignment"].published
            assert asn, "no assignment through ROS -> shm -> daemon"
            assert sorted(rb.assignment_from_ros(asn[0]).tolist()) \
                == list(range(n))
            assert ros.pubs["/SQ02s/distcmd"].published
        finally:
            if client is not None:
                client.handle_formation(_wire_formation(
                    gains=None, name="__shutdown__"))
                client.close()
            child.terminate()
            try:
                child.wait(timeout=30)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait(timeout=30)

    def test_on_commit_gain_solve_over_ros(self):
        ros, node = _run(assign_every=10)
        fm = _wire_formation(gains=None)
        swarm = _SwarmSide(ros, VEHS, np.asarray(fm.points) + 0.3)
        ros.Publisher("/formation", FakeMsgs.Formation).publish(
            rb.formation_to_ros(fm, FakeMsgs))
        swarm.publish_estimates()
        assert node.step() is not None
        assert node.planner.formation is not None
        assert torch.any(node.planner.formation.gains != 0.0)


class TestRound5Additions:
    def test_wide_assignment_loopback_n300(self):
        n = 300
        vehs = [f"SQ{i:03d}s" for i in range(n)]
        ros, node = _run(vehs=vehs, assign_every=5,
                         assignment="sinkhorn", information_model="fused")
        assert node.wide_assignment
        rng = np.random.default_rng(7)
        pts = rng.uniform(-20, 20, size=(n, 3))
        adj = np.ones((n, n), np.uint8) - np.eye(n, dtype=np.uint8)
        fm = m.Formation(header=m.Header(), name="big", points=pts,
                         adjmat=adj,
                         gains=np.zeros((3 * n, 3 * n), np.float32))
        ros.Publisher("/formation", FakeMsgs.Formation).publish(
            rb.formation_to_ros(fm, FakeMsgs))
        ros_est = rb.estimates_to_ros(m.VehicleEstimates(
            header=m.Header(), positions=pts[rng.permutation(n)],
            stamps=np.zeros(n)), FakeMsgs)
        for v in range(n):
            ros.Publisher(f"/{vehs[v]}/vehicle_estimates",
                          FakeMsgs.VehicleEstimates).publish(ros_est)
        assert node.step() is not None
        asn = ros.pubs[f"/{vehs[0]}/assignment"].published
        assert asn and isinstance(asn[0], FakeMsgs.Int32MultiArray)
        perm = rb.assignment_from_ros(asn[0])
        assert sorted(perm.tolist()) == list(range(n))
        assert int(perm.max()) > 255

    def test_zero_cmd_precedes_commit_solve(self):
        ros, node = _run()
        seen_at_commit = {}
        orig = node.planner.handle_formation

        def spying_commit(fm):
            for v in VEHS:
                seen_at_commit[v] = list(ros.pubs[f"/{v}/distcmd"].published)
            return orig(fm)

        node.planner.handle_formation = spying_commit
        fm = _wire_formation(gains=None)
        est = m.VehicleEstimates(header=m.Header(),
                                 positions=np.asarray(fm.points) + 0.5,
                                 stamps=np.zeros(4))
        for v in VEHS:
            ros.Publisher(f"/{v}/vehicle_estimates",
                          FakeMsgs.VehicleEstimates).publish(
                rb.estimates_to_ros(est, FakeMsgs))
        ros.Publisher("/formation", FakeMsgs.Formation).publish(
            rb.formation_to_ros(fm, FakeMsgs))
        node.step()
        for v in VEHS:
            before = seen_at_commit[v]
            assert len(before) == 1
            vec = before[0].vector
            assert vec.x == vec.y == vec.z == 0.0
            assert len(ros.pubs[f"/{v}/distcmd"].published) >= 2

    def test_viz_marker_traffic(self):
        ros, node = _run(viz=True)
        room = ros.pubs["/operator/room_bounds"].published
        assert len(room) == 1 and len(room[0].markers) == 4
        assert all(mk.type == FakeMsgs.Marker.CUBE
                   for mk in room[0].markers)
        fm = _wire_formation(gains="zeros")
        ros.Publisher("/formation", FakeMsgs.Formation).publish(
            rb.formation_to_ros(fm, FakeMsgs))
        swarm = _SwarmSide(ros, VEHS, np.asarray(fm.points) * 1.5)
        for _ in range(2):
            swarm.publish_estimates()
            node.step()
            swarm.consume_distcmd()
        arr = ros.pubs["viz_dist_cmd"].published[-1]
        assert len(arr.markers) == 4
        assert arr.markers[0].type == FakeMsgs.Marker.ARROW
        assert arr.markers[1].header.frame_id == "SQ02s"
        assert len(arr.markers[0].points) == 2
        spheres = ros.pubs["viz_central_alignment"].published
        assert spheres and len(spheres[-1].markers) == 4
        assert spheres[-1].markers[0].type == FakeMsgs.Marker.SPHERE
        meshes = ros.pubs["viz_mesh"].published
        assert meshes[-1].markers[0].mesh_resource.endswith(
            "quadrotor.dae")

    def test_viz_markers_match_reference(self):
        """The port's markers land where the reference's do: arrows at
        0.5 u, spheres on the aligned formation, the room's walls."""
        from aclswarm_tpu.interop.ros_fakes import FakeMsgs as RefMsgs
        from aclswarm_tpu.interop.ros_fakes import FakeRospy as RefRospy
        from aclswarm_tpu.interop.viz_markers import VizMarkers as RefViz
        from aclswarm_torch.interop.viz_markers import VizMarkers
        rng = np.random.default_rng(3)
        q = rng.normal(size=(4, 3))
        u = rng.normal(size=(4, 3))
        pts = np.asarray(_wire_formation().points)
        v2f = np.array([2, 0, 3, 1])
        out = []
        for viz_cls, ros, msgs in ((VizMarkers, FakeRospy(), FakeMsgs),
                                   (RefViz, RefRospy(), RefMsgs)):
            viz = viz_cls(ros, msgs, VEHS)
            assert viz.tick(q, u, pts, v2f)
            viz.publish_room_bounds(-5.0, 5.0, -4.0, 4.0, 3.0)
            out.append({t: [[(p.x, p.y, p.z) for p in mk.points]
                            + [(mk.pose.position.x, mk.pose.position.y,
                                mk.pose.position.z)]
                            for mk in ros.pubs[t].published[-1].markers]
                        for t in ("viz_dist_cmd", "viz_central_alignment",
                                  "viz_mesh", "/operator/room_bounds")})
        for topic in out[0]:
            np.testing.assert_allclose(np.asarray(out[0][topic]),
                                       np.asarray(out[1][topic]),
                                       atol=1e-12, err_msg=topic)

    def test_perveh_information_model_consumes_own_tables(self):
        def run_once(information_model, bias):
            ros, node = _run(information_model=information_model)
            fm = _wire_formation(gains="solve")
            ros.Publisher("/formation", FakeMsgs.Formation).publish(
                rb.formation_to_ros(fm, FakeMsgs))
            q = np.asarray(fm.points) * 1.4
            for v, veh in enumerate(VEHS):
                table = q.copy()
                if v == 0 and bias:
                    table[1:] += np.array([0.8, -0.4, 0.0])
                ros.Publisher(f"/{veh}/vehicle_estimates",
                              FakeMsgs.VehicleEstimates).publish(
                    rb.estimates_to_ros(m.VehicleEstimates(
                        header=m.Header(), positions=table,
                        stamps=np.zeros(4)), FakeMsgs))
            node.step()
            out = {}
            for veh in VEHS:
                vec = ros.pubs[f"/{veh}/distcmd"].published[-1].vector
                out[veh] = np.array([vec.x, vec.y, vec.z])
            return out

        clean = run_once("perveh", bias=False)
        biased = run_once("perveh", bias=True)
        fused = run_once("fused", bias=True)
        assert not np.allclose(clean["SQ01s"], biased["SQ01s"])
        for v in ("SQ02s", "SQ03s", "SQ04s"):
            np.testing.assert_allclose(clean[v], biased[v], atol=1e-6)
        for v in VEHS:
            np.testing.assert_allclose(fused[v], clean[v], atol=1e-6)

    def test_cbaa_with_perveh_tables_over_ros(self):
        ros, node = _run(assignment="cbaa", assign_every=25)
        assert node._use_est
        fm = _wire_formation(gains="solve")
        rng = np.random.default_rng(13)
        q0 = np.asarray(fm.points)[rng.permutation(4)] \
            + rng.normal(scale=0.05, size=(4, 3)) + [2.0, -1.0, 0.0]
        swarm = _SwarmSide(ros, VEHS, q0)
        ros.Publisher("/formation", FakeMsgs.Formation).publish(
            rb.formation_to_ros(fm, FakeMsgs))
        got = None
        for _ in range(800):
            swarm.publish_estimates()
            got = node.step() or got
            swarm.consume_distcmd()
        assert got is not None, "no CBAA assignment published"
        assert sorted(got.perm.tolist()) == list(range(4))
        last = ros.pubs["/SQ01s/distcmd"].published[-1].vector
        assert np.linalg.norm([last.x, last.y, last.z]) < 0.3
        from scipy.spatial.distance import pdist
        np.testing.assert_allclose(np.sort(pdist(swarm.q)),
                                   np.sort(pdist(np.asarray(fm.points))),
                                   atol=0.25)

    def test_cbaa_auction_consumes_est_tables(self):
        from aclswarm_torch.interop.planner import TorchPlanner
        n = 4
        pts = np.array([[0.0, 0, 1], [4, 0, 1], [4, 4, 1], [0, 4, 1]])
        adj = np.ones((n, n)) - np.eye(n)
        planner = TorchPlanner(n, assignment="cbaa", assign_every=1, **CPU)
        planner.handle_formation(m.Formation(
            header=m.Header(), name="sq", points=pts, adjmat=adj,
            gains=np.zeros((3 * n, 3 * n), np.float32)))
        q = np.array([[0.2, 0.2, 1.0], [0.9, 0.9, 1.0],
                      [4.0, 4.0, 1.0], [0.0, 4.0, 1.0]])
        truth_tbl = np.broadcast_to(q, (n, n, 3)).copy()
        out_truth = planner.tick(q, est=truth_tbl)
        planner.v2f = np.arange(n)
        planner._ticks_since_commit = 0
        planner._await_first_accept = True
        est = truth_tbl.copy()
        est[0, 1:] = est[0, 1:] * 10.0
        out_biased = planner.tick(q, est=est)
        np.testing.assert_array_equal(out_truth.assignment, [0, 1, 2, 3])
        np.testing.assert_array_equal(out_biased.assignment, [1, 0, 2, 3])


@pytest.mark.parametrize("information_model,assignment",
                         [("perveh", "cbaa"), ("fused", "sinkhorn")])
def test_node_matches_reference_node(information_model, assignment):
    """`TorchCoordinationNode` against the reference's
    `TpuCoordinationNode` on the same fake graph: the same formation
    dispatch (designed on commit), the same estimate tables every tick
    (integrated from the reference node's commands): every published
    assignment equal, every distcmd within 1e-9 + 1e-9 |ref|."""
    from aclswarm_tpu.interop import messages as rm
    from aclswarm_tpu.interop import ros_bridge as ref_rb
    from aclswarm_tpu.interop.ros_fakes import FakeMsgs as RefMsgs
    from aclswarm_tpu.interop.ros_fakes import FakeRospy as RefRospy

    kw = dict(assignment=assignment, assign_every=20,
              information_model=information_model)
    ros, node = _run(**kw)
    ref_ros = RefRospy(params={"/vehs": VEHS})
    ref_node = ref_rb.run(ref_ros, RefMsgs, **kw)
    assert ref_ros.node_name == "coordination_tpu"
    fm = _wire_formation(gains=None)
    rfm = rm.Formation(header=rm.Header(seq=1, stamp=0.5, frame_id="world"),
                       name="sq", points=fm.points, adjmat=fm.adjmat)
    ros.Publisher("/formation", FakeMsgs.Formation).publish(
        rb.formation_to_ros(fm, FakeMsgs))
    ref_ros.Publisher("/formation", RefMsgs.Formation).publish(
        ref_rb.formation_to_ros(rfm, RefMsgs))
    rng = np.random.default_rng(13)
    q0 = np.asarray(fm.points)[rng.permutation(4)] \
        + rng.normal(scale=0.05, size=(4, 3)) + [2.0, -1.0, 0.0]
    swarm = _SwarmSide(ros, VEHS, q0)
    ref_swarm = _SwarmSide(ref_ros, VEHS, q0, msgs=RefMsgs, bridge=ref_rb,
                           wire=rm)
    published = 0
    for k in range(60):
        swarm.publish_estimates()
        ref_swarm.publish_estimates()
        got, want = node.step(), ref_node.step()
        assert (got is None) == (want is None), k
        if want is not None:
            published += 1
            np.testing.assert_array_equal(got.perm, want.perm)
        u, ref_u = swarm.commands(), ref_swarm.commands()
        np.testing.assert_allclose(u, ref_u, rtol=1e-9, atol=1e-9)
        swarm.consume_distcmd(ref_u)
        ref_swarm.consume_distcmd(ref_u)
    assert published >= 1


# -- the reference's tests/test_registry.py -----------------------------------

class TestRegistry:
    def test_mixed_fleet_names(self):
        from aclswarm_torch.core.registry import make_registry
        r = make_registry(["SQ01s", "HX04", "SQ03s"])
        assert r.n == 3 and r.index("HX04") == 1 and r.name(2) == "SQ03s"
        assert list(r) == ["SQ01s", "HX04", "SQ03s"]

    def test_unknown_name_is_error(self):
        from aclswarm_torch.core.registry import make_registry
        with pytest.raises(KeyError):
            make_registry(["SQ01s"]).index("HX99")

    def test_duplicate_names_rejected(self):
        from aclswarm_torch.core.registry import make_registry
        with pytest.raises(ValueError):
            make_registry(["SQ01s", "SQ01s"])

    def test_int_builds_sil_convention(self):
        from aclswarm_torch.core.registry import make_registry
        assert list(make_registry(3)) == ["SQ01s", "SQ02s", "SQ03s"]

    def test_shipped_registry_loads_like_the_reference(self):
        from aclswarm_torch.core.registry import (DEFAULT_REGISTRY,
                                                  load_registry)
        from aclswarm_tpu.core import registry as ref_registry
        assert DEFAULT_REGISTRY.exists()
        assert DEFAULT_REGISTRY.read_bytes() \
            == ref_registry.DEFAULT_REGISTRY.read_bytes()
        assert load_registry().names == ref_registry.load_registry().names
        r = load_registry()
        assert r.n >= 1 and r.index(r.name(0)) == 0

    def test_ros_adapter_uses_registry(self):
        from aclswarm_torch.core.registry import VehicleRegistry
        ros, node = _run(vehs=["SQ01s", "HX04"])
        assert isinstance(node.registry, VehicleRegistry)
        assert node.registry.index("HX04") == 1
        assert "/HX04/distcmd" in ros.pubs
