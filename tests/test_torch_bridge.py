"""The port's planner daemon (`python -m aclswarm_torch.interop.bridge`) as
a subprocess on the CPU, driven over the shm rings by the port's operator
and a vehicle loop in this process — the cases of
`tests/test_interop.py::{TestBridgeLifecycle, TestCentralAssignmentWire,
TestBridgeEndToEnd}` — and one case more: the daemon's distcmd over the
wire equals an in-process `TorchPlanner`'s on the same decoded messages,
bit for bit.

The daemon runs ``--device cpu --dtype float64`` with one intra-op thread
(the parent's count: the CPU's BLAS rounds otherwise across thread
counts, and the bit-for-bit case needs the same arithmetic on both
sides). The shm rings need the native library (``make -C native``); the
cases skip without it.
"""
import contextlib
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from aclswarm_torch.interop import codec
from aclswarm_torch.interop import messages as m
from aclswarm_torch.interop import native as nat

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def native():
    """Build the native library once (under a file lock: test workers
    share the build directory) or skip. Decided when a test runs, never
    at import: there another worker's build may still be writing the
    library, and the cases would skip in that worker alone."""
    if not nat.build_locked():
        pytest.skip("the shm rings need native/build/libaclswarm_native.so "
                    "(make -C native)")


def _load_factor() -> float:
    """Deadline multiplier under a loaded host (as the reference's
    tests): the 1-min load average per core, capped at 4."""
    try:
        return min(4.0, max(1.0, os.getloadavg()[0] / os.cpu_count()))
    except OSError:
        return 1.0


@contextlib.contextmanager
def _bridge(n, *args, rings=("formation", "flightmode", "estimates",
                             "central-assignment", "distcmd",
                             "assignment", "safety")):
    """A daemon on a fresh namespace; yields (process, rings, ns) and
    always stops the process and closes the rings."""
    from aclswarm_torch.interop.transport import Channel

    ns = f"/asw-torchbridge-{uuid.uuid4().hex[:8]}"
    lf = _load_factor()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    child = subprocess.Popen(
        [sys.executable, "-m", "aclswarm_torch.interop.bridge", "--n",
         str(n), "--ns", ns, "--device", "cpu", "--dtype", "float64",
         "--idle-timeout", str(120 * lf), *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    chans = {}
    try:
        deadline = time.time() + 60 * lf
        for name in rings:
            while True:
                try:
                    chans[name] = Channel(f"{ns}-{name}")
                    break
                except OSError:
                    if time.time() > deadline or child.poll() is not None:
                        raise
                    time.sleep(0.05)
        yield child, chans, ns
    finally:
        child.terminate()
        try:
            child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=30)
        for ch in chans.values():
            ch.close()


def _distcmd(chans, k):
    t0 = time.time()
    while time.time() - t0 < 60 * _load_factor():
        if (cmd := chans["distcmd"].recv()) is not None:
            return cmd
        time.sleep(0.0005)
    raise AssertionError(f"no distcmd at tick {k}")


def _shutdown(chans, fmsg):
    chans["formation"].send(m.Formation(
        header=m.Header(), name="__shutdown__",
        points=np.asarray(fmsg.points), adjmat=np.asarray(fmsg.adjmat)))


def test_wire_equals_in_process_planner():
    """The daemon's outputs over the wire — distcmd, flags, published
    assignments, every tick, through a dispatch without gains, a KILL and
    a GO — equal an in-process `TorchPlanner` fed the same decoded
    messages, bit for bit; the daemon reports its ticks and counts."""
    import json

    from aclswarm_torch.interop.operator import Operator
    from aclswarm_torch.interop.planner import TorchPlanner

    n, ticks = 4, 160
    with _bridge(n, "--assign-every", "50", "--assignment", "sinkhorn") \
            as (child, chans, _):
        sent = []

        def send(name, msg):
            raw = codec.encode(msg)
            assert chans[name].send_bytes(raw)
            sent.append((name, codec.decode(raw)))

        op = Operator("swarm4", send_gains=False)
        fmsg = op.dispatch(lambda msg: send("formation", msg))
        rng = np.random.default_rng(11)
        q = rng.normal(size=(n, 3)) * 2.0
        q[:, 2] = 1.0
        vel = np.zeros((n, 3))
        got = []
        for k in range(ticks):
            if k in (70, 90):
                send("flightmode", m.FlightMode(
                    header=m.Header(),
                    mode=m.MODE_KILL if k == 70 else m.MODE_GO))
            send("estimates", m.VehicleEstimates(
                header=m.Header(seq=k, stamp=k * 0.01), positions=q,
                stamps=np.full(n, k * 0.01)))
            cmd = _distcmd(chans, k)
            asn, safe = chans["assignment"].recv(), chans["safety"].recv()
            got.append((cmd.vel, safe.active.astype(bool),
                        None if asn is None else asn.perm))
            vel += (0.01 / 0.15) * (cmd.vel - vel)
            q = q + vel * 0.01
        _shutdown(chans, fmsg)
        out = child.communicate(timeout=60)[0]

    planner = TorchPlanner(n, assignment="sinkhorn", assign_every=50,
                           device="cpu", dtype="float64")
    local = []
    for name, msg in sent:
        if name == "formation":
            planner.handle_formation(msg)
        elif name == "flightmode":
            planner.handle_flightmode(msg)
        else:
            local.append(planner.tick(msg))
    for k, ((vel_w, safe_w, asn_w), o) in enumerate(zip(got, local)):
        np.testing.assert_array_equal(vel_w, o.distcmd, err_msg=str(k))
        np.testing.assert_array_equal(safe_w, o.safety)
        assert (asn_w is None) == (o.assignment is None), k
        if asn_w is not None:
            np.testing.assert_array_equal(asn_w, o.assignment)
    assert all(np.all(v == 0) for v, _, _ in got[70:90])
    assert any(np.any(v != 0) for v, _, _ in got[90:])
    assert f"bridge served {ticks} ticks" in out
    report = json.loads(next(ln for ln in out.splitlines()
                             if ln.startswith('{"bridge"')))["bridge"]
    assert report["ticks"] == ticks
    assert report["launches"] == {"sinkhorn_log": 0, "round_dominant": 0,
                                  "flood_merge": 0}      # plain on the CPU
    assert report["channels"]["estimates"]["frames"] == ticks
    assert report["channels"]["distcmd"]["frames"] == ticks
    assert report["channels"]["flightmode"]["frames"] == 2
    assert len(report["commit_ms"]) == 1


def test_takeoff_fly_land_kill_over_wire():
    """The flight lifecycle wire-only (`TestBridgeLifecycle`): the
    operator broadcasts GO/LAND/KILL and dispatches a formation, the
    daemon owns the planner, this process flies the vehicles' flight FSM
    and safe trajectory from decoded wire traffic: the flight-mode ring
    exists, `SafetyStatusArray` streams per tick, and KILL cuts distcmd
    to zero on the very next tick."""
    from aclswarm_torch.control import safety as safetylib
    from aclswarm_torch.core.types import SafetyParams
    from aclswarm_torch.interop.operator import Operator
    from aclswarm_torch.interop.transport import Channel
    from aclswarm_torch.sim import vehicle as veh

    n, dt = 4, 0.01
    dev, f64 = torch.device("cpu"), torch.float64
    with _bridge(n, "--assign-every", "50") as (_, chans, ns):
        veh_mode = Channel(f"{ns}-flightmode-veh", create=True)
        chans["flightmode-veh"] = veh_mode
        sparams = SafetyParams(
            bounds_min=(-50.0, -50.0, 0.0), bounds_max=(50.0, 50.0, 30.0),
            spinup_time=0.1, takeoff_inc=0.02, landing_fast_dec=0.02,
            landing_slow_dec=0.01)
        rng = np.random.default_rng(7)
        q0 = np.zeros((n, 3))
        q0[:, :2] = rng.normal(size=(n, 2)) * 2.0
        st = {"q": torch.as_tensor(q0),
              "fs": veh.init_flight(n, dev, f64, flying=False),
              "tick": 0}
        st["goal"] = safetylib.TrajGoal.hover_at(st["q"], device=dev,
                                                 dtype=f64)

        def vehicle_tick():
            cmd = veh.CMD_NONE
            while isinstance(fm := veh_mode.recv(), m.FlightMode):
                cmd = int(fm.mode)       # MODE_* == CMD_* by construction
            st["fs"] = veh.apply_command(
                st["fs"], torch.tensor(cmd, dtype=torch.int32))
            k = st["tick"]
            assert chans["estimates"].send(m.VehicleEstimates(
                header=m.Header(seq=k, stamp=k * dt),
                positions=st["q"].numpy(), stamps=np.full(n, k * dt)))
            cmdmsg = _distcmd(chans, k)
            safe = chans["safety"].recv()
            flying = (st["fs"].mode == veh.FLYING)[:, None]
            u = torch.where(flying, torch.as_tensor(cmdmsg.vel),
                            torch.zeros((), dtype=f64))
            u = safetylib.saturate_velocity(u, sparams)
            sg = safetylib.make_safe_traj(dt, u, torch.zeros(n, dtype=f64),
                                          st["goal"], sparams)
            st["fs"], st["goal"] = veh.flight_step(st["fs"], st["goal"], sg,
                                                   st["q"], sparams, dt)
            st["q"] = st["goal"].pos
            st["tick"] += 1
            return cmdmsg, safe

        def all_in(mode):
            return bool(torch.all(st["fs"].mode == mode))

        op = Operator("swarm4")
        # phase 1: START on the ground => GO broadcast, takeoff
        assert op.start(veh_mode.send) is None and op.flying
        assert chans["flightmode"].send(
            m.FlightMode(header=m.Header(), mode=m.MODE_GO))
        for _ in range(1500):
            cmdmsg, _ = vehicle_tick()
            assert np.all(cmdmsg.vel == 0)    # no formation committed
            if all_in(veh.FLYING):
                break
        assert all_in(veh.FLYING)
        np.testing.assert_allclose(st["q"].numpy()[:, 2], 1.0, atol=0.11)
        # phase 2: START in flight => formation dispatch, fly
        fmsg = op.start(veh_mode.send, chans["formation"].send)
        assert isinstance(fmsg, m.Formation)
        got_asn = got_safety = False
        moved = 0.0
        for _ in range(300):
            cmdmsg, safe = vehicle_tick()
            got_asn |= chans["assignment"].recv() is not None
            if safe is not None:
                got_safety = True
                assert safe.active.shape == (n,)
            moved = max(moved, float(np.abs(cmdmsg.vel).max()))
        assert got_asn and got_safety and moved > 0
        # phase 3: END => LAND broadcast, descend to the ground
        op.end(veh_mode.send)
        assert not op.flying
        for _ in range(2000):
            vehicle_tick()
            if all_in(veh.NOT_FLYING):
                break
        assert all_in(veh.NOT_FLYING)
        assert float(st["q"][:, 2].max()) < 0.05
        # phase 4: GO again, then KILL mid-flight
        assert op.start(veh_mode.send) is None
        chans["flightmode"].send(m.FlightMode(header=m.Header(),
                                              mode=m.MODE_GO))
        for _ in range(1500):
            vehicle_tick()
            if all_in(veh.FLYING):
                break
        vehicle_tick()
        op.kill(veh_mode.send)
        chans["flightmode"].send(m.FlightMode(header=m.Header(),
                                              mode=m.MODE_KILL))
        cmdmsg, _ = vehicle_tick()
        assert np.all(cmdmsg.vel == 0.0), cmdmsg.vel
        assert all_in(veh.NOT_FLYING)
        _shutdown(chans, fmsg)


def test_operator_pushed_assignment_over_wire():
    """`TestCentralAssignmentWire`: a daemon in --central-assignment mode
    adopts the operator's Hungarian permutation from the
    <ns>-central-assignment ring instead of auctioning, and a later push
    interrupts the held assignment at the next cadence."""
    from aclswarm_torch.interop.operator import Operator

    n = 4
    with _bridge(n, "--assign-every", "5", "--central-assignment") \
            as (_, chans, _ns):
        op = Operator("swarm4")
        fmsg = op.next_formation()
        fmsg.gains = np.zeros((3 * n, 3 * n), np.float32)
        assert chans["formation"].send(fmsg)
        rng = np.random.default_rng(11)
        q = np.asarray(fmsg.points)[rng.permutation(n)] \
            + rng.normal(scale=0.05, size=(n, 3))

        def tick(k):
            assert chans["estimates"].send(m.VehicleEstimates(
                header=m.Header(seq=k, stamp=k * 0.01), positions=q,
                stamps=np.full(n, k * 0.01)))
            return _distcmd(chans, k)

        def adopted(ks):
            for k in ks:
                tick(k)
                if (msg := chans["assignment"].recv()) is not None:
                    return msg
            return None

        for k in range(6):
            tick(k)
        assert chans["assignment"].recv() is None
        push1 = op.central_assignment(q, stamp=0.06)
        assert chans["central-assignment"].send(push1)
        got = adopted(range(6, 20))
        assert got is not None, "central assignment never adopted"
        np.testing.assert_array_equal(got.perm, push1.perm)
        push2 = m.Assignment(header=m.Header(seq=99),
                             perm=np.roll(push1.perm, 1).astype(np.int32))
        assert chans["central-assignment"].send(push2)
        got = adopted(range(20, 40))
        assert got is not None
        np.testing.assert_array_equal(got.perm, push2.perm)
        _shutdown(chans, fmsg)


def test_operator_bridge_vehicle_loop():
    """`TestBridgeEndToEnd`: an operator dispatches a formation with its
    library gains, the daemon owns the planner, this process plays the
    vehicles (first-order velocity tracking) until the swarm converges;
    the daemon exits after --ticks estimate messages."""
    from aclswarm_torch.interop.operator import Operator

    n, ticks = 4, 600
    with _bridge(n, "--ticks", str(ticks), "--assign-every", "50",
                 rings=("formation", "estimates", "distcmd",
                        "assignment")) as (child, chans, _):
        op = Operator("swarm4")
        op.dispatch(chans["formation"].send)
        rng = np.random.default_rng(11)
        q = rng.normal(size=(n, 3)) * 2.0
        q[:, 2] = 1.0
        vel = np.zeros((n, 3))
        got_assignment = False
        for k in range(ticks):
            assert chans["estimates"].send(m.VehicleEstimates(
                header=m.Header(seq=k, stamp=k * 0.01), positions=q,
                stamps=np.full(n, k * 0.01)))
            cmd = _distcmd(chans, k)
            asn = chans["assignment"].recv()
            if asn is not None:
                got_assignment = True
                assert sorted(asn.perm.tolist()) == list(range(n))
            vel += (0.01 / 0.15) * (cmd.vel - vel)
            q = q + vel * 0.01
        assert got_assignment
        assert np.linalg.norm(cmd.vel, axis=1).mean() < 0.5
        assert f"bridge served {ticks} ticks" in child.communicate(
            timeout=60)[0]
