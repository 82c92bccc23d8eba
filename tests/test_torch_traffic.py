"""The open-loop traffic fleet on the port (`aclswarm_torch.serve.
traffic`): the cases of `tests/test_traffic.py` over the port's wire
front end and service (on the CPU in float64).

The replayability contract (a schedule is a pure function of its config,
and equal to the reference's), the heavy-tailed mixed shape of what it
generates, and small end-to-end fleet runs over the TCP front end whose
client ledger must reconcile to the last arrival.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from aclswarm_torch.serve import ServiceConfig, SwarmService
from aclswarm_torch.serve.traffic import (Arrival, TrafficConfig,
                                          TrafficFleet, build_schedule)
from aclswarm_tpu.serve import traffic as ref_traffic

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

pytestmark = [pytest.mark.serve]


def _cfg(**kw) -> ServiceConfig:
    return ServiceConfig(device="cpu", dtype="float64", **kw)


class TestSchedule:
    def test_replayable_and_seed_sensitive(self):
        cfg = TrafficConfig(seed=11, duration_s=4.0, offered_hz=60.0)
        a, b = build_schedule(cfg), build_schedule(cfg)
        assert a == b and len(a) > 50
        # the reference's schedule, element for element (its scenario
        # families and the port's are one registry)
        assert [vars(x) for x in a] == [
            vars(x) for x in ref_traffic.build_schedule(
                ref_traffic.TrafficConfig(seed=11, duration_s=4.0,
                                          offered_hz=60.0))]
        c = build_schedule(TrafficConfig(seed=12, duration_s=4.0,
                                         offered_hz=60.0))
        assert c != a

    def test_mixes_deadlines_and_heavy_tail(self):
        cfg = TrafficConfig(seed=3, duration_s=30.0, offered_hz=40.0,
                            deadline_frac=0.3)
        sched = build_schedule(cfg)
        assert all(isinstance(s, Arrival) for s in sched)
        # every configured tenant and kind appears
        assert {s.tenant for s in sched} == set(cfg.tenants)
        kinds = {s.kind for s in sched}
        assert kinds == {"rollout", "assign", "scenario"}
        # scenario draws come from the registry's serve-compatible
        # (truth-localization) families only
        from aclswarm_torch.scenarios.registry import FAMILIES
        fams = {s.params["family"] for s in sched
                if s.kind == "scenario"}
        assert fams and all(
            FAMILIES[f].localization == "truth" for f in fams)
        # deadlines: roughly the configured fraction, inside the range
        dl = [s.deadline_s for s in sched if s.deadline_s is not None]
        assert 0.1 < len(dl) / len(sched) < 0.6
        lo, hi = cfg.deadline_range_s
        assert all(lo <= d <= hi for d in dl)
        # heavy tail: the mean gap honors the offered rate while the
        # max gap dwarfs the median (a metronome would fail this)
        t = np.asarray([s.t for s in sched])
        gaps = np.diff(t)
        assert abs(len(sched) / cfg.duration_s
                   - cfg.offered_hz) / cfg.offered_hz < 0.35
        assert gaps.max() > 4 * np.median(gaps)

    def test_request_ids_unique_and_seeded(self):
        cfg = TrafficConfig(seed=5, duration_s=3.0, offered_hz=50.0)
        sched = build_schedule(cfg)
        rids = [s.request_id for s in sched]
        assert len(set(rids)) == len(rids)
        assert all(r.startswith("s5-") for r in rids)


class TestFleetEndToEnd:
    def test_small_fleet_ledger_reconciles(self):
        """A polite mini-fleet over TCP: every arrival reaches a
        terminal outcome (nothing unresolved), accepted == completed,
        and the report's ledger adds up to the offered count — the
        tier-1 miniature of the overload artifact's reconcile."""
        from aclswarm_torch.serve.wire import WireServer

        svc = SwarmService(_cfg(max_batch=4, quantum_chunks=4,
                                max_queue_per_tenant=16,
                                max_queue_total=48, idle_poll_s=0.01))
        srv = WireServer(svc, base=None, tcp=("127.0.0.1", 0),
                         client_lease_s=15.0)
        host, port = srv.tcp_address
        cfg = TrafficConfig(seed=9, duration_s=1.5, offered_hz=8.0,
                            slowloris_clients=0, corrupt_clients=0,
                            reconnect_storms=0, deadline_frac=0.0,
                            drain_timeout_s=240.0)
        rep = TrafficFleet(cfg, host, port).run()
        srv.close()
        svc.close()
        assert rep["unresolved"] == 0 and rep["wire_lost"] == 0
        total = (rep["completed"] + rep["timed_out"] + rep["cancelled"]
                 + rep["rejected_final"] + rep["failed_other"])
        assert total == rep["offered"] == rep["submitted"]
        assert rep["completed"] >= 1
        assert svc.stats["completed"] == rep["completed"]

    def test_adversaries_do_not_break_honest_traffic(self):
        """Slow-loris + corrupt-frame clients riding along: the honest
        arrivals still all terminate, the corrupt frames are all
        CRC-rejected (none applied), and the loris is dropped at the
        read deadline."""
        from aclswarm_torch.serve.wire import WireServer

        svc = SwarmService(_cfg(max_batch=4, quantum_chunks=4,
                                max_queue_per_tenant=16,
                                max_queue_total=48, idle_poll_s=0.01))
        srv = WireServer(svc, base=None, tcp=("127.0.0.1", 0),
                         client_lease_s=15.0, read_deadline_s=0.5)
        host, port = srv.tcp_address
        cfg = TrafficConfig(seed=10, duration_s=1.5, offered_hz=6.0,
                            slowloris_clients=1, corrupt_clients=1,
                            corrupt_hz=10.0, reconnect_storms=0,
                            deadline_frac=0.0, drain_timeout_s=240.0)
        rep = TrafficFleet(cfg, host, port).run()
        srv.close()
        svc.close(drain=False)
        assert rep["unresolved"] == 0
        assert rep["completed"] + rep["rejected_final"] \
            + rep["cancelled"] + rep["timed_out"] == rep["offered"]
        # every corrupt frame the server read was rejected, none
        # accepted (the fleet tenant names would show up in stats)
        crc = svc.telemetry.counter("wire_crc_rejected_total").value
        assert crc >= 1
        assert svc.telemetry.counter(
            "wire_slowloris_dropped_total").value >= 1
        # the schedule's arrivals are the only accepted work
        assert svc.stats["accepted"] \
            == rep["completed"] + rep["timed_out"] + rep["cancelled"]
