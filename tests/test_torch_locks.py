"""The port's order-checked locks (`aclswarm_torch.utils.locks`) against the
reference's (`aclswarm_tpu.utils.locks`): every behaviour that
`tests/test_locks.py` checks, replayed on both packages' locks with the
same sequence of acquires, must end alike — the same `LockOrderViolation`
kind, family, rank and held set, or the same silence. That covers rank
enforcement, same-family nesting, the rank registry, the two-thread
inversion caught through the first-seen nesting graph, the cross-thread
held-set report, re-entrancy, the hold/wait histograms and the disarmed
fast path."""
import threading

import pytest
import torch

from aclswarm_torch.telemetry import MetricsRegistry as PortRegistry
from aclswarm_torch.utils import locks as port
from aclswarm_tpu.telemetry import MetricsRegistry as RefRegistry
from aclswarm_tpu.utils import locks as ref

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

MODULES = {"reference": ref, "port": port}
REGISTRIES = {"reference": RefRegistry, "port": PortRegistry}


@pytest.fixture(autouse=True)
def armed_detectors():
    """Both detectors armed with a clean nesting graph (process-global on
    purpose: tests must not inherit each other's history)."""
    saved = {}
    for name, mod in MODULES.items():
        mod.arm()
        with mod._EDGES_GUARD:
            saved[name] = {k: set(v) for k, v in mod._EDGES.items()}
            mod._EDGES.clear()
    try:
        yield
    finally:
        for name, mod in MODULES.items():
            with mod._EDGES_GUARD:
                mod._EDGES.clear()
                mod._EDGES.update(saved[name])
            mod.disarm()


def _violation(fn):
    """What a scenario ended in: None, or the violation's fields."""
    try:
        fn()
    except Exception as e:      # noqa: BLE001 — compared across packages
        if type(e).__name__ != "LockOrderViolation":
            return (type(e).__name__,)
        return (e.kind, e.family, e.rank, tuple(e.held))
    return None


def _both(scenario):
    """Run one scenario on each package; both outcomes, which must agree."""
    got = {name: scenario(mod) for name, mod in MODULES.items()}
    assert got["port"] == got["reference"], got
    return got["port"]


# ---------------------------------------------------------------- scenarios

def _increasing(mod):
    a = mod.OrderedLock("serve.service")        # rank 20
    b = mod.OrderedLock("telemetry.registry")   # rank 80
    with a:
        with b:
            held = mod.held_families()
    return held, mod.held_families()


def _inversion(mod):
    a = mod.OrderedLock("serve.service")
    b = mod.OrderedLock("telemetry.registry")

    def run():
        with b:
            a.acquire()
    out = _violation(run)
    return out, a.locked()


def _same_family(mod):
    m1 = mod.OrderedLock("telemetry.metric")
    m2 = mod.OrderedLock("telemetry.metric")

    def run():
        with m1:
            m2.acquire()
    return _violation(run)


def _registry(mod):
    mod.register_rank("test.family.x", 33)
    mod.register_rank("test.family.x", 33)      # idempotent re-pin
    return (_violation(lambda: mod.register_rank("test.family.x", 44)),
            mod.rank_of("test.family.x"), mod.rank_of("test.nothing"))


def _unranked(mod):
    a = mod.OrderedLock("test.unranked.a")
    b = mod.OrderedLock("test.unranked.b")

    def run():
        with a:
            with b:
                pass            # first nesting: records the edge only
    return _violation(run), a.rank, b.rank


def _two_thread_cycle(mod):
    """Thread 1 nests A->B; thread 2 then tries B->A: refused at the inner
    acquire, though no rank was declared and the threads never collide."""
    a = mod.OrderedLock("test.cyc.a")
    b = mod.OrderedLock("test.cyc.b")
    t1_done = threading.Event()
    caught: list = []

    def t1():
        with a:
            with b:
                pass
        t1_done.set()

    def t2():
        t1_done.wait(5.0)

        def run():
            with b:
                with a:
                    pass
        caught.append(_violation(run))

    th1 = threading.Thread(target=t1)
    th2 = threading.Thread(target=t2)
    th1.start()
    th1.join(5.0)
    th2.start()
    th2.join(5.0)
    return caught


def _peers(mod):
    a = mod.OrderedLock("serve.service")
    b = mod.OrderedLock("telemetry.registry")
    peer_in, release = threading.Event(), threading.Event()

    def peer():
        with a:
            peer_in.set()
            release.wait(5.0)

    th = threading.Thread(target=peer, name="peer-thread")
    th.start()
    assert peer_in.wait(5.0)
    try:
        with b:
            with pytest.raises(mod.LockOrderViolation) as ei:
                mod.OrderedLock("serve.service").acquire()
        v = ei.value
        return (v.kind, sorted(fams for fams in v.peers.values()),
                any(name.startswith("peer-thread(") for name in v.peers))
    finally:
        release.set()
        th.join(5.0)


def _rlock(mod):
    r = mod.OrderedRLock("serve.service")
    with r:
        with r:                 # legal re-entry
            inner = mod.held_families()
        mid = r.locked()
    return inner, mid, r.locked()


def _self_deadlock(mod):
    lk = mod.OrderedLock("serve.service")

    def run():
        with lk:
            lk.acquire()
    return _violation(run)


def _rlock_release_order(mod):
    r = mod.OrderedRLock("serve.pool")
    inner = mod.OrderedLock("telemetry.metric")
    with r:
        r.acquire()
        r.release()
        with inner:             # rank 90 > 40: still legal
            pass
        mid = mod.held_families()
    return mid, mod.held_families()


def _disarmed(mod):
    mod.disarm()
    a = mod.OrderedLock("serve.service")
    b = mod.OrderedLock("telemetry.registry")

    def run():
        with b:
            with a:             # inverted, but not checked
                pass
    return _violation(run)


SCENARIOS = {
    "increasing_order_legal": (_increasing, (
        ("serve.service", "telemetry.registry"), ())),
    "inversion_raises_structured": (_inversion, (
        ("rank", "serve.service", 20, ("telemetry.registry",)), False)),
    "same_family_nesting_raises": (_same_family, (
        "rank", "telemetry.metric", 90, ("telemetry.metric",))),
    "rank_registry": (_registry, (("ValueError",), 33, None)),
    "unranked_families_skip_rank_test": (_unranked, (None, None, None)),
    "two_thread_deliberate_inversion": (_two_thread_cycle, [
        ("cycle", "test.cyc.a", None, ("test.cyc.b",))]),
    "peer_held_sets_in_report": (_peers, (
        "rank", [("serve.service",)], True)),
    "rlock_reenters": (_rlock, (("serve.service",), True, False)),
    "plain_lock_self_deadlock": (_self_deadlock, (
        "self", "serve.service", 20, ("serve.service",))),
    "rlock_release_order": (_rlock_release_order, (("serve.pool",), ())),
    "disarmed_inversion_not_checked": (_disarmed, None),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_same_outcome_as_reference(name):
    scenario, expected = SCENARIOS[name]
    assert _both(scenario) == expected


def test_ranks_equal_the_reference():
    assert port.DEFAULT_RANKS == ref.DEFAULT_RANKS


def _histograms(name):
    mod, reg = MODULES[name], REGISTRIES[name]()
    lk = mod.OrderedLock("test.metrics", registry=reg)
    with lk:
        pass
    with lk:
        pass
    r = mod.OrderedRLock("test.rehold", registry=reg)
    with r:
        with r:
            pass
    snap = reg.snapshot()["metrics"]
    return {k: snap[k]["count"] for k in (
        "lock_hold_s{name=test.metrics}", "lock_wait_s{name=test.metrics}",
        "lock_hold_s{name=test.rehold}", "lock_wait_s{name=test.rehold}")}


def test_histogram_contract():
    """One wait and one hold observation per outermost acquire/release,
    in both packages' registries."""
    assert _histograms("port") == _histograms("reference") == {
        "lock_hold_s{name=test.metrics}": 2,
        "lock_wait_s{name=test.metrics}": 2,
        "lock_hold_s{name=test.rehold}": 1,
        "lock_wait_s{name=test.rehold}": 2}


def test_wait_measures_contention():
    reg = PortRegistry()
    lk = port.OrderedLock("test.contend", registry=reg)
    entered, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            entered.set()
            release.wait(5.0)

    th = threading.Thread(target=holder)
    th.start()
    assert entered.wait(5.0)
    t = threading.Timer(0.05, release.set)
    t.start()
    with lk:                    # blocks ~50 ms behind the holder
        pass
    th.join(5.0)
    row = reg.snapshot()["metrics"]["lock_wait_s{name=test.contend}"]
    assert row["count"] == 2 and row["max"] >= 0.03


@pytest.mark.parametrize("value,armed", [("1", True), ("0", False),
                                         (None, False)])
def test_env_arming(monkeypatch, value, armed):
    if value is None:
        monkeypatch.delenv("ACLSWARM_LOCK_DEBUG", raising=False)
    else:
        monkeypatch.setenv("ACLSWARM_LOCK_DEBUG", value)
    assert port._env_armed() is ref._env_armed() is armed
