"""Fault injection in the port (`aclswarm_torch.faults`, the fault model of
`sim.engine.step`, the recovery clock of `sim.summary`) against the
reference's on its own cases (`tests/test_faults.py`, one counterpart per
test), float64 on the CPU; the JAX side runs as its own tests run it.

- Discrete fields equal the reference's on every tick: `v2f`, `mode`,
  `auctioned`, `assign_valid`, `reassigned`, `ca_active`, `alive`,
  `fault_event`, and the summary's `n_alive`, `recovery_ticks` and
  `fault_churn`; so do the link masks (the threefry draws bit for bit)
  and the estimate ages.
- Floats: positions and |distcmd| at 1e-9 through tick 60, as
  `tests/test_torch_batched.py` holds them (the closed loop grows the
  summation-order seed of ~1e-15 past that on these chaotic cases).
- Port against port, bit for bit: `no_faults` against ``faults=None``
  (serial, flooded, batched) and a batch of different scripts against
  its serial rollouts: the reference's heterogeneous case (B=3, CBAA on
  the flooded model under the flight FSM) and its B=8 sweep, which
  `tests/test_faults.py` marks slow and which here, at n=6, takes ~6 s.

Seeds are the reference's own. The three degenerate scripts of a mode fly
as one batch in each package (a batch equals its serial rollouts in
both), to keep tier-1 short. Serial time of this file on one CPU host:
~25 s, mostly JAX compiling its scans.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclswarm_torch import convert, faults, sim
from aclswarm_torch.core import types as ttypes
from aclswarm_torch.core.types import ControlGains
from aclswarm_torch.sim import summary as tsum
from aclswarm_tpu import faults as jfaults
from aclswarm_tpu import sim as jsim
from aclswarm_tpu.core.types import ControlGains as JControlGains
from aclswarm_tpu.core.types import SafetyParams as JSafetyParams
from aclswarm_tpu.core.types import make_formation as jmake_formation
from aclswarm_tpu.sim import summary as jsum

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

CPU64 = dict(device="cpu", dtype=torch.float64)
ATOL, TICKS_AT_ATOL = 1e-9, 60
EXACT = ("v2f", "mode", "auctioned", "assign_valid", "reassigned",
         "ca_active", "alive", "fault_event")
ALL = ("distcmd_norm", "ca_active", "assign_valid", "reassigned",
       "auctioned", "q", "mode", "v2f", "alive", "fault_event")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _problem(B, n, seed=0, localization=False, scheds=None):
    """The reference's `_problem`: B formations on a complete graph with
    random gains, B starts (with their fault scripts), both packages."""
    rng = np.random.default_rng(seed)
    adj = np.ones((n, n)) - np.eye(n)
    forms, states = [], []
    for b in range(B):
        pts = rng.normal(size=(n, 3)) * 5
        gains = rng.normal(size=(n, n, 3, 3)) * 0.01
        forms.append(jmake_formation(jnp.asarray(pts), jnp.asarray(adj),
                                     jnp.asarray(gains)))
        states.append(jsim.init_state(
            rng.normal(size=(n, 3)) * 5 + np.array([0, 0, 2.0]),
            localization=localization,
            faults=None if scheds is None else scheds[b]))
    sp = JSafetyParams(bounds_min=jnp.asarray([-50.0, -50.0, 0.0]),
                       bounds_max=jnp.asarray([50.0, 50.0, 20.0]))
    return states, forms, sp


def _port(state, form, sp):
    return (convert.sim_state_from_numpy(_np(state), **CPU64),
            convert.formation_from_numpy(_np(form), **CPU64),
            convert.safety_params_from_numpy(_np(sp)))


def _stack(xs):
    return jax.tree.map(lambda *ls: jnp.stack(ls), *xs)


def _assert_matches_reference(tm, jm, names=EXACT):
    for k in names:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    for k in ("q", "distcmd_norm"):
        np.testing.assert_allclose(
            getattr(tm, k).numpy()[:TICKS_AT_ATOL],
            np.asarray(getattr(jm, k))[:TICKS_AT_ATOL], rtol=0, atol=ATOL,
            err_msg=k)


def _assert_port_equal(m1, m2, f1, f2, names=ALL[:8]):
    for k in names:
        assert torch.equal(getattr(m1, k), getattr(m2, k)), k
    for a, b in ((f1.swarm.q, f2.swarm.q), (f1.swarm.vel, f2.swarm.vel),
                 (f1.v2f, f2.v2f)):
        assert torch.equal(a, b)


def _assert_valid_perms(v2f):
    flat = v2f.reshape(-1, v2f.shape[-1])
    assert all(sorted(r.tolist()) == list(range(flat.shape[1]))
               for r in flat)


# --------------------------------------------------------------------------
# 1. no-fault schedule == the fault-free engine, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("assignment", ["auction", "sinkhorn", "cbaa"])
def test_no_fault_schedule_bit_parity_serial(assignment):
    """The port's `no_faults` against its ``faults=None``, bit for bit
    (each mode's faulted rollouts meet the reference's in
    `test_masked_assignment_degenerates`); two auctions, 0 and 60."""
    n, T = 6, 70
    states, forms, sp = _problem(1, n, seed=1)
    kw = dict(assignment=assignment, assign_every=60, flight_fsm=True)
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    f0, m0 = sim.rollout(tstate, tform, ControlGains(), tsp,
                         sim.SimConfig(**kw), T)
    f1, m1 = sim.rollout(dataclasses.replace(
        tstate, faults=faults.no_faults(n, **CPU64)), tform,
        ControlGains(), tsp, sim.SimConfig(**kw), T)
    _assert_port_equal(m0, m1, f0, f1)
    assert m1.alive.all() and not m1.fault_event.any()
    assert m0.alive is None and m0.fault_event is None


def test_no_fault_schedule_bit_parity_flooded():
    """Flooded: the link mask of `no_faults` perturbs no estimate."""
    n, T = 6, 130
    states, forms, sp = _problem(1, n, seed=2, localization=True)
    kw = dict(assignment="cbaa", assign_every=60, localization="flooded",
              flight_fsm=True)
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    f0, m0 = sim.rollout(tstate, tform, ControlGains(), tsp,
                         sim.SimConfig(**kw), T)
    f1, m1 = sim.rollout(dataclasses.replace(
        tstate, faults=faults.no_faults(n, **CPU64)), tform,
        ControlGains(), tsp, sim.SimConfig(**kw), T)
    _assert_port_equal(m0, m1, f0, f1)
    assert torch.equal(f0.loc.est, f1.loc.est)
    assert torch.equal(f0.loc.age, f1.loc.age)


def test_no_fault_schedule_bit_parity_batched():
    B, n, T = 3, 6, 70
    states, forms, sp = _problem(B, n, seed=3)
    kw = dict(assignment="auction", assign_every=60)
    tstate, tform, tsp = _port(_stack(states), _stack(forms), sp)
    nf = ttypes.stack([faults.no_faults(n, **CPU64) for _ in range(B)])
    f0, m0 = sim.batched_rollout(tstate, tform, ControlGains(), tsp,
                                 sim.SimConfig(**kw), T)
    f1, m1 = sim.batched_rollout(dataclasses.replace(tstate, faults=nf),
                                 tform, ControlGains(), tsp,
                                 sim.SimConfig(**kw), T)
    _assert_port_equal(m0, m1, f0, f1)


# --------------------------------------------------------------------------
# 3. masked-assignment degenerate cases
# --------------------------------------------------------------------------

def _degenerate_schedule(n, kind, drop=30, rejoin=90):
    drops = np.full((n,), jfaults.NEVER, np.int32)
    rejoins = np.full((n,), jfaults.NEVER, np.int32)
    if kind == "all_dead":
        drops[:] = drop
    elif kind == "single_survivor":
        drops[1:] = drop
    else:
        drops[: n // 2] = drop
        rejoins[: n // 2] = rejoin
    return jfaults.FaultSchedule(drop_tick=jnp.asarray(drops),
                                 rejoin_tick=jnp.asarray(rejoins),
                                 link_loss=jnp.zeros((n, n), jnp.float64),
                                 key=jnp.zeros((2,), jnp.uint32))


KINDS = ("all_dead", "single_survivor", "round_trip")
# the reference runs 190 ticks; 130 hold its auctions at 0, 60 (dead)
# and 120 (after the rejoin at 90)
DROP, REJOIN, T_DEGENERATE = 30, 90, 130


@functools.lru_cache(maxsize=None)
def _degenerate_runs(assignment):
    """The three degenerate scripts as one batch (the reference's start,
    seed 5, one row each), rolled by both packages' batched rollouts
    (each equal to its serial rollouts, `tests/test_batched.py` and the
    heterogeneous case below): ``(port metrics, reference metrics)``."""
    n = 6
    states, forms, sp = _problem(1, n, seed=5)
    jb = _stack([states[0].replace(faults=_degenerate_schedule(
        n, k, DROP, REJOIN)) for k in KINDS])
    jfm = _stack([forms[0]] * len(KINDS))
    tstate, tform, tsp = _port(jb, jfm, sp)
    kw = dict(assignment=assignment, assign_every=60)
    _, jm = jsim.batched_rollout(jb, jfm, JControlGains(), sp,
                                 jsim.SimConfig(**kw), T_DEGENERATE)
    _, tm = sim.batched_rollout(tstate, tform, ControlGains(), tsp,
                                sim.SimConfig(**kw), T_DEGENERATE)
    return tm, jm


def _row(metrics, b, port=True):
    return types.SimpleNamespace(**{
        k: (v[:, b] if port else np.asarray(v)[:, b])
        for k, v in vars(metrics).items() if v is not None})


@pytest.mark.parametrize("assignment", ["auction", "sinkhorn", "cbaa"])
@pytest.mark.parametrize("kind", KINDS)
def test_masked_assignment_degenerates(assignment, kind):
    b = KINDS.index(kind)
    tm_all, jm_all = _degenerate_runs(assignment)
    tm, jm = _row(tm_all, b), _row(jm_all, b, port=False)
    _assert_matches_reference(tm, jm)
    _assert_valid_perms(tm.v2f)
    v2f, alive = tm.v2f.numpy(), tm.alive.numpy()
    pre = v2f[DROP - 1]
    for t in range(DROP, T_DEGENERATE):
        dead = ~alive[t]
        np.testing.assert_array_equal(v2f[t][dead], pre[dead])
    if kind == "round_trip":
        assert alive[REJOIN:].all()
        assert (tm.auctioned & tm.assign_valid).numpy()[REJOIN:].any()


def test_dead_vehicles_freeze_and_cast_no_sector():
    """The auction case's round trip: frozen from drop to rejoin, moving
    again after it, no distcmd and no avoidance activity while dead."""
    tm_all, _ = _degenerate_runs("auction")
    tm = _row(tm_all, KINDS.index("round_trip"))
    q, alive = tm.q.numpy(), tm.alive.numpy()
    dead = ~alive[DROP]
    assert dead.any()
    for t in range(DROP, REJOIN):
        np.testing.assert_array_equal(q[t][dead], q[DROP][dead])
    assert not np.array_equal(q[REJOIN + 30][dead], q[DROP][dead])
    assert (tm.distcmd_norm.numpy()[DROP:REJOIN][:, dead] == 0.0).all()
    assert not tm.ca_active.numpy()[DROP:REJOIN][:, dead].any()


def test_lossy_links_hold_last_value():
    """Every link lost: the flood delivers nothing, the ages reach T and
    the estimates stay the startup census; lossless links flood. (The
    reference's lossy floods meet the port's ages in the heterogeneous
    case below.)"""
    n, T = 5, 40
    states, forms, sp = _problem(1, n, seed=7, localization=True)
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    cfg = sim.SimConfig(assignment="none", localization="flooded")
    lossy = faults.FaultSchedule(
        drop_tick=torch.full((n,), int(faults.NEVER), dtype=torch.int32),
        rejoin_tick=torch.full((n,), int(faults.NEVER), dtype=torch.int32),
        link_loss=torch.ones((n, n), dtype=torch.float64)
        - torch.eye(n, dtype=torch.float64),
        key=torch.zeros((2,), dtype=torch.int64))
    tf, _ = sim.rollout(dataclasses.replace(tstate, faults=lossy), tform,
                        ControlGains(), tsp, cfg, T)
    off = ~np.eye(n, dtype=bool)
    assert (tf.loc.age.numpy()[off] == T).all()
    np.testing.assert_array_equal(tf.loc.est.numpy()[off],
                                  tstate.loc.est.numpy()[off])
    f0, _ = sim.rollout(dataclasses.replace(
        tstate, faults=faults.no_faults(n, **CPU64)), tform, ControlGains(),
        tsp, cfg, T)
    assert (f0.loc.age.numpy()[off] < T).all()


def test_link_draws_reproducible_and_seeded():
    """The port's link masks equal the reference's bit for bit (per tick,
    per seed, and for a batch of schedules with per-trial ticks)."""
    p, n = 0.5, 8
    js = [jfaults.sample_schedule(s, n, link_loss=p) for s in (1, 2)]
    ts = [faults.sample_schedule(s, n, link_loss=p, device="cpu")
          for s in (1, 2)]
    for j, t in zip(js, ts):
        for tick in (0, 17, 18, 1234):
            np.testing.assert_array_equal(
                faults.link_up_at(t, tick).numpy(),
                np.asarray(jfaults.link_up_at(j, tick)))
    a = faults.link_up_at(ts[0], 17)
    assert torch.equal(a, faults.link_up_at(
        faults.sample_schedule(1, n, link_loss=p, device="cpu"), 17))
    assert not torch.equal(a, faults.link_up_at(ts[0], 18))
    assert not torch.equal(a, faults.link_up_at(ts[1], 17))
    assert a[torch.eye(n, dtype=torch.bool)].all()
    batch = ttypes.stack(ts)
    ticks = torch.tensor([17, 1234], dtype=torch.int32)
    up = faults.link_up_at(batch, ticks)
    for b, tick in enumerate((17, 1234)):
        assert torch.equal(up[b], faults.link_up_at(ts[b], tick))
    # the float32 draws too (the card's dtype)
    j32 = jfaults.sample_schedule(3, n, link_loss=0.3)
    t32 = faults.sample_schedule(3, n, link_loss=0.3, device="cpu")
    np.testing.assert_array_equal(faults.link_up_at(t32, 5).numpy(),
                                  np.asarray(jfaults.link_up_at(j32, 5)))
    for tick in (0, 29, 30, 31):
        for f in ("alive_at", "fault_event_at"):
            np.testing.assert_array_equal(
                getattr(faults, f)(faults.sample_schedule(
                    4, n, dropout_frac=0.5, drop_tick=30, device="cpu"),
                    tick).numpy(),
                np.asarray(getattr(jfaults, f)(jfaults.sample_schedule(
                    4, n, dropout_frac=0.5, drop_tick=30), tick)))


# --------------------------------------------------------------------------
# 4. recovery observability (sim.summary)
# --------------------------------------------------------------------------

def test_recovery_clock_matches_host_recompute():
    """The device clock across a chunk boundary against the host
    recomputation and the reference's batched summary."""
    B, n, T, W = 2, 6, 150, 20
    scheds = [jfaults.sample_schedule(20 + b, n, dropout_frac=0.34,
                                      drop_tick=40, rejoin_tick=100,
                                      dtype=jnp.float64) for b in range(B)]
    states, forms, sp = _problem(B, n, seed=8, scheds=scheds)
    jb, jfm = _stack(states), _stack(forms)
    tstate, tform, tsp = _port(jb, jfm, sp)
    kw = dict(assignment="auction", assign_every=50)
    jc = jsum.init_carry(n, W, dtype=jnp.float64, batch=B)
    tc = tsum.init_carry(n, W, batch=B, **CPU64)
    jchunks, tchunks = [], []
    for _ in range(2):
        jb, jc, js = jsum.batched_rollout_summary(
            jb, jc, jfm, JControlGains(), sp, jsim.SimConfig(**kw), T // 2,
            None, 0, window=W, takeoff_alt=2.0)
        tstate, tc, ts = tsum.batched_rollout_summary(
            tstate, tc, tform, ControlGains(), tsp, sim.SimConfig(**kw),
            T // 2, None, 0, window=W, takeoff_alt=2.0)
        jchunks.append(_np(js))
        tchunks.append(ts)

    def cat(chunks, name, conv=np.asarray):
        return np.concatenate([conv(getattr(c, name)) for c in chunks],
                              axis=1)

    for name in ("fault_event", "n_alive", "recovery_ticks", "fault_churn",
                 "conv_all", "reassigned"):
        np.testing.assert_array_equal(
            cat(tchunks, name, lambda x: x.numpy()), cat(jchunks, name),
            err_msg=name)
    for k in ("rec_pending", "rec_since", "rec_churn"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)))
    ev, conv, re = (cat(tchunks, k, lambda x: x.numpy()) for k in (
        "fault_event", "conv_all", "reassigned"))
    rec, chn = (cat(tchunks, k, lambda x: x.numpy()) for k in (
        "recovery_ticks", "fault_churn"))
    for b in range(B):
        pending, since, churn = False, 0, 0
        for t in range(T):
            since = 0 if ev[b, t] else since + 1
            churn = 0 if ev[b, t] else churn + int(re[b, t])
            pending = pending or bool(ev[b, t])
            done = (pending and bool(conv[b, t]) and not bool(ev[b, t])
                    and since >= W)
            assert rec[b, t] == (since if done else -1), (b, t)
            assert chn[b, t] == (churn if done else -1), (b, t)
            if done:
                pending = False
        assert ev[b].sum() == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_recovery_clock_whole_chunk_form(seed):
    """The port's whole-chunk clock against the reference's scan on
    random flags, three chunks of 37 ticks, a window of 5: events that
    fall inside one window, recoveries, carried pending windows."""
    rng = np.random.default_rng(seed)
    B, T, W = 4, 37, 5
    jc = jsum.init_carry(3, W, dtype=jnp.float64, batch=B)
    tc = tsum.init_carry(3, W, batch=B, **CPU64)
    fired = 0
    for _ in range(3):
        ev = rng.random((B, T)) < 0.06
        conv = rng.random((B, T)) < 0.7
        re = rng.random((B, T)) < 0.3
        outs = [jsum._recovery_clock(ev[b], conv[b], re[b],
                                     jax.tree.map(lambda x: x[b], jc), W)
                for b in range(B)]
        got = tsum._recovery_clock(torch.as_tensor(ev),
                                   torch.as_tensor(conv),
                                   torch.as_tensor(re), tc, W)
        for i in range(5):
            np.testing.assert_array_equal(
                got[i].numpy(), np.stack([np.asarray(o[i]) for o in outs]))
        fired += int((got[0] >= 0).sum())
        jc = jc.replace(rec_pending=jnp.asarray(got[2].numpy()),
                        rec_since=jnp.asarray(got[3].numpy()),
                        rec_churn=jnp.asarray(got[4].numpy()))
        tc = tsum.SummaryCarry(**{**vars(tc), "rec_pending": got[2],
                                  "rec_since": got[3], "rec_churn": got[4]})
    assert fired > 0


def test_summary_without_faults_has_none_fields():
    n, T, W = 6, 60, 20
    states, forms, sp = _problem(1, n, seed=9)
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    _, m = sim.rollout(tstate, tform, ControlGains(), tsp,
                       sim.SimConfig(assignment="auction", assign_every=60),
                       T)
    summ, carry = tsum.summarize_chunk(m, tsum.init_carry(n, W, **CPU64),
                                       W, 2.0)
    assert summ.recovery_ticks is None and summ.fault_event is None
    assert summ.n_alive is None and summ.fault_churn is None
    assert not carry.rec_pending and carry.rec_since == 0


# --------------------------------------------------------------------------
# 5. guard rails
# --------------------------------------------------------------------------

def test_flooded_with_faults_needs_localization_tables():
    n = 5
    states, forms, sp = _problem(1, n, seed=10)
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    cfg = sim.SimConfig(assignment="none", localization="flooded")
    with pytest.raises(ValueError, match="FaultSchedule"):
        sim.step(sim.init_state(tstate.swarm.q,
                                faults=faults.no_faults(n, **CPU64),
                                **CPU64), tform, ControlGains(), tsp, cfg)
    with pytest.raises(ValueError, match="localization=True"):
        sim.step(tstate, tform, ControlGains(), tsp, cfg)


def test_sample_schedule_validates_rejoin():
    with pytest.raises(ValueError, match="rejoin_tick"):
        faults.sample_schedule(0, 4, dropout_frac=0.5, drop_tick=10,
                               rejoin_tick=10, device="cpu")
    # the same seed picks the same victims as the reference
    for seed in range(5):
        t = faults.sample_schedule(seed, 9, dropout_frac=0.34, drop_tick=7,
                                   rejoin_tick=70, link_loss=0.2,
                                   device="cpu")
        j = jfaults.sample_schedule(seed, 9, dropout_frac=0.34,
                                    drop_tick=7, rejoin_tick=70,
                                    link_loss=0.2)
        for k in ("drop_tick", "rejoin_tick", "link_loss", "key"):
            np.testing.assert_array_equal(getattr(t, k).numpy(),
                                          np.asarray(getattr(j, k)))


# --------------------------------------------------------------------------
# 6. different scripts in one batch: == the reference, == serial
# --------------------------------------------------------------------------

def _sweep_case(B, n, seed, scheds, kw, T, serial=True):
    states, forms, sp = _problem(B, n, seed=seed, localization=True,
                                 scheds=scheds)
    jb, jfm = _stack(states), _stack(forms)
    tstate, tform, tsp = _port(jb, jfm, sp)
    jf, jm = jsim.batched_rollout(jb, jfm, JControlGains(), sp,
                                  jsim.SimConfig(**kw), T)
    tf, tm = sim.batched_rollout(tstate, tform, ControlGains(), tsp,
                                 sim.SimConfig(**kw), T)
    _assert_matches_reference(tm, jm)
    np.testing.assert_array_equal(tf.loc.age.numpy(), np.asarray(jf.loc.age))
    for b in range(B if serial else 0):
        fs, ms = sim.rollout(sim.trial(tstate, b), ttypes.row(tform, b),
                             ControlGains(), tsp, sim.SimConfig(**kw), T)
        for k in ALL:
            assert torch.equal(getattr(ms, k), getattr(tm, k)[:, b]), (b, k)
        assert torch.equal(fs.loc.age, tf.loc.age[b])
    _assert_valid_perms(tm.v2f)
    return tm


def test_heterogeneous_schedules_batched_matches_serial():
    B, n, T = 3, 6, 130
    scheds = [
        jfaults.no_faults(n, jnp.float64),
        jfaults.sample_schedule(11, n, dropout_frac=0.34, drop_tick=30,
                                rejoin_tick=90, dtype=jnp.float64),
        jfaults.sample_schedule(12, n, dropout_frac=0.5, drop_tick=61,
                                link_loss=0.4, dtype=jnp.float64),
    ]
    kw = dict(assignment="cbaa", assign_every=60, localization="flooded",
              flight_fsm=True)
    _sweep_case(B, n, 4, scheds, kw, T)


@pytest.mark.slow   # as the reference marks its own
def test_fault_sweep_b8_batched_matches_serial():
    B, n, T = 8, 6, 130
    rng = np.random.default_rng(0)
    scheds = [jfaults.sample_schedule(
        b, n, dropout_frac=float(rng.choice([0.0, 0.17, 0.34])),
        drop_tick=30, rejoin_tick=int(rng.integers(70, 110)),
        link_loss=float(rng.choice([0.0, 0.3])), dtype=jnp.float64)
        for b in range(B)]
    kw = dict(assignment="cbaa", assign_every=60, localization="flooded")
    # batch = serial is the heterogeneous case's; here the reference only
    tm = _sweep_case(B, n, 11, scheds, kw, T, serial=False)
    assert tm.fault_event.any() and not tm.alive.all()
