"""Telemetry (`aclswarm_torch.telemetry`) against the reference's, on the
CPU: the host registry's copy, the device counters' host side, the ADMM
solve statistics, the carries across `convert` and the checkpoint codec,
and the summary's packed copies.

- The same updates through the port's and the reference's
  `MetricsRegistry` give the same snapshot, JSONL and Prometheus text;
  the same chunk snapshots through both `ChunkPublisher`s (two trials,
  a dispatch solve, a resumed trial) publish the same registries.
- `solve_gains(..., telemetry=True)` returns the reference's iterations
  exactly and its final residual at rtol 1e-12 (float64), cold and warm,
  checked or not, in the reference's return order.
- The reference's `InvariantState` and `ChunkTelemetry` carries cross
  `convert` both ways and a checkpoint file bit for bit.
- `summary.to_host` reads the codes and the counters in its two copies:
  what it unpacks equals the tensors it packed.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aclswarm_torch.telemetry as ttel
import aclswarm_tpu.telemetry as jtel
from aclswarm_torch import convert
from aclswarm_torch import gains as tgains
from aclswarm_torch import sim as tsim
from aclswarm_torch.core.types import ControlGains, SafetyParams
from aclswarm_torch.resilience import checkpoint as tckpt
from aclswarm_torch.sim import summary as tsum
from aclswarm_torch.telemetry import device as tdev
from aclswarm_torch.utils import locks as tlocks
from aclswarm_tpu import sim as jsim
from aclswarm_tpu.gains import admm as jadmm
from aclswarm_tpu.telemetry import device as jdev

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

CPU64 = dict(device="cpu", dtype=torch.float64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _drive(reg):
    reg.counter("a_total").inc(3)
    reg.counter("a_total").inc()
    reg.counter("b_total", labels={"k": 'x"y\n'}).inc(2.5)
    reg.gauge("g").set(4.0)
    reg.gauge("g").add(-1.5)
    h = reg.histogram("h_s", reservoir=8)
    for v in (0.5, 0.1, 0.9, 0.3, 0.7, 0.2, 0.8, 0.4, 0.6, 1.0, 0.05):
        h.observe(v)
    return reg


def test_registry_matches_reference():
    t, j = _drive(ttel.MetricsRegistry()), _drive(jtel.MetricsRegistry())
    assert t.snapshot() == j.snapshot()
    assert t.to_jsonl() == j.to_jsonl()
    assert t.prometheus_text() == j.prometheus_text()
    assert ttel.reset_registry() is ttel.get_registry()


def _snapshots():
    """Chunk-boundary snapshots of two trials: trial 0 auctions and lands
    a dispatch solve, trial 1 is resumed (its first snapshot replays a
    cumulative value)."""
    base = dict(auctions=0, assign_rounds=0, reassigns=0, ca_ticks=0,
                flood_stale_max=0, admm_iters=0, admm_residual=0.0)
    return [
        (0, base),
        (1, dict(base, auctions=4, reassigns=2, ca_ticks=30,
                 flood_stale_max=6)),
        (0, dict(base, auctions=1, assign_rounds=17, ca_ticks=5,
                 flood_stale_max=3, admm_iters=12, admm_residual=3.5e-5)),
        (0, dict(base, auctions=2, assign_rounds=30, reassigns=1,
                 ca_ticks=9, flood_stale_max=4, admm_iters=12,
                 admm_residual=3.5e-5)),
        (1, dict(base, auctions=5, reassigns=2, ca_ticks=31,
                 flood_stale_max=2, admm_iters=2, admm_residual=1e-4)),
    ]


def test_publisher_matches_reference():
    regs = []
    for mod, reg_mod in ((tdev, ttel), (jdev, jtel)):
        reg = reg_mod.MetricsRegistry()
        pub = mod.ChunkPublisher(reg, prefix="trial")
        for key, snap in _snapshots():
            pub.publish(key, snap)
        regs.append(reg)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].snapshot()["metrics"]["trial_auctions_total"]["value"] \
        == 7


def test_to_host_matches_reference():
    rng = np.random.default_rng(2)
    stacked = {f: rng.integers(0, 50, (7, 3)).astype(np.int32)
               for f in tdev.INT_FIELDS}
    stacked["admm_residual"] = rng.random((7, 3))
    jtel_carry = jdev.ChunkTelemetry(**{k: jnp.asarray(v)
                                        for k, v in stacked.items()})
    ttel_carry = tdev.ChunkTelemetry(**{k: torch.as_tensor(v)
                                        for k, v in stacked.items()})
    for index in ((-1, 1), (2, 0)):
        assert tdev.to_host(ttel_carry, index) \
            == jdev.to_host(jtel_carry, index) \
            == tdev.to_host(stacked, index)
    fresh = tdev.init_telemetry(3, dtype=torch.float64, device="cpu")
    ref = jdev.init_telemetry(3, dtype=jnp.float64)
    for f in tdev.FIELDS:
        np.testing.assert_array_equal(getattr(fresh, f).numpy(),
                                      np.asarray(getattr(ref, f)))
        assert str(getattr(fresh, f).dtype).removeprefix("torch.") \
            == str(np.asarray(getattr(ref, f)).dtype)


def _case():
    ang = np.linspace(0, 2 * np.pi, 7, endpoint=False)
    pts = np.stack([3 * np.cos(ang), 3 * np.sin(ang),
                    2.0 + 0.3 * np.sin(2 * ang)], 1)
    adj = np.ones((7, 7)) - np.eye(7)
    adj[0, 3] = adj[3, 0] = adj[1, 5] = adj[5, 1] = 0
    return pts, adj


def test_solve_statistics_match_reference():
    """Cold, then warm from the cold solve's carry, both checked: the
    reference's return order ``(gains[, carry], stats)``, the same
    iterations, the residual at rtol 1e-12."""
    check_mode = "on"
    pts, adj = _case()
    jg, jst = jadmm.solve_gains(pts, adj, telemetry=True,
                                check_mode=check_mode)
    tg, tst = tgains.solve_gains(pts, adj, telemetry=True,
                                 check_mode=check_mode, device="cpu")
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-12)
    assert tst.iters == jst.iters > 0
    np.testing.assert_allclose(tst.residual, jst.residual, rtol=1e-12)
    jc0 = jadmm.init_carry(7, jadmm.planar_of(pts))
    _, jc, _ = jadmm.solve_gains(pts, adj, telemetry=True, carry=jc0)
    tc = convert.admm_carry_from_numpy(_np(jc), **CPU64)
    _, jc2, jst2 = jadmm.solve_gains(pts * 1.1, adj, telemetry=True,
                                     carry=jc, check_mode=check_mode)
    _, tc2, tst2 = tgains.solve_gains(pts * 1.1, adj, telemetry=True,
                                      carry=tc, check_mode=check_mode,
                                      device="cpu")
    assert tst2.iters == jst2.iters < jst.iters
    assert int(tc2.iters) == int(np.asarray(jc2.iters))
    np.testing.assert_allclose(tst2.residual, jst2.residual, rtol=1e-12)


def test_carries_cross_convert_and_the_codec(tmp_path):
    """A reference state with both carries (batched, after a few checked
    and counted ticks) crosses to the port and back, and through a
    checkpoint file, bit for bit; a checkpoint of a state without them is
    refused by a template with them."""
    q0 = np.random.default_rng(0).normal(size=(2, 5, 3)) * 2
    q0[..., 2] = 2.0
    states = [jsim.init_state(jnp.asarray(q), checks=True, telemetry=True)
              for q in q0]
    jb = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    jb = jb.replace(tel=jb.tel.replace(
        auctions=jnp.asarray([3, 4], jnp.int32),
        admm_residual=jnp.asarray([1e-5, 2e-5])),
        inv=jb.inv.replace(code=jnp.asarray([0, 7], jnp.int32),
                           tick=jnp.asarray([-1, 12], jnp.int32)))
    ref = _np(jb)
    port = convert.sim_state_from_numpy(ref, **CPU64)
    back = convert.sim_state_to_numpy(port)
    for part in ("inv", "tel"):
        for k, v in back[part].items():
            want = np.asarray(getattr(getattr(ref, part), k))
            np.testing.assert_array_equal(v, want)
            assert v.dtype == want.dtype, (part, k)
    path = tckpt.write_checkpoint(tmp_path, "s", {"state": back},
                                  tckpt.make_manifest("t", "h", 1, "fp"))
    loaded, _ = tckpt.load_checkpoint(path)
    again = tckpt.restore_state(port, loaded["state"], path=path)
    assert torch.equal(again.inv.tick, port.inv.tick)
    assert torch.equal(again.tel.admm_residual, port.tel.admm_residual)
    bare = convert.sim_state_to_numpy(tsim.init_state(q0[0], **CPU64))
    with pytest.raises(tckpt.CheckpointMismatch, match="inv"):
        tckpt.restore_state(tsim.init_state(q0[0], checks=True, **CPU64),
                            bare)


def test_summary_packs_codes_and_counters():
    """`to_host` returns, in its two copies, exactly the flags, codes,
    counters and distances of the summary it was handed."""
    rng = np.random.default_rng(3)
    q0 = rng.normal(size=(2, 5, 3)) * 3
    q0[..., 2] = 2.0
    bstate = tsim.stack_states([
        tsim.init_state(q, localization=True, checks=True, telemetry=True,
                        **CPU64) for q in q0])
    adj = torch.ones((2, 5, 5), dtype=torch.float64) - torch.eye(5)
    from aclswarm_torch.core import types as typeslib
    form = typeslib.make_formations(q0, adj.numpy(), None, **CPU64)
    cfg = tsim.SimConfig(assignment="sinkhorn", assign_every=2,
                         localization="flooded", check_mode="on",
                         telemetry="on")
    carry = tsum.init_carry(5, 3, dtype=torch.float64, device="cpu",
                            batch=2)
    sp = SafetyParams(bounds_min=(-50, -50, 0), bounds_max=(50, 50, 10))
    _, _, summ = tsum.batched_rollout_summary(
        bstate, carry, form, ControlGains(), sp, cfg, 6, window=3,
        takeoff_alt=1.0)
    host = tsum.to_host(summ)
    for k in tsum.FLAGS:
        np.testing.assert_array_equal(host[k], getattr(summ, k).numpy())
        assert host[k].dtype == bool
    np.testing.assert_array_equal(host["inv_code"], summ.inv_code.numpy())
    np.testing.assert_array_equal(host["cumdist"], summ.cumdist.numpy())
    for f in tdev.FIELDS:
        np.testing.assert_array_equal(host["tel"][f],
                                      getattr(summ.tel, f).numpy())
    assert host["tel"]["auctions"].tolist() == [3, 3]
    assert tdev.to_host(host["tel"], 1)["flood_stale_max"] > 0
    plain = tsum.ChunkSummary(**{**vars(summ), "inv_code": None,
                                 "tel": None})
    assert "tel" not in tsum.to_host(plain)


def test_lock_order_is_checked_when_armed():
    outer = tlocks.OrderedLock("telemetry.metric")
    inner = tlocks.OrderedLock("telemetry.registry")
    with outer, inner:          # disarmed: a plain lock
        pass
    tlocks.arm()
    try:
        with pytest.raises(tlocks.LockOrderViolation, match="rank"):
            with outer, inner:
                pass
        with inner, outer:
            assert tlocks.held_families() == ("telemetry.registry",
                                              "telemetry.metric")
    finally:
        tlocks.disarm()
    assert json.loads(ttel.get_registry().to_jsonl().splitlines()[-1])[
        "name"] == "spans_dropped_total"
