"""`torchcheck` layer 2 (`aclswarm_torch.analysis.trace_audit`) against the
reference's registry (`aclswarm_tpu.analysis.trace_audit`).

The port registers the reference's entry names, each bound to the port's
counterpart. At every tier-1 grid point (n=5, B=2, one point per solver,
faulted and flooded), on the CPU: the second and third identical calls
dispatch the same ATen op stream (check (b)); no output leaf is float64
(check (c)); the output leaves carry the reference's dtypes in f32 mode,
leaf by leaf (the reference's from `jax.eval_shape`); and with the checks
and counters off the op stream equals the committed `aten_baseline.json`
(the zero-cost-off proof), which the sanitizer-on variant does not. The
host-sync budgets (check (a)) are a card check (`chip_smoke.py --phases
audit`).
"""
import json
from functools import partial

import numpy as np
import pytest
import torch

import jax

from aclswarm_torch.analysis import trace_audit as ta
from aclswarm_tpu.analysis import trace_audit as ref_ta

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

ENTRIES = {e.name: e for e in ta.ENTRY_POINTS}
REF_ENTRIES = {e.name: e for e in ref_ta.ENTRY_POINTS}
BASELINE = json.loads(ta.ATEN_BASELINE_PATH.read_text())
SAME_TORCH = BASELINE["torch_version"] == torch.__version__


def _ref_dtypes(entry, gp) -> list[str]:
    """The reference entry's output leaf dtypes at ``gp`` in f32 mode,
    from an abstract trace (nothing compiled)."""
    with ref_ta.f32_mode():
        args, statics = entry.build(gp)
        fn = getattr(entry.fn, "__wrapped__", entry.fn)
        wrapper = jax.jit(partial(fn), static_argnames=entry.static_argnames)
        out = jax.eval_shape(partial(wrapper, **statics),
                             *ref_ta._shape_only(ref_ta._commit(args)))
    return [str(x.dtype) for x in jax.tree.leaves(out) if x is not None]


def test_entry_names_equal_the_reference():
    assert list(ENTRIES) == list(REF_ENTRIES)
    assert len(ENTRIES) == len(ta.ENTRY_POINTS)
    for name, e in ENTRIES.items():
        assert e.axes == REF_ENTRIES[name].axes, name
        assert e.baseline == REF_ENTRIES[name].baseline, name


def test_grid_equals_the_reference():
    assert [(g.n, g.B, g.solver, g.faults, g.localization)
            for g in ta.iter_grid()] == \
        [(g.n, g.B, g.solver, g.faults, g.localization)
         for g in ref_ta.iter_grid()]


@pytest.mark.parametrize("name", list(ENTRIES))
def test_entry_clean_and_as_the_reference(name):
    entry, ref_entry = ENTRIES[name], REF_ENTRIES[name]
    ran = 0
    for gp in ta.grid_points(entry):
        ref_gp = ref_ta.GridPoint(n=gp.n, B=gp.B, solver=gp.solver,
                                  faults=gp.faults,
                                  localization=gp.localization)
        try:
            r = ta.audit_entry(entry, gp, "cpu")
        except ta.Skip:
            with pytest.raises(ref_ta.Skip):
                ref_entry.build(ref_gp)
            continue
        ran += 1
        assert not r.changed, \
            f"{name} {gp}: a repeated identical call dispatched another " \
            "op stream"
        assert not r.f64_leaves, f"{name} {gp}: float64 leaves {r.out_dtypes}"
        assert list(r.out_dtypes) == _ref_dtypes(ref_entry, ref_gp), \
            f"{name} {gp}"
        if entry.baseline and SAME_TORCH:
            cell = BASELINE["cells"][ta.grid_key(entry, gp)]
            assert (r.op_digest, r.n_ops) == (cell["digest"], cell["ops"]), \
                f"{name} {gp}: the op stream left the committed baseline " \
                "(if it changed on purpose: python -m aclswarm_torch." \
                "analysis.trace_audit --write-aten-baseline)"
    assert ran, f"{name}: no grid point ran"


def test_baseline_covers_every_baseline_cell():
    want = {ta.grid_key(e, gp) for e in ta.ENTRY_POINTS if e.baseline
            for gp in ta.grid_points(e)
            if not (e.name == "interop.planner.tick"
                    and gp.solver == "sinkhorn")}
    assert set(BASELINE["cells"]) == want
    assert BASELINE["device"] == "cpu"


def test_checked_variant_differs_from_baseline():
    """Teeth: the sanitizer-on program must not dispatch the off program's
    ops — if it did, the off-mode proof would prove nothing."""
    gp = next(ta.iter_grid())
    on = ta.audit_entry(ENTRIES["sim.engine.rollout[checked]"], gp,
                        "cpu")
    off = BASELINE["cells"][ta.grid_key(ENTRIES["sim.engine.rollout"], gp)]
    assert not ENTRIES["sim.engine.rollout[checked]"].baseline
    assert (on.op_digest, on.n_ops) != (off["digest"], off["ops"])
    assert on.n_ops > off["ops"]


def test_skipped_build_surfaces_as_uncovered(monkeypatch, tmp_path):
    """A committed digest whose build function now raises Skip lands in
    `uncovered`; a buildable entry with no digest in `unverified`."""
    base = {"torch_version": torch.__version__, "device": "cpu",
            "cells": {"fake.entry|n=5": {"digest": "0" * 64, "ops": 1}}}
    p = tmp_path / "aten_baseline.json"
    p.write_text(json.dumps(base))

    def skipper(gp, dev):
        raise ta.Skip("unsupported combo")

    fake = ta.EntryPoint(name="fake.entry", fn=lambda x: x, build=skipper)
    fresh = ta.EntryPoint(
        name="fresh.entry", fn=lambda x: x * 2,
        build=lambda gp, dev: ((torch.zeros(2, dtype=torch.float32),), {}))
    monkeypatch.setattr(ta, "ATEN_BASELINE_PATH", p)
    monkeypatch.setattr(ta, "ENTRY_POINTS", [fake, fresh])
    z = ta.verify_zero_cost_off()
    assert z["skipped"] is None
    assert z["uncovered"] == ["fake.entry|n=5"]
    assert z["unverified"] == ["fresh.entry|n=5"]
    base["torch_version"] = "0.0"
    p.write_text(json.dumps(base))
    assert ta.verify_zero_cost_off()["skipped"]


def test_leaf_order_and_names():
    """The port's leaves read in the reference's order and names: a
    state's host tick as the reference's int32, key words as uint32, the
    state's estimate tables where the reference keeps them."""
    from aclswarm_torch import sim
    from aclswarm_torch.faults import schedule as faultlib

    dev = torch.device("cpu")
    state = sim.init_state(np.zeros((3, 3), np.float32), localization=True,
                           faults=faultlib.no_faults(3, dev, torch.float32),
                           device=dev)
    dtypes = ta.leaf_dtypes(state)
    assert dtypes[7] == "int32"                 # tick, a host int
    assert dtypes[12:14] == ("float32", "int32")   # loc.est, loc.age
    assert dtypes[-1] == "uint32"               # faults.key
    assert "int64" not in dtypes and "float64" not in dtypes


@pytest.mark.parametrize("gp", list(ta.iter_grid()),
                         ids=lambda g: f"{g.solver}-{g.localization}")
def test_rollout_budgets_follow_the_tick_budget(gp):
    """A rollout's budget is its ticks' (`tick_budget`): 4 ticks, of which
    2 auction (ticks 0 and 2 at assign_every=2), the auctions once per
    trial of a batch, the batch's tick offsets copied once."""
    per = ta.TICK_SYNCS
    tick = ta.tick_budget(gp.localization)
    auction = ta.tick_budget(gp.localization, solver=gp.solver)
    assert ENTRIES["sim.engine.rollout"].budget(gp) == 2 * tick + 2 * auction
    assert ENTRIES["sim.engine.batched_rollout"].budget(gp) == \
        4 * tick + gp.B * 2 * per["auction"][gp.solver] + per["batch_offsets"]
    checked = ta.tick_budget(gp.localization, checked=True)
    assert ENTRIES["sim.engine.rollout[checked]"].budget(gp) == \
        4 * checked + 2 * per["auction"][gp.solver]
    for e in ta.ENTRY_POINTS:
        assert e.syncs_why, e.name
