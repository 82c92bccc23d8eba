"""The serving layer's staging stores (`aclswarm_torch.serve.staging`),
float64 on the CPU.

`write_row`, `gather_rows`, `scatter_rows` and `take_row` against plain
stacking and slicing of the same rows (`sim.stack_states`,
`core.types.stack`), bit for bit and with the host data beside the
tensors (ticks, the scenario's host copy of its onsets); `unpack_round`
against the per-request slices the pack-at-round-time path digests;
`init_row` against `sim.init_state`; the caches' keys and values against
fresh construction.
"""
import numpy as np
import pytest
import torch

from aclswarm_torch import sim
from aclswarm_torch.core import types
from aclswarm_torch.faults import schedule as faultlib
from aclswarm_torch.resilience import checkpoint as ckpt
from aclswarm_torch.scenarios import registry as scenreg
from aclswarm_torch.scenarios import timeline as scenlib
from aclswarm_torch.serve import staging

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

DEV, DT, N = torch.device("cpu"), torch.float64, 5


@pytest.fixture(autouse=True)
def _fresh_caches():
    staging.clear_caches()
    yield
    staging.clear_caches()


def _row(seed: int, faulted: bool = True, tick: int = 0):
    """One serve-shaped row: a state with a fault schedule and a scenario,
    and its formation."""
    rng = np.random.default_rng(seed)
    fs = (faultlib.sample_schedule(seed, N, dropout_frac=0.4, drop_tick=5,
                                   rejoin_tick=25, device=DEV, dtype=DT)
          if faulted else staging.cached_no_faults(N, DT, DEV))
    scen = scenreg.sample("wind_gust", seed, N, device=DEV, dtype=DT,
                          horizon=60)
    q0 = torch.as_tensor(rng.normal(size=(N, 3)), dtype=DT)
    st = staging.init_row(q0, fs, scen)
    st.tick = tick
    fm = types.make_formation(rng.normal(size=(N, 3)),
                              np.ones((N, N)) - np.eye(N),
                              rng.normal(size=(N, N, 3, 3)) * 0.01,
                              device=DEV, dtype=DT)
    return st, fm


def _same(a, b) -> bool:
    """Every leaf (tensors, ticks) equal in dtype, shape and bits, and the
    scenarios' host copies equal."""
    la, lb = ckpt.tree_arrays(a), ckpt.tree_arrays(b)
    if len(la) != len(lb) or not all(
            x.dtype == y.dtype and np.array_equal(x, y)
            for x, y in zip(la, lb)):
        return False
    sa = [s.scenario for s in (a if isinstance(a, tuple) else (a,))
          if isinstance(s, sim.SimState) and s.scenario is not None]
    sb = [s.scenario for s in (b if isinstance(b, tuple) else (b,))
          if isinstance(s, sim.SimState) and s.scenario is not None]
    for x, y in zip(sa, sb):
        hx, hy = scenlib.host_view(x), scenlib.host_view(y)
        if hx.keys() != hy.keys() or not all(
                np.array_equal(hx[k], hy[k]) for k in hx):
            return False
    return True


def _store(rows, cap):
    st = staging.BucketStaging()
    st.create(rows[0], cap)
    for slot, row in enumerate(rows):
        staging.write_row(st.store, row, slot)
    return st


def test_write_then_gather_equals_plain_stacking():
    rows = [_row(s, faulted=s % 2 == 0, tick=20 * s) for s in range(3)]
    st = _store(rows, 4)
    assert st.capacity == 4 and st.free_slots() == [0, 1, 2, 3]
    idx = (2, 0, 1, 2)                     # a padded, reordered batch
    got = staging.gather_rows(st.store, idx)
    want = (sim.stack_states([rows[i][0] for i in idx]),
            types.stack([rows[i][1] for i in idx]))
    assert _same(got, want)
    assert list(got[0].tick) == [40, 0, 20, 40]


def test_gather_copies_the_store_keeps_its_rows():
    rows = [_row(s) for s in range(2)]
    st = _store(rows, 2)
    bst, _ = staging.gather_rows(st.store, (0, 1))
    bst.swarm.q.add_(1.0)
    assert _same(staging.take_row(st.store, 0), rows[0])


def test_scatter_rows_writes_the_live_rows_back():
    rows = [_row(s, tick=s) for s in range(3)]
    st = _store(rows, 4)
    g, sp = types.ControlGains(), staging.cached_sparams(DT, DEV)
    cfg = sim.SimConfig(assignment="sinkhorn", assign_every=10)
    bst, bfm = staging.gather_rows(st.store, (1, 2))
    out, _ = sim.batched_rollout(bst, bfm, g, sp, cfg, 10, None, 0)
    staging.scatter_rows(st.store[0], out, [1, 2], [0, 1])
    for slot, b in ((1, 0), (2, 1)):
        assert _same(staging.take_row(st.store, slot)[0], sim.trial(out, b))
    assert _same(staging.take_row(st.store, 0), rows[0])    # untouched
    assert list(st.store[0].tick[:3]) == [0, 11, 12]


def test_take_row_equals_the_written_row_and_is_a_copy():
    rows = [_row(s, tick=7 * s) for s in range(2)]
    st = _store(rows, 2)
    row_s, row_f = staging.take_row(st.store, 1)
    assert _same((row_s, row_f), rows[1]) and row_s.tick == 7
    staging.write_row(st.store, rows[0], 1)          # slot reused
    assert _same((row_s, row_f), rows[1])            # the copy stands
    assert _same(staging.take_row(st.store, 1), rows[0])


def test_take_state_row_of_a_batch_output():
    rows = [_row(s) for s in range(2)]
    bst = sim.stack_states([r[0] for r in rows])
    for b in range(2):
        got = staging.take_state_row(bst, b)
        assert _same(got, rows[b][0])
        got.swarm.q.zero_()
        assert _same(sim.trial(bst, b), rows[b][0])


def test_unpack_round_is_request_major_and_contiguous():
    q_ticks = torch.as_tensor(np.random.default_rng(0).normal(
        size=(20, 4, N, 3)), dtype=DT)
    q_final = q_ticks[-1] + 1.0
    host = staging.unpack_round(q_ticks, q_final).get()
    legacy = q_ticks.numpy()
    for i in range(4):
        row = host["q_chunks"][i]
        assert row.flags["C_CONTIGUOUS"]
        assert row.tobytes() == np.ascontiguousarray(legacy[:, i]).tobytes()
    assert np.array_equal(host["q_final"], q_final.numpy())


def test_init_row_equals_init_state():
    fs = faultlib.sample_schedule(3, N, dropout_frac=0.4, drop_tick=5,
                                  device=DEV, dtype=DT)
    scen = staging.cached_no_scenario(N, DT, DEV)
    q0 = torch.as_tensor(np.random.default_rng(1).normal(size=(N, 3)),
                         dtype=DT)
    assert _same(staging.init_row(q0, fs, scen),
                 sim.init_state(q0.numpy(), faults=fs, scenario=scen,
                                device="cpu", dtype=DT))


def test_caches_key_on_size_dtype_and_device():
    f64 = staging.cached_default_formation(N, DT, DEV)
    assert staging.cached_default_formation(N, DT, "cpu") is f64
    f32 = staging.cached_default_formation(N, torch.float32, DEV)
    assert f32 is not f64 and f32.points.dtype == torch.float32
    assert staging.cached_default_formation(6, DT, DEV) is not f64
    assert set(staging._FORM_CACHE) == {(N, "float64", "cpu"),
                                        (N, "float32", "cpu"),
                                        (6, "float64", "cpu")}
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    pts = np.stack([3 * np.cos(ang), 3 * np.sin(ang), np.full(N, 2.0)], 1)
    fresh = types.make_formation(
        pts, np.ones((N, N)) - np.eye(N),
        np.eye(N)[:, :, None, None] * np.eye(3)[None, None] * 0.01,
        device=DEV, dtype=DT)
    assert _same(f64, fresh)
    assert _same(staging.cached_no_faults(N, DT, DEV),
                 faultlib.no_faults(N, device=DEV, dtype=DT))
    assert staging.cached_no_faults(N, DT, DEV) \
        is staging.cached_no_faults(N, DT, "cpu")
    assert _same(staging.cached_no_scenario(N, DT, DEV),
                 scenlib.no_scenario(N, device=DEV, dtype=DT))
    sp = staging.cached_sparams(DT, DEV)
    assert sp is staging.cached_sparams(DT, "cpu")
    assert (sp.bounds_min, sp.bounds_max) == ((-50.0, -50.0, 0.0),
                                              (50.0, 50.0, 10.0))


def test_index_tensors_are_cached_int64_on_the_device():
    t = staging.i32((3, 1), DEV)
    assert t.dtype == torch.int64 and t.tolist() == [3, 1]
    assert staging.i32([3, 1], "cpu") is t
    assert staging.i32(2, DEV).tolist() == [2]
    assert [staging.pow2(k) for k in (0, 1, 2, 3, 4, 5, 8)] \
        == [1, 1, 2, 4, 4, 8, 8]
