"""The port's auction record/replay (`aclswarm_torch.assignment.replay`)
against the reference package's: records of the same seeded CBAA rollout
(float64, CPU), their replay through the sequential oracle and each
package's CBAA, and the npz files each package writes and the other
reads. Then the reference's `tests/test_replay.py` cases on the port:
the 100-auction cross-validation (slow, as there) and a quick version on
20 records."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aclswarm_torch import gains as t_gains
from aclswarm_torch import sim as t_sim
from aclswarm_torch.assignment import cbaa_ref as t_cbaa_ref
from aclswarm_torch.assignment import replay as t_replay
from aclswarm_torch.core.types import ControlGains, SafetyParams
from aclswarm_torch.core.types import make_formation as t_make_formation
from aclswarm_torch.harness import formgen as t_formgen
from aclswarm_tpu import sim as j_sim
from aclswarm_tpu.assignment import replay as j_replay
from aclswarm_tpu.core.types import ControlGains as JControlGains
from aclswarm_tpu.core.types import SafetyParams as JSafetyParams
from aclswarm_tpu.core.types import make_formation as j_make_formation
from aclswarm_tpu.gains import reference as j_reference

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

F64 = dict(device="cpu", dtype=torch.float64)
FIELDS = [f.name for f in dataclasses.fields(t_replay.AuctionRecord)]


def _problem(seed, n, fc):
    rng = np.random.default_rng(seed)
    adj = t_formgen.random_adjmat(np.random.default_rng(seed), n, fc=fc)
    pts = t_formgen.sample_cylinder_points(rng, n, 12, 12, 2, min_dist=2.0)
    q0 = rng.normal(size=(n, 3)) * 4 + [0, 0, 3]
    return pts, adj, q0


def _port_records(seed, n=7, fc=False, ticks=600, assign_every=30,
                  gains=None):
    """`tests/test_replay.py::_rollout_records` on the port (float64,
    CPU), the gains designed by the port's ADMM unless given."""
    pts, adj, q0 = _problem(seed, n, fc)
    if gains is None:
        gains = t_gains.solve_gains_blocks(pts, adj, device="cpu")
    f = t_make_formation(pts, adj, gains, **F64)
    sp = SafetyParams(bounds_min=(-50.0, -50.0, 0.0),
                      bounds_max=(50.0, 50.0, 20.0))
    cfg = t_sim.SimConfig(assignment="cbaa", assign_every=assign_every)
    _, m = t_sim.rollout(t_sim.init_state(q0, **F64), f, ControlGains(), sp,
                         cfg, ticks)
    return t_replay.record_auctions(m, q0, np.arange(n), f)


def _ref_records(seed, n, fc, ticks, gains, assign_every=30):
    pts, adj, q0 = _problem(seed, n, fc)
    f = j_make_formation(pts, adj, gains)
    sp = JSafetyParams(bounds_min=jnp.asarray([-50.0, -50.0, 0.0]),
                       bounds_max=jnp.asarray([50.0, 50.0, 20.0]))
    cfg = j_sim.SimConfig(assignment="cbaa", assign_every=assign_every)
    _, m = j_sim.rollout(j_sim.init_state(q0), f, JControlGains(), sp, cfg,
                         ticks)
    return j_replay.record_auctions(m, q0, np.arange(n), f)


@pytest.fixture(scope="module")
def both_records():
    """The reference's `test_record_roundtrip` rollout (seed 9, n=6, 200
    ticks) in both packages, on one set of gains (the NumPy oracle's)."""
    pts, adj, _ = _problem(9, 6, False)
    A = j_reference.solve_gains(pts, adj)
    return (_port_records(9, n=6, ticks=200, gains=A),
            _ref_records(9, 6, False, 200, A))


def test_records_equal_the_references(both_records):
    """Discrete fields equal, positions within 1e-12 (float64)."""
    port, ref = both_records
    assert len(port) == len(ref) == 7
    for a, b in zip(port, ref):
        for k in ("points", "adjmat", "v2f_prev", "v2f_new"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=k)
            assert getattr(a, k).dtype == np.asarray(getattr(b, k)).dtype, k
        np.testing.assert_allclose(a.q, b.q, rtol=0, atol=1e-12)


def test_replay_agrees_with_the_references(both_records):
    port, ref = both_records
    for a, b in zip(port, ref):
        got = t_replay.replay_record(a, device="cpu")
        want = j_replay.replay_record(b)
        assert got["match"] and want["match"]
        assert got["device_valid"] == want["device_valid"]
        np.testing.assert_array_equal(got["device_f2v"], want["device_f2v"])
        for k in ("v2f", "f2v", "valid"):
            np.testing.assert_array_equal(got["oracle"][k],
                                          want["oracle"][k])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_npz_loads_in_the_other_package(both_records, tmp_path, writer):
    port, ref = both_records
    path = tmp_path / "auctions.npz"
    if writer == "port":
        t_replay.save_records(port, path)
        loaded, want = j_replay.load_records(path), port
    else:
        j_replay.save_records(ref, path)
        loaded, want = t_replay.load_records(path), ref
    assert len(loaded) == len(want)
    for a, b in zip(loaded, want):
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(a, k),
                                          np.asarray(getattr(b, k)))
            assert getattr(a, k).dtype == np.asarray(getattr(b, k)).dtype


def test_record_roundtrip(both_records, tmp_path):
    port, _ = both_records
    path = tmp_path / "auctions.npz"
    t_replay.save_records(port, path)
    loaded = t_replay.load_records(path)
    assert len(loaded) == len(port)
    for a, b in zip(port, loaded):
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_records_from_tensors():
    """`record_auctions` takes the port's metrics as tensors, and
    `save_records` tensors too."""
    n = 3
    m = t_sim.StepMetrics(
        distcmd_norm=torch.zeros(4, n), ca_active=torch.zeros(4, n,
                                                             dtype=bool),
        assign_valid=torch.ones(4, dtype=bool),
        reassigned=torch.zeros(4, dtype=bool),
        auctioned=torch.tensor([True, False, True, False]),
        q=torch.arange(4 * n * 3, dtype=torch.float64).reshape(4, n, 3),
        mode=torch.zeros(4, n, dtype=torch.int32),
        v2f=torch.tensor([[0, 1, 2], [0, 1, 2], [2, 1, 0], [2, 1, 0]],
                         dtype=torch.int32))
    f = t_make_formation(np.eye(3), np.ones((3, 3)) - np.eye(3), **F64)
    recs = t_replay.record_auctions(m, np.full((n, 3), -1.0), np.arange(n),
                                    f)
    assert len(recs) == 2
    np.testing.assert_array_equal(recs[0].q, np.full((n, 3), -1.0))
    np.testing.assert_array_equal(recs[1].q, m.q[1].numpy())
    np.testing.assert_array_equal(recs[1].v2f_new, [2, 1, 0])
    assert all(isinstance(getattr(r, k), np.ndarray)
               for r in recs for k in FIELDS)


def _cross_validate(records):
    n_valid = 0
    for rec in records:
        out = t_replay.replay_record(rec, device="cpu")
        assert out["match"], rec
        # a valid auction's result is what the engine adopted
        if out["device_valid"]:
            n_valid += 1
            v2f = np.empty(len(rec.v2f_prev), dtype=int)
            v2f[out["device_f2v"]] = np.arange(len(rec.v2f_prev))
            np.testing.assert_array_equal(v2f, rec.v2f_new)
    assert n_valid >= 0.9 * len(records), (n_valid, len(records))


def test_replay_twenty_recorded_auctions():
    """The quick form of the reference's 100-auction test: 20 auctions
    of one sparse-graph rollout (seed 1), every decision equal to the
    sequential oracle's and to what the engine adopted."""
    records = _port_records(1)
    assert len(records) == 20
    _cross_validate(records)


@pytest.mark.slow
def test_replay_hundred_recorded_auctions():
    """`tests/test_replay.py::test_replay_hundred_recorded_auctions` on the
    port: >= 100 auctions from six rollouts (sparse and complete
    graphs)."""
    records = []
    for seed in range(6):
        records += _port_records(seed, fc=(seed % 2 == 0))
    assert len(records) >= 100, len(records)
    _cross_validate(records)


def test_oracle_standalone_sanity():
    """The port's oracle alone: valid permutation on a clean instance, and
    the nearest-assignment structure on a well-separated swarm."""
    n = 5
    rng = np.random.default_rng(0)
    pts = np.stack([np.arange(n) * 5.0, np.zeros(n), np.zeros(n)], 1)
    q = pts + rng.normal(size=(n, 3)) * 0.1
    out = t_cbaa_ref.cbaa_oracle(q, pts, np.ones((n, n)) - np.eye(n),
                                 np.arange(n))
    assert out["valid"]
    np.testing.assert_array_equal(out["v2f"], np.arange(n))
