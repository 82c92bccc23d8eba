"""Auction record/replay: deterministic cross-validation of the device CBAA
(port of `aclswarm_tpu/assignment/replay.py`).

The reference's answer to "how do you test a distributed algorithm
deterministically" (SURVEY.md §4.2): the C++ auctioneer dumps every accepted
assignment as a binary record {n, q, adjmat, sigma1, p, aligned, sigma2}
(`auctioneer.cpp:577-597` logAssignment) and `matlab/test_alignment.m:14-31`
reloads it, re-runs the sequential MATLAB CBAA on the same inputs, and
compares. Here:

- `record_auctions` extracts the same records from a recorded rollout
  (`sim.rollout` metrics carry per-tick q and v2f, so the auction inputs at
  tick t are the previous tick's outputs);
- `save_records`/`load_records` persist them (npz, field for field the
  reference package's format: each package reads the other's files);
- `replay_record` re-runs both the sequential NumPy oracle
  (`assignment.cbaa_ref`) and the port's CBAA (`assignment.cbaa`, on the
  CUDA card unless ``device`` names another) on the recorded inputs and
  compares their decisions.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from aclswarm_torch.utils.host import to_host


@dataclasses.dataclass
class AuctionRecord:
    """One auction event (the logAssignment fields, `auctioneer.cpp:577-597`:
    n, q, adjmat, sigma1=P_prev, p, aligned, sigma2=result)."""

    q: np.ndarray        # (n, 3) swarm positions at auction start
    points: np.ndarray   # (n, 3) formation points
    adjmat: np.ndarray   # (n, n)
    v2f_prev: np.ndarray  # (n,) sigma1: assignment before the auction
    v2f_new: np.ndarray  # (n,) sigma2: assignment after


def record_auctions(metrics, q0, v2f0, formation) -> list[AuctionRecord]:
    """Extract auction events from rollout metrics (`sim.StepMetrics`
    stacked over time, on any device; host copies are made once).

    The engine auctions on the pre-step state, so the inputs of an auction
    at tick t are the tick t-1 outputs (q0/v2f0 for t = 0).
    """
    auctioned = to_host(metrics.auctioned)
    q = to_host(metrics.q)
    v2f = to_host(metrics.v2f)
    points = to_host(formation.points)
    adjmat = to_host(formation.adjmat)
    out = []
    for t in np.nonzero(auctioned)[0]:
        q_in = q[t - 1] if t > 0 else to_host(q0)
        v2f_in = v2f[t - 1] if t > 0 else to_host(v2f0)
        out.append(AuctionRecord(q=q_in, points=points, adjmat=adjmat,
                                 v2f_prev=v2f_in, v2f_new=v2f[t]))
    return out


def save_records(records: list[AuctionRecord], path: str | Path) -> None:
    arrays = {}
    for k, r in enumerate(records):
        for f in dataclasses.fields(AuctionRecord):
            arrays[f"{k}_{f.name}"] = to_host(getattr(r, f.name))
    np.savez_compressed(path, n_records=len(records), **arrays)


def load_records(path: str | Path) -> list[AuctionRecord]:
    data = np.load(path)
    out = []
    for k in range(int(data["n_records"])):
        out.append(AuctionRecord(**{
            f.name: data[f"{k}_{f.name}"]
            for f in dataclasses.fields(AuctionRecord)}))
    return out


def replay_device(rec: AuctionRecord, device=None):
    """The port's CBAA (`cbaa_from_state`, its defaults) on the record's
    inputs, in the record's float dtype, on ``device`` (None = the CUDA
    card). Returns the `CBAAResult`."""
    import torch

    from aclswarm_torch.assignment import cbaa
    from aclswarm_torch.core.types import resolve_device

    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(rec.q), device=dev)
    return cbaa.cbaa_from_state(
        q, torch.as_tensor(np.asarray(rec.points), dtype=q.dtype, device=dev),
        torch.as_tensor(np.asarray(rec.adjmat), dtype=q.dtype, device=dev),
        torch.as_tensor(np.asarray(rec.v2f_prev), dtype=torch.int32,
                        device=dev))


def replay_record(rec: AuctionRecord, device=None) -> dict:
    """Replay one record through the sequential oracle and the port's CBAA
    on ``device`` (None = the CUDA card); returns both results plus
    agreement flags."""
    from aclswarm_torch.assignment import cbaa_ref
    from aclswarm_torch.core.types import resolve_device

    device = resolve_device(device)      # no card: raise before the oracle
    oracle = cbaa_ref.cbaa_oracle(rec.q, rec.points, rec.adjmat,
                                  rec.v2f_prev)
    dev = replay_device(rec, device)
    dev_f2v = to_host(dev.f2v)
    dev_valid = bool(dev.valid)
    return {
        "oracle": oracle,
        "device_f2v": dev_f2v,
        "device_valid": dev_valid,
        "match": (dev_valid == oracle["valid"]
                  and (not dev_valid
                       or np.array_equal(dev_f2v, oracle["f2v"]))),
    }
