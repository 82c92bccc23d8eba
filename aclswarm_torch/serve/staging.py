"""Device-bound serve rounds: per-bucket staging stores, submit-time row
prep and a batched unpack (port of `aclswarm_tpu/serve/staging.py`).

A round of the pack-at-round-time path (``ServiceConfig(staging=False)``)
stacks every job's state and formation leaf by leaf, slices the output
batch back job by job, and builds each problem when its job is first
picked. This module moves all three off the round:

- **staging stores**: each (worker, shape bucket) keeps one resident
  batched container, ``(SimState rows, Formation rows)``, allocated once
  on the worker's device at a fixed capacity (`BucketStaging.create`). A
  request joins it with one in-place `write_row` (``index_copy_`` on every
  tensor), the round's batch is one `gather_rows` (``index_select``
  copies of the live slots), and the round's output rows go back with
  one in-place `scatter_rows`;
- **submit-time prep**: admission builds the request's initial row
  (`init_row`) when it accepts the request, with the default formation,
  safety parameters, empty fault schedule and inert scenario cached per
  (n, dtype, device);
- **batched unpack**: `unpack_round` lays the chunk's positions out
  request by request beside the final positions in one device buffer and
  starts one ``non_blocking`` device-to-host copy of it into pinned
  memory, ended by a CUDA event: a round's host read is that one copy.

Host data rides beside the tensors: a row's tick (a host int, the
decimation phase of its trial) and its scenario's host copy of the onsets
(`scenarios.timeline.host_view`) are written, gathered and read out with
the row.

Ordering contract (`serve.service` owns the locking): a store is mutated
only by the owning worker thread, under the service lock after re-checking
the worker's fence. Every worker of a service launches on the device's
one default stream, so a round's gather, rollout, scatter and copy run in
issue order: a store is never read while a round that writes it is still
in flight, without the reference's buffer donation.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from aclswarm_torch import sim
from aclswarm_torch.core import types
from aclswarm_torch.scenarios import timeline as scenlib

__all__ = ["BucketStaging", "HostRead", "i32", "write_row", "gather_rows",
           "scatter_rows", "take_row", "take_state_row", "unpack_round",
           "init_row", "cached_default_formation", "cached_sparams",
           "cached_no_faults", "cached_no_scenario", "clear_caches",
           "pow2"]


def pow2(k: int) -> int:
    """Smallest power of two >= max(1, k): the padded batch of a round
    (both round paths pad alike, so a batch's composition, and with it
    the card's rounding, is the same on either)."""
    p = 1
    while p < max(1, k):
        p *= 2
    return p


# index tensors, cached: the slot vocabulary is tiny (store capacity and
# padded batch size), and each fresh tensor would be a host-to-device copy
_IDX_LOCK = threading.Lock()
_IDX_CACHE: dict = {}
_IDX_CACHE_MAX = 4096


def i32(value, device) -> torch.Tensor:
    """A cached (k,) index tensor of the slots ``value`` (an int or a
    sequence of ints) on ``device``. Named after the reference's int32
    index constants; the port's are int64, as ``index_select`` and
    ``index_copy_`` take them."""
    vals = (tuple(int(v) for v in value)  # torchcheck: disable=JC001 host slot numbers
            if isinstance(value, (list, tuple)) else (int(value),))  # torchcheck: disable=JC001 host slot numbers
    key = (vals, str(torch.device(device)))
    with _IDX_LOCK:
        t = _IDX_CACHE.get(key)
    if t is not None:
        return t
    t = torch.tensor(vals, dtype=torch.int64, device=device)
    with _IDX_LOCK:
        if len(_IDX_CACHE) >= _IDX_CACHE_MAX:
            _IDX_CACHE.clear()      # tiny tensors: rebuilding is cheap
        return _IDX_CACHE.setdefault(key, t)


# ---------------------------------------------------------------------------
# staging ops

def _device_of(state: sim.SimState) -> torch.device:
    return state.swarm.q.device


def write_row(store, row, slot: int):  # torchcheck: device-path
    """Write one request's prepared ``row`` (state, formation) into the
    store at ``slot``, in place: one ``index_copy_`` per tensor, the tick
    and the scenario's host copy beside them. Returns the store."""
    st, fm = store
    rst, rfm = row
    idx = i32(slot, _device_of(st))
    types.tree_map(lambda b, r: b.index_copy_(0, idx, r.unsqueeze(0)),
                   st, rst)
    types.tree_map(lambda b, r: b.index_copy_(0, idx, r.unsqueeze(0)),
                   fm, rfm)
    st.tick[slot] = rst.tick
    if st.scenario is not None:
        for k, v in scenlib.host_view(rst.scenario).items():
            st.scenario._host[k][slot] = v
    return store


def gather_rows(store, idx: tuple,  # torchcheck: device-path
                ) -> Tuple[sim.SimState, types.Formation]:
    """The round's batch: rows ``idx`` of the store in that order, as
    copies (``index_select``); the store keeps every row."""
    st, fm = store
    rows = list(idx)
    t = i32(rows, _device_of(st))
    bst = dataclasses.replace(types.take_rows(st, t),
                              tick=np.asarray(st.tick)[rows])
    if bst.scenario is not None:
        scenlib.take_host(st.scenario, rows, bst.scenario)
    return bst, types.take_rows(fm, t)


def scatter_rows(store_state: sim.SimState,  # torchcheck: device-path
                 out: sim.SimState,
                 slots: list, rows: list) -> sim.SimState:
    """``store_state[slots[i]] = out[rows[i]]`` for every tensor and tick,
    in place. A scenario is a script a rollout never changes, so its host
    copy in the store stays as written."""
    dev = _device_of(store_state)
    s_t, r_t = i32(slots, dev), i32(rows, dev)
    types.tree_map(lambda b, r: b.index_copy_(0, s_t, r.index_select(0, r_t)),
                   store_state, out)
    store_state.tick[list(slots)] = np.asarray(out.tick)[list(rows)]
    return store_state


def take_row(store, slot: int,  # torchcheck: device-path
             ) -> Tuple[sim.SimState, types.Formation]:
    """One resident row of the store, copied out (failover migration and
    re-staging across worker incarnations read a job's row with this)."""
    st, fm = store
    return (take_state_row(st, slot),
            types.tree_map(torch.clone, types.row(fm, slot)))


def take_state_row(state: sim.SimState, b: int) -> sim.SimState:
    """Trial ``b`` of a batched state as a serial state of copies (a row
    read out of a store must not alias a row that is rewritten)."""
    row = sim.trial(state, b)
    out = types.tree_map(torch.clone, row)
    if row.scenario is not None:
        out.scenario._host = {k: np.array(v) for k, v in  # torchcheck: disable=JC001 the host copy
                              scenlib.host_view(row.scenario).items()}
    return out


class HostRead:
    """One round's positions on their way to the host: the chunk's
    positions request by request, (P, T, n, 3), and the final positions,
    (P, n, 3), in one device buffer, copied with one ``non_blocking``
    device-to-host copy into pinned memory that a CUDA event ends. On the
    CPU the buffer is the host array itself."""

    def __init__(self, q_ticks: torch.Tensor, q_final: torch.Tensor):
        self._shapes = ((q_ticks.shape[1], q_ticks.shape[0])
                        + tuple(q_ticks.shape[2:]), tuple(q_final.shape))
        flat = torch.cat([q_ticks.transpose(0, 1).reshape(-1),
                          q_final.reshape(-1)])
        self._event = None
        if flat.is_cuda:
            self._host = torch.empty(flat.shape, dtype=flat.dtype,
                                     pin_memory=True)
            self._host.copy_(flat, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = flat

    def get(self) -> dict:
        """Wait for the copy; {"q_chunks": (P, T, n, 3), "q_final":
        (P, n, 3)} numpy arrays, each request's chunk contiguous."""
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        k = math.prod(self._shapes[0])
        return {"q_chunks": a[:k].reshape(self._shapes[0]),
                "q_final": a[k:].reshape(self._shapes[1])}


def unpack_round(q_ticks: torch.Tensor,  # torchcheck: device-path
                 q_final: torch.Tensor) -> HostRead:
    """Start the round's one host read (`HostRead`)."""
    return HostRead(q_ticks, q_final)


def init_row(q0: torch.Tensor, faults,  # torchcheck: device-path
             scenario) -> sim.SimState:
    """A serve request's initial state row: `sim.init_state` on ``q0``'s
    device and dtype with the request's fault schedule and scenario."""
    return sim.init_state(q0, faults=faults, scenario=scenario,
                          device=q0.device, dtype=q0.dtype)


# ---------------------------------------------------------------------------
# submit-time problem caches
#
# The default problem pieces are pure functions of (n, dtype, device):
# cached, they leave both the round path and the per-request submit path.
# Values equal a fresh construction bit for bit (same inputs, same ops).

_CACHE_LOCK = threading.Lock()
_FORM_CACHE: dict = {}
_SPARAMS_CACHE: dict = {}
_FAULTS_CACHE: dict = {}
_SCEN_CACHE: dict = {}


def _key(n: Optional[int], dtype, device) -> tuple:
    return (n, str(dtype).removeprefix("torch."), str(torch.device(device)))


def _cached(cache: dict, key: tuple, build):
    with _CACHE_LOCK:
        v = cache.get(key)
    if v is not None:
        return v
    v = build()
    with _CACHE_LOCK:
        return cache.setdefault(key, v)


def cached_default_formation(n: int, dtype, device) -> types.Formation:
    """The serve default formation (a circle of radius 3 at z=2, the
    complete graph, gains 0.01 I) for fleet size ``n``, shared read-only
    across requests."""
    def build():
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        pts = np.stack([3 * np.cos(ang), 3 * np.sin(ang),
                        np.full(n, 2.0)], 1)
        adj = np.ones((n, n)) - np.eye(n)
        gains = np.eye(n)[:, :, None, None] * np.eye(3)[None, None] * 0.01
        return types.make_formation(pts, adj, gains, device=device,
                                    dtype=dtype)
    return _cached(_FORM_CACHE, _key(int(n), dtype, device), build)


def cached_sparams(dtype, device) -> types.SafetyParams:
    """The serve safety parameters (a 100 m x 100 m x 10 m room). Host
    data in the port; cached per (dtype, device) as the reference caches
    its device copy per dtype."""
    return _cached(_SPARAMS_CACHE, _key(None, dtype, device),
                   lambda: types.SafetyParams(bounds_min=(-50.0, -50.0, 0.0),
                                              bounds_max=(50.0, 50.0, 10.0)))


def cached_no_faults(n: int, dtype, device):
    """The empty fault schedule every fault-free serve rollout carries:
    one container structure per bucket, so faulted and fault-free
    requests share a batch (`no_faults` equals ``faults=None`` bit for
    bit)."""
    from aclswarm_torch.faults import schedule as faultlib

    return _cached(_FAULTS_CACHE, _key(int(n), dtype, device),
                   lambda: faultlib.no_faults(n, device=device, dtype=dtype))


def cached_no_scenario(n: int, dtype, device):
    """The inert scenario every scenario-free serve rollout carries (the
    same normalization one axis up; `no_scenario` equals
    ``scenario=None`` bit for bit)."""
    return _cached(_SCEN_CACHE, _key(int(n), dtype, device),
                   lambda: scenlib.no_scenario(n, device=device,
                                               dtype=dtype))


def clear_caches() -> None:
    """Drop the problem and index caches."""
    with _CACHE_LOCK:
        for c in (_FORM_CACHE, _SPARAMS_CACHE, _FAULTS_CACHE, _SCEN_CACHE):
            c.clear()
    with _IDX_LOCK:
        _IDX_CACHE.clear()


# ---------------------------------------------------------------------------
# per-(worker, bucket) staging state

class BucketStaging:
    """One worker incarnation's resident batch for one shape bucket.

    ``store`` is the ``(state_rows, form_rows)`` container with a leading
    capacity axis; ``slots[i]`` names the `_Job` resident in row ``i``
    (None = free). ``shared`` is the bucket's ``(ControlGains,
    SafetyParams, SimConfig)``, the same for every request of the bucket
    by construction of the bucket key.

    Capacity is fixed at creation (the service uses ``2 *
    pow2(max_batch)``: one round in flight plus one being packed). When
    the store is full, the service evicts a resident that is neither live
    nor in flight back to a per-job row (`take_row`) and reuses its slot.
    The service mutates instances only from the owning worker thread under
    its lock; this class is data and slot arithmetic.
    """

    __slots__ = ("store", "slots", "shared")

    def __init__(self, shared=None):
        self.store: Optional[Tuple[Any, Any]] = None
        self.slots: List[Any] = []
        self.shared = shared

    @property
    def capacity(self) -> int:
        return len(self.slots)

    def occupied(self) -> int:
        return sum(1 for j in self.slots if j is not None)

    def free_slots(self) -> List[int]:
        return [i for i, j in enumerate(self.slots) if j is None]

    def create(self, row: Tuple[Any, Any], cap: int) -> None:
        """Allocate the store: zeros shaped like ``row`` with a leading
        ``cap`` axis, on the row's device (the worker's)."""
        st, fm = row

        def zeros(r):
            return torch.zeros((cap,) + tuple(r.shape), dtype=r.dtype,
                               device=r.device)

        zst = dataclasses.replace(types.tree_map(zeros, st),
                                  tick=np.zeros(cap, np.int64))
        if st.scenario is not None:
            zst.scenario._host = {
                k: np.zeros((cap,) + np.shape(v), np.asarray(v).dtype)
                for k, v in scenlib.host_view(st.scenario).items()}
        self.store = (zst, types.tree_map(zeros, fm))
        self.slots = [None] * cap
