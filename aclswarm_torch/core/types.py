"""Core state containers (port of `aclswarm_tpu/core/types.py`).

Conventions are the reference's:
- positions/velocities are ``(n, 3)`` tensors in *vehicle order*;
- the adjacency matrix is an ``(n, n)`` {0,1} mask over *formation points*;
- gains are ``(n, n, 3, 3)`` blocks; the flat ``(3n, 3n)`` GainMat is
  `gains_to_flat`/`gains_from_flat`.

Every constructor takes ``device=`` and ``dtype=``: ``device=None`` means
the card (`resolve_device`), ``dtype`` defaults to float32 (the main path)
and accepts float64 (the CPU parity tests).

A batch of B trials carries a leading ``(B,)`` axis on every tensor of a
container (`tree_map`, `stack`, `take_rows`); `make_formations` builds a
batched `Formation` from stacked rows and `set_row` rewrites one trial's
row in place at a dispatch.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; raises instead of silently running on the
    CPU when there is none. Pass ``device="cpu"`` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "aclswarm_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def as_float(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """Host data (numpy, lists, tensors) -> a float tensor on ``device``."""
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


@dataclass
class SwarmState:
    """Batched swarm state, vehicle order."""

    q: torch.Tensor    # (n, 3) positions
    vel: torch.Tensor  # (n, 3) velocities

    @property
    def n(self) -> int:
        return self.q.shape[0]


@dataclass
class Formation:
    """A desired formation: points + graph + gains + desired distances."""

    points: torch.Tensor    # (n, 3) desired formation points
    adjmat: torch.Tensor    # (n, n) {0,1} adjacency over formation pts
    gains: torch.Tensor     # (n, n, 3, 3) gain blocks, formation space
    dstar_xy: torch.Tensor  # (n, n) pairwise desired xy distances
    dstar_z: torch.Tensor   # (n, n) pairwise desired |z| distances

    @property
    def n(self) -> int:
        return self.points.shape[0]


@dataclass(frozen=True)
class ControlGains:
    """Scalar control-law gains (reference SIL defaults)."""

    K1_xy: float = 0.1
    K2_xy: float = 0.1
    K1_z: float = 0.5
    K2_z: float = 0.3
    e_xy_thr: float = 0.3
    e_z_thr: float = 0.1
    kp: float = 1.5
    kd: float = 0.5


@dataclass
class SafetyParams:
    """Safety-node parameters; field meanings and defaults as in the
    reference `SafetyParams`. Every field is host data: the room bounds
    are (x, y, z) tuples, put on the card per use by
    `control.safety.host_row` without a host-to-device copy."""

    bounds_min: tuple = (0.0, 0.0, 0.0)
    bounds_max: tuple = (1.0, 1.0, 1.0)
    spinup_time: float = 2.0
    takeoff_inc: float = 0.0035
    takeoff_alt: float = 1.0
    takeoff_rel: bool = True
    landing_fast_threshold: float = 0.400
    landing_fast_dec: float = 0.0035
    landing_slow_dec: float = 0.001
    max_accel_xy: float = 0.5
    max_accel_z: float = 0.8
    max_vel_xy: float = 0.5
    max_vel_z: float = 0.3
    d_avoid_thresh: float = 1.5
    r_keep_out: float = 1.2
    keepout_repulse_vel: float = 0.0
    colavoid_dz_ignore: float = 0.0

    def __post_init__(self):
        self.bounds_min = tuple(float(v) for v in self.bounds_min)
        self.bounds_max = tuple(float(v) for v in self.bounds_max)


def gains_to_flat(gains: torch.Tensor) -> torch.Tensor:
    """(n, n, 3, 3) block gains -> (3n, 3n) flat GainMat (reference layout)."""
    n = gains.shape[0]
    return gains.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)


def gains_from_flat(flat: torch.Tensor) -> torch.Tensor:
    """(3n, 3n) flat GainMat -> (n, n, 3, 3) block gains."""
    n = flat.shape[0] // 3
    return flat.reshape(n, 3, n, 3).permute(0, 2, 1, 3).contiguous()


def make_formation(points, adjmat, gains=None, device=None,
                   dtype=torch.float32) -> Formation:
    """Build a `Formation`, precomputing the desired-distance matrices
    (dstar_xy = pdist of xy coords, dstar_z = pdist of z coords)."""
    from aclswarm_torch.core import geometry

    points = as_float(points, device, dtype)
    adjmat = as_float(adjmat, points.device, dtype)
    n = points.shape[0]
    if gains is None:
        gains = torch.zeros((n, n, 3, 3), dtype=dtype, device=points.device)
    else:
        gains = as_float(gains, points.device, dtype)
        if gains.ndim == 2:
            gains = gains_from_flat(gains)
    return Formation(points=points, adjmat=adjmat, gains=gains,
                     dstar_xy=geometry.pdistmat(points[:, :2]),
                     dstar_z=geometry.pdistmat(points[:, 2:3]))


def tree_map(fn, tree, *rest):
    """``fn`` over every tensor of a container tree (dataclasses, named
    tuples, None) and the same-shaped ``rest``; other leaves (host ints and
    arrays, such as a state's tick) are taken from ``tree`` unchanged."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if is_dataclass(tree):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name),
                                              *(getattr(r, f.name)
                                                for r in rest))
                             for f in fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return tree


def stack(trees: list):
    """B same-shaped containers -> one with a leading (B,) trial axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def take_rows(tree, idx: torch.Tensor):
    """The trials ``idx`` ((k,) int64 on the tensors' device) of a batched
    container, in that order: one `index_select` per tensor."""
    return tree_map(lambda x: x.index_select(0, idx), tree)


def row(tree, b: int):
    """Trial ``b`` of a batched container, unbatched (views)."""
    return tree_map(lambda x: x[b], tree)


def set_row(tree, b: int, new) -> None:
    """Overwrite trial ``b`` of a batched container with the unbatched
    ``new``, in place (a dispatch's formation commit)."""
    tree_map(lambda x, y: x[b].copy_(y), tree, new)


def make_formations(points, adjmat, gains=None, device=None,
                    dtype=torch.float32) -> Formation:
    """A batched `Formation`: `make_formation` over the stacked rows
    ``points`` (B, n, 3), ``adjmat`` (B, n, n) and ``gains`` (B, n, n, 3, 3)
    or (B, 3n, 3n) (None = zero gains), so each row's desired distances
    are the single formation's bit for bit."""
    return stack([make_formation(points[b], adjmat[b],
                                 None if gains is None else gains[b],
                                 device=device, dtype=dtype)
                  for b in range(len(points))])
