"""Rollout visualization: the `viz_commands.py` rviz pipeline, offline
(port of `aclswarm_tpu/harness/viz.py`).

The reference's only debugging view is rviz markers published live by
`aclswarm/nodes/viz_commands.py`: blue `distcmd` arrows, red safe-command
arrows, black spheres for the centrally-aligned desired formation, quad
meshes (`viz_commands.py:36-50`, README.md:97-100). A rollout is a
stacked tensor, not a live topic stream, so the equivalent here is a
matplotlib renderer over recorded `StepMetrics`: swarm trajectories,
the aligned desired formation with its adjacency edges, per-vehicle
command arrows at a chosen tick, and the supervisor's observable
time-series (|distcmd|, collision-avoidance activity). Headless by
default (Agg backend) — every figure goes to a file, the analogue of
"look at rviz". The metrics may be tensors on any device (`sim.rollout`'s
stacked `StepMetrics`) or host arrays; matplotlib is imported only when a
figure is drawn (`_mpl`).

Usage:
    from aclswarm_torch.harness import viz
    viz.plot_rollout(metrics, formation, out="rollout.png")
    viz.plot_timeseries(metrics, out="signals.png", dt=0.01)
"""
from __future__ import annotations

import numpy as np

from aclswarm_torch.utils.host import to_host


def _mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def aligned_formation(q, points, v2f) -> np.ndarray:
    """Centrally-aligned desired formation (the black spheres of
    `viz_commands.py`, which reuse `assignment.py`'s global alignment):
    formation points mapped into the world by the d=2 Arun fit against the
    current swarm, ordered by vehicle. Host arrays in (tensors are copied
    to the host), a host array out; the fit runs in the inputs' float
    dtype on the CPU."""
    import torch

    from aclswarm_torch.core import geometry
    from aclswarm_torch.core import perm as permutil

    q = torch.as_tensor(to_host(q))
    v2f = torch.as_tensor(to_host(v2f).astype(np.int32))
    q_form = permutil.veh_to_formation_order(q, v2f)
    aligned = geometry.align(torch.as_tensor(to_host(points), dtype=q.dtype),
                             q_form, d=2)
    return to_host(aligned)[to_host(v2f)]        # vehicle order


def plot_rollout(metrics, formation, out: str, tick: int = -1,
                 trail: int = 400, elev: float = 35, azim: float = -60):
    """3D view at one tick: trajectories (trail), vehicles, the aligned
    desired formation + graph edges, and distcmd arrows."""
    plt = _mpl()
    q_all = to_host(metrics.q)                   # (T, n, 3)
    T, n, _ = q_all.shape
    t = tick % T
    q = q_all[t]
    v2f = to_host(metrics.v2f)[t]
    pts = to_host(formation.points)
    adj = to_host(formation.adjmat)
    goal = aligned_formation(q, pts, v2f)

    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    t0 = max(0, t - trail)
    for v in range(n):
        ax.plot(*q_all[t0:t + 1, v].T, lw=0.8, alpha=0.5, color=f"C{v % 10}")
        ax.scatter(*q[v], s=40, color=f"C{v % 10}")
    # desired formation: black markers + graph edges (viz_commands.py:36-50)
    ax.scatter(*goal.T, s=60, facecolors="none", edgecolors="k",
               label="aligned formation")
    for i in range(n):
        for j in range(i + 1, n):
            if adj[int(v2f[i]), int(v2f[j])]:
                seg = np.stack([goal[i], goal[j]])
                ax.plot(*seg.T, color="k", lw=0.5, alpha=0.3)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.set_title(f"tick {t} / {T}")
    ax.legend(loc="upper left", fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def plot_timeseries(metrics, out: str, dt: float = 0.01):
    """The supervisor's observables over time: per-vehicle |distcmd| (its
    convergence predicate input) and collision-avoidance activity (its
    gridlock predicate input), plus assignment-change events."""
    plt = _mpl()
    dn = to_host(metrics.distcmd_norm)           # (T, n)
    ca = to_host(metrics.ca_active)              # (T, n)
    re = to_host(metrics.reassigned)             # (T,)
    tt = np.arange(dn.shape[0]) * dt

    fig, axes = plt.subplots(2, 1, figsize=(9, 6), sharex=True)
    axes[0].plot(tt, dn, lw=0.6, alpha=0.6)
    axes[0].plot(tt, dn.mean(1), "k", lw=1.5, label="mean")
    axes[0].axhline(1.0, color="r", ls="--", lw=0.8,
                    label="convergence threshold")
    axes[0].set_ylabel("|distcmd| [m/s]")
    axes[0].legend(fontsize=8)
    axes[1].plot(tt, ca.mean(1), lw=1.0, label="CA-active fraction")
    for te in tt[re]:
        axes[1].axvline(te, color="g", lw=0.6, alpha=0.5)
    axes[1].set_ylabel("collision avoidance")
    axes[1].set_xlabel("t [s]")
    axes[1].set_ylim(-0.05, 1.05)
    axes[1].legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out
