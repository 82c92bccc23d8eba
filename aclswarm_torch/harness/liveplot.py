"""Live signal plots off the wire: the `rqt_multiplot` equivalent (port of
`aclswarm_tpu/harness/liveplot.py`).

The reference's live observability is two rqt_multiplot configs
(`aclswarm/cfg/multiplot_xyvel.xml`: per-vehicle x/y velocity commands
vs time; `multiplot_vehicletracker_sq01s.xml`: tracker estimate
positions) attached to the running ROS graph. The port's running
system is the bridge process (`aclswarm_torch.interop.bridge`) serving
the wire API, so the equivalent is a *wire-attached* consumer: this
module opens the `<ns>-distcmd` / `<ns>-safety` / `<ns>-estimates`
channels (read-only peer of the same rings the vehicles consume is not
possible on SPSC rings — so the bridge is pointed at a dedicated
namespace, or this plotter IS the consumer in an observation
deployment), maintains rolling time buffers, and re-renders the
multiplot panels (per-vehicle vx/vy, ca-active raster, xy estimate
traces) to an atomically-rewritten PNG on an interval — point any image
viewer that auto-reloads at the file and it behaves like the rqt
window.

Run (observing a bridge at /asw, writing live.png every 2 s; the shm
rings need the native library, `make -C native`):

    python -m aclswarm_torch.harness.liveplot --ns /asw --n 6 \
        --out live.png --interval 2 --duration 60

Library use (the tests drive this):

    lp = LivePlot(n=6, window_s=10.0)
    lp.ingest_distcmd(msg); lp.ingest_safety(msg); lp.ingest_estimates(msg)
    lp.render("frame.png")
"""
from __future__ import annotations

import argparse
import collections
import time
from typing import Optional

import numpy as np

from aclswarm_torch.interop import messages as m


class LivePlot:
    """Rolling-buffer multiplot state + renderer."""

    def __init__(self, n: int, window_s: float = 10.0,
                 expected_rate_hz: float = 100.0):
        self.n = n
        self.window_s = window_s
        cap = max(16, int(window_s * expected_rate_hz * 2))
        self._cmd = collections.deque(maxlen=cap)   # (stamp, (n, 3) vel)
        self._ca = collections.deque(maxlen=cap)    # (stamp, (n,) active)
        self._est = collections.deque(maxlen=cap)   # (stamp, (n, 3) pos)

    # -- ingestion (one call per decoded wire message) --------------------
    def ingest(self, msg) -> bool:
        """Route any supported wire message; returns False if unhandled."""
        if isinstance(msg, m.DistCmd):
            self.ingest_distcmd(msg)
        elif isinstance(msg, m.SafetyStatusArray):
            self.ingest_safety(msg)
        elif isinstance(msg, m.VehicleEstimates):
            self.ingest_estimates(msg)
        else:
            return False
        return True

    def ingest_distcmd(self, msg: m.DistCmd) -> None:
        self._cmd.append((msg.header.stamp, np.asarray(msg.vel)))

    def ingest_safety(self, msg: m.SafetyStatusArray) -> None:
        self._ca.append((msg.header.stamp, np.asarray(msg.active, bool)))

    def ingest_estimates(self, msg: m.VehicleEstimates) -> None:
        self._est.append((msg.header.stamp, np.asarray(msg.positions)))

    # -- window views -----------------------------------------------------
    def _window(self, buf):
        if not buf:
            return np.zeros((0,)), np.zeros((0, self.n, 0))
        t1 = buf[-1][0]
        ts, vals = zip(*[x for x in buf if x[0] >= t1 - self.window_s])
        return np.asarray(ts), np.stack(vals)

    # -- rendering --------------------------------------------------------
    def render(self, out: str) -> None:
        """One multiplot frame: per-vehicle vx/vy (`multiplot_xyvel.xml`),
        ca-active raster, and xy estimate traces
        (`multiplot_vehicletracker`)."""
        from aclswarm_torch.harness.viz import _mpl
        plt = _mpl()

        fig, axes = plt.subplots(2, 2, figsize=(11, 7))
        (ax_vx, ax_vy), (ax_ca, ax_xy) = axes

        ts, vel = self._window(self._cmd)
        if ts.size:
            for v in range(self.n):
                ax_vx.plot(ts, vel[:, v, 0], lw=0.8)
                ax_vy.plot(ts, vel[:, v, 1], lw=0.8)
        ax_vx.set_title("distcmd vx (m/s)")
        ax_vy.set_title("distcmd vy (m/s)")
        for ax in (ax_vx, ax_vy):
            ax.set_xlabel("t (s)")
            ax.grid(True, alpha=0.3)

        tc, ca = self._window(self._ca)
        if tc.size:
            ax_ca.imshow(ca.T, aspect="auto", interpolation="nearest",
                         extent=[tc[0], tc[-1], -0.5, self.n - 0.5],
                         origin="lower", cmap="Reds", vmin=0, vmax=1)
        ax_ca.set_title("collision avoidance active (per vehicle)")
        ax_ca.set_xlabel("t (s)")
        ax_ca.set_ylabel("vehicle")

        te, est = self._window(self._est)
        if te.size:
            for v in range(self.n):
                ax_xy.plot(est[:, v, 0], est[:, v, 1], lw=0.8)
            ax_xy.plot(est[-1, :, 0], est[-1, :, 1], "k.", ms=6)
        ax_xy.set_title("estimate traces (xy)")
        ax_xy.set_aspect("equal", adjustable="datalim")
        ax_xy.grid(True, alpha=0.3)

        fig.tight_layout()
        # atomic rewrite so a viewer polling the file never sees a
        # half-written image
        import os
        tmp = out + ".tmp.png"
        fig.savefig(tmp, dpi=110)
        plt.close(fig)
        os.replace(tmp, out)


def observe(ns: str, n: int, out: str, interval_s: float = 2.0,
            duration_s: float = 0.0, poll_s: float = 0.002,
            channels: Optional[dict] = None) -> int:
    """Consume wire traffic and re-render ``out`` every ``interval_s``.

    ``channels`` (tests) injects already-open channel objects keyed by
    'distcmd'/'safety'/'estimates'; by default the shm rings ``<ns>-*``
    are opened (this process must be THE consumer of those rings — SPSC).
    Returns the number of frames rendered.
    """
    if channels is None:
        from aclswarm_torch.interop.transport import Channel
        channels = {name: Channel(f"{ns}-{name}")
                    for name in ("distcmd", "safety", "estimates")}
    lp = LivePlot(n)
    frames = 0
    t_end = time.time() + duration_s if duration_s else None
    next_render = time.time() + interval_s
    while t_end is None or time.time() < t_end:
        progressed = False
        for ch in channels.values():
            msg = ch.recv()
            if msg is not None:
                lp.ingest(msg)
                progressed = True
        now = time.time()
        if now >= next_render:
            lp.render(out)
            frames += 1
            next_render = now + interval_s
        if not progressed:
            time.sleep(poll_s)
    lp.render(out)
    return frames + 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ns", default="/asw")
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--out", default="live.png")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=0.0,
                    help="seconds to observe (0 = forever)")
    args = ap.parse_args(argv)
    frames = observe(args.ns, args.n, args.out, args.interval,
                     args.duration)
    print(f"rendered {frames} frames to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
