"""Operator / base station over the wire boundary (port of
`aclswarm_tpu/interop/operator.py`).

The aclswarm operator is a Python base-station node: it loads a formation
group, manages the flight-mode service (START while flying cycles to the
next formation, END lands, KILL cuts motors — `aclswarm/nodes/operator.py
:118-136`), and publishes `Formation` messages with or without precomputed
gains (`buildFormationMessage`, `:138-213`).

This module is the same role, ROS-free: an `Operator` that implements the
full flight-mode service (`srvCB`, `operator.py:117-135`) — START takes
off or cycles formations, END lands, KILL e-stops — broadcasting wire
`FlightMode` messages and emitting `Formation` dispatches into transport
channels (or any callable sinks). Entry point:

    python -m aclswarm_torch.interop.operator --group swarm6_3d \
        --channel /asw-formation --mode-channel /asw-flightmode \
        --dispatch 2

publishes the group's formations (cycling on each --dispatch, period in
seconds) to a planner/bridge process listening on the channel.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np

from aclswarm_torch.interop import messages as m


class Operator:
    """Formation dispatch with the aclswarm operator's cycling semantics.

    ``send`` is any sink accepting a wire message (e.g. a transport
    `Channel.send`); ``send_gains`` mirrors the operator's option to ship
    precomputed library gains or let vehicles solve on commit
    (`operator.py:184-210`, README FAQ).
    """

    def __init__(self, group: str, library: Optional[str] = None,
                 send_gains: bool = True):
        from aclswarm_torch.harness import formations as formlib
        self.specs = formlib.load_group(library, group)
        self.group = group
        self.send_gains = send_gains
        self.idx = -1            # START cycles to the next formation
        self.seq = 0
        self.flying = False      # NOT_FLYING/FLYING (`operator.py:83`)
        self._last_P: Optional[np.ndarray] = None   # `operator.py:66`

    @property
    def n(self) -> int:
        return self.specs[0].n

    def next_formation(self, stamp: float = 0.0) -> m.Formation:
        """The START-while-flying action: advance the cycle and build the
        Formation message (`operator.py:128-134,138-153`)."""
        self.idx = (self.idx + 1) % len(self.specs)
        spec = self.specs[self.idx]
        self.seq += 1
        msg = m.formation_from_spec(spec, seq=self.seq, stamp=stamp)
        if not self.send_gains:
            msg.gains = None
        return msg

    def dispatch(self, send: Callable[[object], object],
                 stamp: float = 0.0) -> m.Formation:
        msg = self.next_formation(stamp)
        send(msg)
        return msg

    # -- centralized-comparison assignment (`operator.py:221-246`) --------
    def central_assignment(self, q, stamp: float = 0.0
                           ) -> Optional[m.Assignment]:
        """`sendAssignmentCb`: the base station's Hungarian on ground-truth
        poses — order the swarm by the last assignment, align the current
        formation to it (forced d=2, `assignment.py:55-92`), solve the
        vehicle->point LAP (`find_optimal_assignment`,
        `assignment.py:94-137`). Returns a wire `Assignment` for the
        `<ns>-central-assignment` channel, or None before any formation
        has been dispatched (`operator.py:231`: formidx == -1 guard).

        In the aclswarm operator this runs on its own 0.75 s timer but
        only takes effect at each vehicle's auction cadence
        (`operator.py:234-237` note); here the caller provides the timer
        and the planner provides the cadence gate.
        """
        if self.idx < 0:
            return None
        from aclswarm_torch.assignment.cbaa_ref import arun_np
        from aclswarm_torch.assignment.lapjv import solve_assignment_host
        q = np.asarray(q, dtype=np.float64)
        p = np.asarray(self.specs[self.idx].points, dtype=np.float64)
        last = (self._last_P if self._last_P is not None
                else np.arange(self.n))
        qq = np.zeros_like(q)
        qq[last] = q                   # q in formation-point order
        R, t = arun_np(p, qq, d=2)     # align formation onto the swarm
        P = solve_assignment_host(q, p @ R.T + t)
        self._last_P = P
        self.seq += 1
        return m.Assignment(header=m.Header(seq=self.seq, stamp=stamp),
                            perm=P.astype(np.int32))

    # -- flight-mode service (`operator.py:111-135` srvCB) ---------------
    def _broadcast(self, send_mode, mode: int, stamp: float) -> None:
        self.seq += 1
        send_mode(m.FlightMode(header=m.Header(seq=self.seq, stamp=stamp),
                               mode=mode))

    def start(self, send_mode: Callable[[object], object],
              send_form: Optional[Callable[[object], object]] = None,
              stamp: float = 0.0) -> Optional[m.Formation]:
        """START: first call takes the fleet off (GO broadcast); while
        flying it cycles to the next formation instead
        (`operator.py:126-134`). Returns the Formation when one was
        dispatched."""
        if not self.flying:
            self.flying = True
            self._broadcast(send_mode, m.MODE_GO, stamp)
            return None
        if send_form is None:
            raise ValueError("START while flying dispatches a formation; "
                             "pass send_form")
        return self.dispatch(send_form, stamp)

    def end(self, send_mode: Callable[[object], object],
            stamp: float = 0.0) -> None:
        """END: land the fleet — only meaningful in flight
        (`operator.py:122-124`)."""
        if self.flying:
            self.flying = False
            self._broadcast(send_mode, m.MODE_LAND, stamp)

    def kill(self, send_mode: Callable[[object], object],
             stamp: float = 0.0) -> None:
        """KILL: the e-stop broadcast, always honored
        (`operator.py:118-121`)."""
        self.flying = False
        self._broadcast(send_mode, m.MODE_KILL, stamp)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--group", default="swarm6_3d")
    ap.add_argument("--library", default=None)
    ap.add_argument("--channel", default="/asw-formation",
                    help="shm channel to publish Formation messages on")
    ap.add_argument("--mode-channel", default=None,
                    help="shm channel for FlightMode broadcasts (the "
                         "/globalflightmode edge); required for "
                         "start/end/kill actions")
    ap.add_argument("--create", action="store_true",
                    help="create the channel(s) (else open existing)")
    ap.add_argument("--action", default="dispatch",
                    choices=("dispatch", "start", "end", "kill"),
                    help="dispatch = publish formations (cycling); start = "
                         "the flight-mode service's START (GO broadcast, "
                         "then formation cycling); end = LAND broadcast; "
                         "kill = KILL broadcast (e-stop)")
    ap.add_argument("--dispatch", type=float, default=0.0,
                    help="seconds between dispatches; 0 = send one and exit")
    ap.add_argument("--cycles", type=int, default=0,
                    help="stop after this many dispatches (0 = forever)")
    ap.add_argument("--no-gains", action="store_true",
                    help="omit library gains (vehicles solve on commit)")
    args = ap.parse_args(argv)
    if args.action != "dispatch" and args.mode_channel is None:
        ap.error(f"--action {args.action} needs --mode-channel")

    from aclswarm_torch.interop.transport import Channel
    op = Operator(args.group, args.library, send_gains=not args.no_gains)
    mode_ch = (Channel(args.mode_channel, create=args.create)
               if args.mode_channel else None)
    try:
        if args.action == "kill":
            op.kill(mode_ch.send, stamp=time.time())
            print("broadcast KILL", flush=True)
            return 0
        if args.action == "end":
            op.flying = True   # END is only meaningful in flight
            op.end(mode_ch.send, stamp=time.time())
            print("broadcast LAND", flush=True)
            return 0
        with Channel(args.channel, create=args.create) as ch:
            if args.action == "start":
                # first START takes the fleet off; subsequent iterations
                # below cycle formations (`operator.py:126-134`)
                op.start(mode_ch.send, ch.send, stamp=time.time())
                print("broadcast GO (takeoff)", flush=True)
                if args.dispatch <= 0:
                    return 0
                time.sleep(args.dispatch)
            count = 0
            while True:
                msg = op.dispatch(ch.send, stamp=time.time())
                count += 1
                print(f"dispatched {op.group}/{msg.name} "
                      f"(formation {op.idx + 1}/{len(op.specs)})",
                      flush=True)
                if args.dispatch <= 0 or (args.cycles
                                          and count >= args.cycles):
                    break
                time.sleep(args.dispatch)
    finally:
        if mode_ch is not None:
            mode_ch.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
