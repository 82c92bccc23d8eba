"""Trial supervisor (port of `aclswarm_tpu/harness/supervisor.py`): the
experiment FSM, stepped tick by tick on host numpy.

The reference's supervisor samples live topics into 1 s ring buffers; the
trial driver here hands the FSM every control tick's signals instead, with
the same states, buffer-reset semantics, thresholds and timeouts:

- convergence: every vehicle's buffered-mean |distcmd| < 1.0 m/s; buffers
  empty on state transitions except entering IN_FORMATION;
- gridlock: any vehicle's buffered-mean CA-active ratio > 0.95; a trial
  only terminates as gridlocked if GRIDLOCK persists 90 s;
- the logged `time_avoidance` is the duration of the last GRIDLOCK
  episode;
- convergence time runs from FLYING entry to leaving IN_FORMATION after
  CONVERGED_WAIT, so it includes the 1 s confirmation dwell.

Only the serial `TrialFSM` is here; the batched driver's
`SummaryTrialFSM` comes with the batched-trials slice.
"""
from __future__ import annotations

from collections import deque

import numpy as np

BUFFER_SECONDS = 1.0
ZERO_POS_THR = 0.05            # m
ORIG_ZERO_VEL_THR = 1.00       # m/s
AVG_ACTIVE_CA_THR = 0.95
EWMA_ALPHA = 0.98
SIM_INIT_TIMEOUT = 10.0        # s
TAKE_OFF_TIMEOUT = 10.0        # s
HOVER_WAIT = 5.0               # s
ASSIGNMENT_TIMEOUT = 20.0      # s
FORMATION_RECEIVED_WAIT = 1.0  # s
CONVERGED_WAIT = 1.0           # s
GRIDLOCK_TIMEOUT = 90.0        # s
TRIAL_TIMEOUT = 600.0          # s


class _Buffer:
    """A predicate ring buffer: appended only when its predicate is
    invoked, cleared on (most) state transitions."""

    def __init__(self, window: int):
        self.window = window
        self.buf: deque = deque(maxlen=window)

    def push(self, sample):
        self.buf.append(sample)

    @property
    def full(self) -> bool:
        return len(self.buf) == self.window

    def mean(self) -> np.ndarray:
        return np.mean(np.asarray(self.buf), axis=0)

    def snapshot(self):
        """Stacked (k, ...) array of the buffered samples (None when
        empty): the checkpointable form."""
        return np.asarray(list(self.buf)) if self.buf else None

    @classmethod
    def restore(cls, window: int, snap) -> "_Buffer":
        b = cls(window)
        if snap is not None:
            for row in np.asarray(snap):
                b.push(row)
        return b


class TrialState:
    """The reference's state numbering."""

    IDLE = 1
    TAKING_OFF = 2
    HOVERING = 3
    WAITING_ON_ASSIGNMENT = 4
    FLYING = 5
    IN_FORMATION = 6
    GRIDLOCK = 7
    COMPLETE = 8
    TERMINATE = 9


NAMES = {v: k for k, v in vars(TrialState).items() if not k.startswith("_")}


class TrialFSM:
    """The whole trial lifecycle, stepped tick by tick: IDLE -> TAKING_OFF
    -> [HOVERING -> WAITING_ON_ASSIGNMENT -> FLYING -> IN_FORMATION]* ->
    COMPLETE, with GRIDLOCK/TERMINATE escapes, the TAKE_OFF and ASSIGNMENT
    timeouts, formation cycling through the group, and the reference's
    logging: per-formation convergence time, last-gridlock-episode and
    accepted-assignment count, plus one cumulative EWMA-smoothed planar
    distance per vehicle, accumulated only while logging.

    The trial driver (`aclswarm_torch.harness.trials`) owns the simulation;
    this FSM only observes per-tick signals and returns the actions the
    driver must perform. As in the reference, IDLE emits 'takeoff' on the
    first tick (the simulation has no bring-up to wait out), and
    assignment events are the engine's accepted-assignment ticks.
    """

    def __init__(self, n_vehicles: int, n_formations: int,
                 takeoff_alt: float, dt: float,
                 trial_timeout: float = TRIAL_TIMEOUT):
        self.n = n_vehicles
        self.n_formations = n_formations
        self.takeoff_alt = takeoff_alt
        self.dt = dt
        self.trial_timeout = trial_timeout
        self.window = max(1, int(round(BUFFER_SECONDS / dt)))

        self.state = TrialState.IDLE
        self.last_state = None
        self.timer_ticks = -1
        self.tick_count = -1
        self.curr_formation_idx = -1
        self.received_assignment = False
        self.is_logging = False
        self._conv = _Buffer(self.window)
        self._grid = _Buffer(self.window)

        self.dist = np.zeros(n_vehicles)
        self._fx = None
        self._fy = None
        self.times: list[float] = []
        self.time_avoidance: list[float] = []
        self.assignments: list[int] = []
        self._log_start_tick = 0
        self._grid_enter_tick = None

    # -- predicates --

    def _elapsed(self, secs: float) -> bool:
        return self.timer_ticks * self.dt >= secs

    def _has_taken_off(self, q) -> bool:
        return bool(np.all(np.abs(q[:, 2] - self.takeoff_alt)
                           < ZERO_POS_THR))

    def _has_converged(self, distcmd_norm) -> bool:
        self._conv.push(distcmd_norm)
        return self._conv.full and bool(
            np.all(self._conv.mean() < ORIG_ZERO_VEL_THR))

    def _has_gridlocked(self, ca_active) -> bool:
        self._grid.push(np.asarray(ca_active, dtype=np.float64))
        return self._grid.full and bool(
            np.any(self._grid.mean() > AVG_ACTIVE_CA_THR))

    # -- transitions --

    def _next_state(self, state: int, reset: bool = True) -> None:
        self.last_state = self.state
        self.state = state
        self.timer_ticks = -1
        if reset:
            self._conv = _Buffer(self.window)
            self._grid = _Buffer(self.window)
        # gridlock episode bookkeeping
        if self.state == TrialState.GRIDLOCK:
            self._grid_enter_tick = self.tick_count
        if self.last_state == TrialState.GRIDLOCK and self.time_avoidance:
            self.time_avoidance[-1] = (
                (self.tick_count - self._grid_enter_tick) * self.dt)
        # a TERMINATE mid-formation finalizes the open log entry, so
        # times[] holds elapsed seconds, never a raw start tick
        if self.state == TrialState.TERMINATE:
            self._stop_logging()

    def _start_logging(self) -> None:
        if self.is_logging:
            return
        self.assignments.append(1)
        self.times.append(self.tick_count)    # finalized in _stop_logging
        self.time_avoidance.append(0.0)
        self.is_logging = True
        self._log_start_tick = self.tick_count

    def _stop_logging(self) -> None:
        if not self.is_logging:
            return
        self.is_logging = False
        self.times[-1] = (self.tick_count - self.times[-1]) * self.dt

    def _log_signals(self, q) -> None:
        """EWMA position smoothing + planar distance."""
        x, y = q[:, 0], q[:, 1]
        if self._fx is None:
            self._fx, self._fy = x.copy(), y.copy()
            return
        nx = EWMA_ALPHA * self._fx + (1 - EWMA_ALPHA) * x
        ny = EWMA_ALPHA * self._fy + (1 - EWMA_ALPHA) * y
        self.dist += np.hypot(nx - self._fx, ny - self._fy)
        self._fx, self._fy = nx, ny

    @property
    def done(self) -> bool:
        return self.state in (TrialState.COMPLETE, TrialState.TERMINATE)

    @property
    def completed(self) -> bool:
        return self.state == TrialState.COMPLETE

    def step(self, q, distcmd_norm, ca_active, assign_event,
             in_formation=None):
        """One supervisor tick.

        Args are this tick's signals: q (n, 3) true positions, (n,)
        |distcmd|, (n,) collision-avoidance-active, and whether a new
        assignment was accepted this tick. Returns an action for the
        driver: 'takeoff' (send CMD_GO), 'dispatch' (commit the next
        formation of the group, index `curr_formation_idx`), or None.

        ``in_formation`` switches convergence to the human review gate:
        when not None it *replaces* the machine convergence predicate —
        True while FLYING declares the formation converged, True while
        GRIDLOCK aborts the trial, and IN_FORMATION completes at once
        without a dwell. Gridlock detection stays machine-derived.
        """
        if self.done:
            return None
        self.timer_ticks += 1
        self.tick_count += 1
        if assign_event:
            self.received_assignment = True
            if self.is_logging:
                self.assignments[-1] += 1
        action = None
        S = TrialState

        if self.state == S.IDLE:
            action = "takeoff"
            self._next_state(S.TAKING_OFF)

        elif self.state == S.TAKING_OFF:
            if self._has_taken_off(q):
                self._next_state(S.HOVERING)
            elif self._elapsed(TAKE_OFF_TIMEOUT):
                self._next_state(S.TERMINATE)

        elif self.state == S.HOVERING:
            if self._elapsed(HOVER_WAIT):
                if self.curr_formation_idx == self.n_formations - 1:
                    self._next_state(S.COMPLETE)
                else:
                    self.curr_formation_idx += 1
                    self.received_assignment = False
                    action = "dispatch"
                    self._next_state(S.WAITING_ON_ASSIGNMENT)

        elif self.state == S.WAITING_ON_ASSIGNMENT:
            if self.received_assignment:
                self._start_logging()
                self._next_state(S.FLYING)
            elif self._elapsed(ASSIGNMENT_TIMEOUT):
                self._next_state(S.TERMINATE)

        elif self.state == S.FLYING:
            if in_formation is not None:
                if in_formation:
                    self._next_state(S.IN_FORMATION, reset=False)
                elif self._has_gridlocked(ca_active):
                    self._next_state(S.GRIDLOCK)
            elif self._elapsed(FORMATION_RECEIVED_WAIT):
                if self._has_converged(distcmd_norm):
                    self._next_state(S.IN_FORMATION, reset=False)
                elif self._has_gridlocked(ca_active):
                    self._next_state(S.GRIDLOCK)

        elif self.state == S.IN_FORMATION:
            if in_formation is not None:
                # the human already confirmed: stop logging, no dwell
                self._stop_logging()
                self._next_state(S.HOVERING)
            elif self._elapsed(CONVERGED_WAIT):
                self._stop_logging()
                self._next_state(S.HOVERING)
            elif not self._has_converged(distcmd_norm):
                self._next_state(S.FLYING)

        elif self.state == S.GRIDLOCK:
            if in_formation is not None and in_formation:
                # `/in_formation` during gridlock aborts the trial
                self._next_state(S.TERMINATE)
            else:
                left = ((not self._has_gridlocked(ca_active))
                        and self._grid.full)
                if left:
                    self._next_state(S.FLYING)
                elif self._elapsed(GRIDLOCK_TIMEOUT):
                    self._next_state(S.TERMINATE)

        if self.is_logging:
            self._log_signals(q)

        # trial watchdog
        if self.tick_count * self.dt > self.trial_timeout and not self.done:
            self._next_state(S.TERMINATE)

        return action

    def csv_row(self, trial: int) -> list:
        """The reference CSV schema: [trial, dist x n, time x K,
        time_avoidance x K, assignments x K]."""
        return ([trial] + self.dist.tolist() + list(self.times)
                + list(self.time_avoidance) + list(self.assignments))

    # -- checkpointing: the FSM's mutable state as a plain dict of
    # scalars/lists/arrays; constructor parameters are not snapshotted
    # (the resuming driver rebuilds them from its config, and the
    # checkpoint manifest's config hash guarantees they agree)

    _SNAP_FIELDS = ("state", "last_state", "timer_ticks", "tick_count",
                    "curr_formation_idx", "received_assignment",
                    "is_logging", "times", "time_avoidance", "assignments",
                    "_log_start_tick", "_grid_enter_tick")

    def snapshot(self) -> dict:
        snap = {k: getattr(self, k) for k in self._SNAP_FIELDS}
        snap["dist"] = self.dist.copy()
        snap["_fx"] = None if self._fx is None else self._fx.copy()
        snap["_fy"] = None if self._fy is None else self._fy.copy()
        snap["conv_buf"] = self._conv.snapshot()
        snap["grid_buf"] = self._grid.snapshot()
        return snap

    def restore(self, snap: dict) -> "TrialFSM":
        for k in self._SNAP_FIELDS:
            setattr(self, k, snap[k])
        self.times = list(snap["times"])
        self.time_avoidance = list(snap["time_avoidance"])
        self.assignments = list(snap["assignments"])
        self.dist = np.asarray(snap["dist"]).copy()
        self._fx = None if snap["_fx"] is None \
            else np.asarray(snap["_fx"]).copy()
        self._fy = None if snap["_fy"] is None \
            else np.asarray(snap["_fy"]).copy()
        self._conv = _Buffer.restore(self.window, snap["conv_buf"])
        self._grid = _Buffer.restore(self.window, snap["grid_buf"])
        return self
