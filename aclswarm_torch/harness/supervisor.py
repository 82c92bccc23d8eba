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

`TrialFSM` steps tick by tick; `SummaryTrialFSM`, the batched driver's,
reaches the same decisions from per-chunk device summaries.
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


class SummaryTrialFSM:
    """`TrialFSM` semantics driven by per-chunk device summaries
    (`aclswarm_torch.sim.summary`) instead of per-tick per-vehicle arrays:
    the batched trial driver's FSM, a copy of the reference's.

    The supervisor's ring buffers are pushed once per tick a predicate is
    evaluated, and those ticks are consecutive within a state episode, so a
    full buffer's mean is the trailing-W-tick mean the device computes
    (`ChunkSummary.conv_all` / `grid_any`), and "buffer full" is
    ``pushes >= W``, an integer counted here. Inside one FSM state the exit
    tick is the first True of a boolean array, so a chunk is processed in
    O(transitions) numpy scans instead of O(ticks) steps.

    Decisions (states, times, assignment counts, gridlock episodes) are
    tick-exact against `TrialFSM`. ``dist`` differs: it differences the
    device's trial-cumulative EWMA distance at chunk boundaries, so each
    logging window is quantized to the chunk grid, and the filter runs
    through the gaps between formations instead of freezing.
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
        self.timer_ticks = -1      # as of the last processed tick
        self.tick_count = -1
        self.curr_formation_idx = -1
        self.is_logging = False
        self._conv_pushes = 0
        self._grid_pushes = 0
        self._formation_just_received = False

        self.dist = np.zeros(n_vehicles)
        self.times: list[float] = []
        self.time_avoidance: list[float] = []
        self.assignments: list[int] = []
        self._log_start_tick = 0
        self._grid_enter_tick = None
        self._last_cumdist = None   # device cumdist at the last chunk end
        self._dist_mark = None      # cumdist at the logging-start boundary
        self._dist_pending = False  # stop seen, flush at next chunk end

    # -- exact float-threshold replication -------------------------------
    # The reference compares `ticks * dt >= secs` per tick; the smallest
    # qualifying integer is found by direct search around ceil() so the
    # vectorized FSM fires on exactly the tick the per-tick loop would
    # (0.01 is not exact in binary; an analytic ceil can be off by one).

    def _ticks_for(self, secs: float) -> int:
        k = max(0, int(np.ceil(secs / self.dt)) - 2)
        while k * self.dt < secs:
            k += 1
        return k

    def _ticks_strict(self, secs: float) -> int:
        k = max(0, int(np.ceil(secs / self.dt)) - 2)
        while not (k * self.dt > secs):
            k += 1
        return k

    @property
    def done(self) -> bool:
        return self.state in (TrialState.COMPLETE, TrialState.TERMINATE)

    @property
    def completed(self) -> bool:
        return self.state is TrialState.COMPLETE

    # -- driver hooks ----------------------------------------------------

    def formation_dispatched(self) -> None:
        """The driver applied this trial's pending formation commit: the
        next valid auction counts as an accepted assignment even if the
        permutation is unchanged (`auctioneer.cpp:310-316`)."""
        self._formation_just_received = True

    def observe_cumdist(self, cumdist: np.ndarray) -> None:
        """Record the device's trial-cumulative EWMA distance at this
        chunk's end; flushes a logging window closed earlier in the
        chunk."""
        self._last_cumdist = np.asarray(cumdist, np.float64).copy()
        if self._dist_pending:
            self._flush_dist()

    def _flush_dist(self) -> None:
        if self._last_cumdist is not None:
            mark = 0.0 if self._dist_mark is None else self._dist_mark
            self.dist += self._last_cumdist - mark
        self._dist_pending = False

    # -- logging -----------------------------------------------------------

    def _start_logging(self) -> None:
        if self.is_logging:
            return
        self.assignments.append(1)
        self.times.append(self.tick_count)   # finalized in _stop_logging
        self.time_avoidance.append(0.0)
        self.is_logging = True
        self._log_start_tick = self.tick_count
        if self._dist_pending:   # stop earlier in this same chunk: flush
            self._flush_dist()   # with the best boundary available
        self._dist_mark = (None if self._last_cumdist is None
                           else self._last_cumdist.copy())

    def _stop_logging(self) -> None:
        if not self.is_logging:
            return
        self.is_logging = False
        self.times[-1] = (self.tick_count - self.times[-1]) * self.dt
        self._dist_pending = True

    # -- transitions -----------------------------------------------------

    def _to(self, state: int, reset: bool = True) -> None:
        last = self.state
        self.state = state
        self.timer_ticks = -1
        if reset:
            self._conv_pushes = 0
            self._grid_pushes = 0
        if state is TrialState.GRIDLOCK:
            self._grid_enter_tick = self.tick_count
        if last is TrialState.GRIDLOCK and self.time_avoidance:
            self.time_avoidance[-1] = (
                (self.tick_count - self._grid_enter_tick) * self.dt)
        if state is TrialState.TERMINATE:
            self._stop_logging()

    @staticmethod
    def _pick(*cands):
        """Earliest candidate tick; list order breaks ties (= the serial
        FSM's within-tick branch order)."""
        best = None
        for sp, tag in cands:
            if sp is not None and (best is None or sp < best[0]):
                best = (sp, tag)
        return best

    # -- the chunk processor ---------------------------------------------

    def process_chunk(self, conv_ok, grid_ok, taken_off, auction_ok,
                      reassigned) -> list[str]:
        """Advance the FSM over one chunk of per-tick device summaries.

        Args are (T,) bool arrays (`ChunkSummary` fields for one trial;
        ``auction_ok`` = auctioned & assign_valid). Returns the driver
        actions emitted this chunk, in order: 'takeoff' (send CMD_GO next
        chunk) and/or 'dispatch' (commit formation `curr_formation_idx`
        at the next chunk boundary; later events this chunk are
        suppressed, as in the serial driver)."""
        S = TrialState
        conv_ok = np.asarray(conv_ok, bool)
        grid_ok = np.asarray(grid_ok, bool)
        taken_off = np.asarray(taken_off, bool)
        ev = np.asarray(reassigned, bool).copy()
        T = ev.shape[0]
        if self._formation_just_received:
            hit = np.flatnonzero(np.asarray(auction_ok, bool))
            if hit.size:
                ev[int(hit[0])] = True
                self._formation_just_received = False
        actions: list[str] = []
        W = self.window
        s = 0
        while s < T and not self.done:
            t0 = self.timer_ticks
            base = self.tick_count

            def first(mask, frm):
                idx = np.flatnonzero(mask)
                return frm + int(idx[0]) if idx.size else None

            def at_elapsed(secs):
                return s + max(0, self._ticks_for(secs) - t0 - 1)

            s_w = s + max(0,
                          self._ticks_strict(self.trial_timeout) - base - 1)
            fly_gate = None

            if self.state is S.IDLE:
                cand = (s, "takeoff")
            elif self.state is S.TAKING_OFF:
                cand = self._pick(
                    (first(taken_off[s:], s), "hover"),
                    (at_elapsed(TAKE_OFF_TIMEOUT), "terminate"))
            elif self.state is S.HOVERING:
                cand = (at_elapsed(HOVER_WAIT), "hover_done")
            elif self.state is S.WAITING_ON_ASSIGNMENT:
                cand = self._pick(
                    (first(ev[s:], s), "fly"),
                    (at_elapsed(ASSIGNMENT_TIMEOUT), "terminate"))
            elif self.state is S.FLYING:
                fly_gate = at_elapsed(FORMATION_RECEIVED_WAIT)
                a = b = None
                if fly_gate <= T - 1:
                    k = np.arange(fly_gate, T) - fly_gate + 1
                    mc = conv_ok[fly_gate:] & (self._conv_pushes + k >= W)
                    mg = (grid_ok[fly_gate:]
                          & (self._grid_pushes + k >= W) & ~mc)
                    a = first(mc, fly_gate)
                    b = first(mg, fly_gate)
                cand = self._pick((a, "inform"), (b, "gridlock"))
            elif self.state is S.IN_FORMATION:
                k = np.arange(s, T) - s + 1
                notconv = ~(conv_ok[s:] & (self._conv_pushes + k >= W))
                cand = self._pick(
                    (at_elapsed(CONVERGED_WAIT), "complete"),
                    (first(notconv, s), "unconverged"))
            elif self.state is S.GRIDLOCK:
                k = np.arange(s, T) - s + 1
                left = (~grid_ok[s:]) & (self._grid_pushes + k >= W)
                cand = self._pick(
                    (first(left, s), "gridlock_left"),
                    (at_elapsed(GRIDLOCK_TIMEOUT), "gridlock_timeout"))
            else:                                 # pragma: no cover
                raise RuntimeError(f"bad state {self.state}")

            if cand is not None and cand[0] > T - 1:
                cand = None
            e = T - 1 if cand is None else cand[0]
            e = min(e, s_w)
            state_fire = cand is not None and cand[0] == e
            tag = cand[1] if state_fire else None
            ticks_run = e - s + 1
            self.tick_count = base + ticks_run
            self.timer_ticks = t0 + ticks_run

            # push counters + event accounting over the processed run
            if self.state is S.FLYING and fly_gate is not None \
                    and fly_gate <= e:
                ng = e - fly_gate + 1
                self._conv_pushes += ng
                # grid is only probed when conv said "not converged"
                self._grid_pushes += ng - (1 if tag == "inform" else 0)
            elif self.state is S.IN_FORMATION:
                self._conv_pushes += ticks_run \
                    - (1 if tag == "complete" else 0)
            elif self.state is S.GRIDLOCK:
                self._grid_pushes += ticks_run
            if self.is_logging and self.assignments:
                self.assignments[-1] += int(np.count_nonzero(ev[s:e + 1]))

            if tag == "takeoff":
                actions.append("takeoff")
                self._to(S.TAKING_OFF)
            elif tag == "hover":
                self._to(S.HOVERING)
            elif tag == "terminate":
                self._to(S.TERMINATE)
            elif tag == "hover_done":
                if self.curr_formation_idx == self.n_formations - 1:
                    self._to(S.COMPLETE)
                else:
                    self.curr_formation_idx += 1
                    actions.append("dispatch")
                    ev[e + 1:] = False    # stale events belong to the
                    self._to(S.WAITING_ON_ASSIGNMENT)  # outgoing formation
            elif tag == "fly":
                self._start_logging()
                self._to(S.FLYING)
            elif tag == "inform":
                self._to(S.IN_FORMATION, reset=False)
            elif tag == "gridlock":
                self._to(S.GRIDLOCK)
            elif tag == "complete":
                self._stop_logging()
                self._to(S.HOVERING)
            elif tag == "unconverged":
                self._to(S.FLYING)
            elif tag == "gridlock_left":
                self._to(S.FLYING)
            elif tag == "gridlock_timeout":
                self._to(S.TERMINATE)

            # trial watchdog: end-of-tick, only
            # if the state logic did not already finish the trial
            if s_w == e and not self.done:
                self._to(S.TERMINATE)
            s = e + 1
        return actions

    def csv_row(self, trial: int) -> list:
        """Same schema as `TrialFSM.csv_row`."""
        return ([trial] + self.dist.tolist() + list(self.times)
                + list(self.time_avoidance) + list(self.assignments))

    # -- checkpointing (the same contract as
    # `TrialFSM.snapshot`: mutable state only, config re-derived)

    _SNAP_FIELDS = ("state", "timer_ticks", "tick_count",
                    "curr_formation_idx", "is_logging", "_conv_pushes",
                    "_grid_pushes", "_formation_just_received", "times",
                    "time_avoidance", "assignments", "_log_start_tick",
                    "_grid_enter_tick", "_dist_pending")

    def snapshot(self) -> dict:
        snap = {k: getattr(self, k) for k in self._SNAP_FIELDS}
        snap["dist"] = self.dist.copy()
        snap["_last_cumdist"] = (None if self._last_cumdist is None
                                 else self._last_cumdist.copy())
        snap["_dist_mark"] = (None if self._dist_mark is None
                              else self._dist_mark.copy())
        return snap

    def restore(self, snap: dict) -> "SummaryTrialFSM":
        for k in self._SNAP_FIELDS:
            setattr(self, k, snap[k])
        self.times = list(snap["times"])
        self.time_avoidance = list(snap["time_avoidance"])
        self.assignments = list(snap["assignments"])
        self.dist = np.asarray(snap["dist"]).copy()
        self._last_cumdist = (None if snap["_last_cumdist"] is None
                              else np.asarray(snap["_last_cumdist"]).copy())
        self._dist_mark = (None if snap["_dist_mark"] is None
                           else np.asarray(snap["_dist_mark"]).copy())
        return self
