"""Vehicle flight-mode FSM + goal mux, batched over the swarm (port of
`aclswarm_tpu/sim/vehicle.py`).

The whole swarm's modes are one ``(n,)`` int32 tensor; transitions are
`torch.where` selects, so a tick never reads a mode back to the host.
NOT_FLYING --GO--> TAKEOFF; TAKEOFF/FLYING --LAND--> LANDING; any --KILL-->
NOT_FLYING. TAKEOFF snaps the goal to the pose, waits ``spinup_time`` and
ramps z by ``takeoff_inc`` per tick; LANDING ramps down fast then slow;
FLYING takes the safe-trajectory pipeline's goal; NOT_FLYING pins the
goal to the ground pose. A batch of trials adds a leading ``(B,)`` axis to
every field (and to an input's ``cmd``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from aclswarm_torch.control.safety import TrajGoal
from aclswarm_torch.core.types import SafetyParams, resolve_device

# flight modes (`safety.h` Mode enum order)
NOT_FLYING, TAKEOFF, FLYING, LANDING = 0, 1, 2, 3
# operator commands (`snapstack_msgs/QuadFlightMode` GO/LAND/KILL)
CMD_NONE, CMD_GO, CMD_LAND, CMD_KILL = 0, 1, 2, 3

TAKEOFF_THRESHOLD = 0.100   # m
LANDING_THRESHOLD = 0.005   # m


@dataclass
class FlightState:
    """Batched per-vehicle FSM state."""

    mode: torch.Tensor           # (n,) int32
    ticks_in_mode: torch.Tensor  # (n,) int32, resets on every transition
    initial_alt: torch.Tensor    # (n,) altitude captured at takeoff init
    takeoff_alt: torch.Tensor    # (n,) absolute target altitude


@dataclass
class ExternalInputs:
    """Per-tick operator/pilot inputs: the global flight-mode broadcast
    ``cmd`` and the JOY velocity override (priority over the controller).
    `rollout` takes them stacked over a leading time axis."""

    cmd: torch.Tensor          # () int32 broadcast command
    joy_vel: torch.Tensor      # (n, 3) joystick velocity goal
    joy_yawrate: torch.Tensor  # (n,)
    joy_active: torch.Tensor   # (n,) bool

    @classmethod
    def none(cls, n: int, device=None, dtype=torch.float32,
             batch: int | None = None) -> "ExternalInputs":
        """No command and no joystick, for one trial or ``batch`` trials."""
        dev = resolve_device(device)
        lead = () if batch is None else (batch,)
        return cls(cmd=torch.full(lead, CMD_NONE, dtype=torch.int32,
                                  device=dev),
                   joy_vel=torch.zeros(lead + (n, 3), dtype=dtype,
                                       device=dev),
                   joy_yawrate=torch.zeros(lead + (n,), dtype=dtype,
                                           device=dev),
                   joy_active=torch.zeros(lead + (n,), dtype=torch.bool,
                                          device=dev))

    def at(self, t: int) -> "ExternalInputs":
        """Tick ``t`` of a time-stacked schedule."""
        return ExternalInputs(cmd=self.cmd[t], joy_vel=self.joy_vel[t],
                              joy_yawrate=self.joy_yawrate[t],
                              joy_active=self.joy_active[t])


def init_flight(n: int, device=None, dtype=torch.float32,
                flying: bool = True) -> FlightState:
    """All vehicles NOT_FLYING on the ground, or already FLYING."""
    dev = resolve_device(device)
    return FlightState(
        mode=torch.full((n,), FLYING if flying else NOT_FLYING,
                        dtype=torch.int32, device=dev),
        ticks_in_mode=torch.zeros((n,), dtype=torch.int32, device=dev),
        initial_alt=torch.zeros((n,), dtype=dtype, device=dev),
        takeoff_alt=torch.zeros((n,), dtype=dtype, device=dev))


def _i32(like: torch.Tensor, v: int) -> torch.Tensor:
    return torch.full_like(like, v)


def apply_command(fs: FlightState, cmd: torch.Tensor) -> FlightState:
    """Operator-command transitions, batched."""
    m = fs.mode
    cmd = cmd[..., None]                 # one command per trial
    new = torch.where((m == NOT_FLYING) & (cmd == CMD_GO),
                      _i32(m, TAKEOFF), m)
    new = torch.where(((m == TAKEOFF) | (m == FLYING)) & (cmd == CMD_LAND),
                      _i32(m, LANDING), new)
    new = torch.where(cmd == CMD_KILL, _i32(m, NOT_FLYING), new)
    changed = new != m
    return replace(fs, mode=new,
                   ticks_in_mode=torch.where(changed, _i32(m, 0),
                                             fs.ticks_in_mode))


def mux_goals(dist_vel: torch.Tensor, inputs: ExternalInputs
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """JOY (priority 1) beats DIST (priority 0). Returns (vel, yawrate)."""
    vel = torch.where(inputs.joy_active[..., None], inputs.joy_vel,
                      dist_vel)
    yawrate = torch.where(inputs.joy_active, inputs.joy_yawrate,
                          torch.zeros_like(inputs.joy_yawrate))
    return vel, yawrate


def _z_only(vz: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(vz)
    return torch.stack([zero, zero, vz], dim=-1)


def flight_step(fs: FlightState, goal_prev: TrajGoal, safe_goal: TrajGoal,
                q: torch.Tensor, params: SafetyParams, dt: float
                ) -> tuple[FlightState, TrajGoal]:
    """One control tick of the per-mode goal logic. ``safe_goal`` is the
    FLYING pipeline's output for every row; it is taken only where the
    vehicle is FLYING, and the takeoff/landing ramps run elsewhere.
    Returns (new flight state, new goal)."""
    m = fs.mode
    ticks = fs.ticks_in_mode
    qz = q[..., 2]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)

    # --- TAKEOFF init: snap goal to pose, capture altitudes ---
    entering = (m == TAKEOFF) & (ticks == 0)
    initial_alt = torch.where(entering, qz, fs.initial_alt)
    tk_alt = (params.takeoff_alt + initial_alt if params.takeoff_rel
              else torch.full_like(initial_alt, params.takeoff_alt))
    takeoff_alt = torch.where(entering, tk_alt, fs.takeoff_alt)

    pos = torch.where(entering[..., None], q, goal_prev.pos)
    vel = torch.where(entering[..., None], zero, goal_prev.vel)
    yaw = goal_prev.yaw
    dyaw = torch.where(entering, zero, goal_prev.dyaw)

    # --- TAKEOFF ramp after spinup; done once the ramp has clamped at
    # takeoff_alt and tracking has caught up ---
    spun_up = (ticks.to(q.dtype) * dt) >= params.spinup_time
    tk = (m == TAKEOFF) & spun_up
    tk_done = tk & (torch.abs(pos[..., 2] - qz) < TAKEOFF_THRESHOLD) \
        & (pos[..., 2] >= takeoff_alt - 1e-6)
    ramping = tk & ~tk_done
    ramp_z = torch.minimum(torch.clamp(pos[..., 2] + params.takeoff_inc,
                                       min=0.0), takeoff_alt)
    ramp_vz = torch.where(ramping, (ramp_z - pos[..., 2]) / dt, zero)
    pos = torch.cat([pos[..., :2],
                     torch.where(ramping, ramp_z, pos[..., 2])[..., None]],
                    -1)
    vel = torch.where((m == TAKEOFF)[..., None], _z_only(ramp_vz), vel)

    # --- LANDING decrement ---
    landing = m == LANDING
    land_done = landing & ((qz - initial_alt) < LANDING_THRESHOLD)
    fast_th = params.landing_fast_threshold + (
        initial_alt if params.takeoff_rel else zero)
    dec = torch.where(qz > fast_th,
                      torch.full_like(qz, params.landing_fast_dec),
                      torch.full_like(qz, params.landing_slow_dec))
    descending = landing & ~land_done
    land_z = torch.clamp(pos[..., 2] - dec, 0.0, params.bounds_max[2])
    land_vz = torch.where(descending, (land_z - pos[..., 2]) / dt, zero)
    pos = torch.cat([pos[..., :2],
                     torch.where(descending, land_z, pos[..., 2])[..., None]],
                    -1)
    vel = torch.where(landing[..., None], _z_only(land_vz), vel)
    dyaw = torch.where(landing, zero, dyaw)

    # --- FLYING: take the safe-trajectory pipeline's output ---
    flying = m == FLYING
    pos = torch.where(flying[..., None], safe_goal.pos, pos)
    vel = torch.where(flying[..., None], safe_goal.vel, vel)
    yaw = torch.where(flying, safe_goal.yaw, yaw)
    dyaw = torch.where(flying, safe_goal.dyaw, dyaw)

    # --- NOT_FLYING: power cut, goal pinned to the ground pose ---
    grounded = m == NOT_FLYING
    pos = torch.where(grounded[..., None], q, pos)
    vel = torch.where(grounded[..., None], zero, vel)
    dyaw = torch.where(grounded, zero, dyaw)

    # --- automatic transitions ---
    new_mode = torch.where(tk_done, _i32(m, FLYING), m)
    new_mode = torch.where(land_done, _i32(m, NOT_FLYING), new_mode)
    changed = new_mode != m
    new_fs = FlightState(mode=new_mode,
                         ticks_in_mode=torch.where(changed, _i32(m, 0),
                                                   ticks + 1),
                         initial_alt=initial_alt, takeoff_alt=takeoff_alt)
    return new_fs, TrajGoal(pos=pos, vel=vel, yaw=yaw, dyaw=dyaw)
