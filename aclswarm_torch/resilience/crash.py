"""Scripted preemption (port of `aclswarm_tpu/resilience/crash.py`):
crash plans as data, consulted at chunk boundaries.

A `CrashPlan` names *where* a run dies — a boundary site ('trial') and a
boundary index — and *how*: a raised `InjectedCrash`, or a real SIGKILL.
Drivers call `maybe_crash(site, k)` at every checkpoint boundary; unarmed
it does nothing, armed it kills the run exactly once. It exists to prove
resume: kill a run at a chosen chunk, resume from the checkpoint, and
compare with an uninterrupted run.

Arming: in-process with `arm(CrashPlan(...))`, or across a process
boundary with the ``ACLSWARM_CRASH`` environment variable
(``site:boundary[:kind]``, comma-separated for several plans, e.g.
``trial:3:kill`` for a trial run from the command line). Each plan is
one-shot: `maybe_crash` consumes only the matching plan.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import threading
from typing import List, Optional

ENV_VAR = "ACLSWARM_CRASH"
KINDS = ("raise", "kill")


class InjectedCrash(RuntimeError):
    """The scripted preemption (exception form)."""


@dataclasses.dataclass(frozen=True)
class CrashPlan:
    """Die at boundary ``boundary`` of site ``site`` (0-based count of
    completed chunks at the moment the driver consults it)."""

    site: str
    boundary: int
    kind: str = "raise"          # 'raise' -> InjectedCrash, 'kill' -> SIGKILL

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"crash kind must be one of {KINDS}, "
                             f"got {self.kind!r}")

    def encode(self) -> str:
        return f"{self.site}:{self.boundary}:{self.kind}"

    @classmethod
    def decode(cls, s: str) -> "CrashPlan":
        parts = s.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(f"bad {ENV_VAR} spec {s!r} "
                             "(want site:boundary[:kind])")
        return cls(site=parts[0], boundary=int(parts[1]),
                   kind=parts[2] if len(parts) == 3 else "raise")

    @classmethod
    def decode_many(cls, s: str) -> List["CrashPlan"]:
        return [cls.decode(part) for part in s.split(",") if part]


_armed: List[CrashPlan] = []
_plan_lock = threading.Lock()


def arm(plan: Optional[CrashPlan]) -> None:
    """Install (or with None, clear) the in-process crash plan."""
    global _armed
    with _plan_lock:
        _armed = [] if plan is None else [plan]


def _consume(site: str, boundary: int) -> Optional[CrashPlan]:
    """Claim the plan matching (site, boundary), if any; the rest stay
    armed."""
    with _plan_lock:
        for i, plan in enumerate(_armed):
            if plan.site == site and plan.boundary == boundary:
                return _armed.pop(i)
        spec = os.environ.get(ENV_VAR)
        if not spec:
            return None
        plans = CrashPlan.decode_many(spec)
        for i, plan in enumerate(plans):
            if plan.site == site and plan.boundary == boundary:
                rest = plans[:i] + plans[i + 1:]
                if rest:
                    os.environ[ENV_VAR] = ",".join(p.encode() for p in rest)
                else:
                    os.environ.pop(ENV_VAR, None)
                return plan
    return None


def maybe_crash(site: str, boundary: int) -> None:
    """Dies iff an armed plan names this exact (site, boundary); the plan
    is disarmed first, so a resumed in-process run sails past."""
    plan = _consume(site, boundary)
    if plan is None:
        return
    if plan.kind == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    raise InjectedCrash(f"scripted preemption at {site} boundary {boundary}")
