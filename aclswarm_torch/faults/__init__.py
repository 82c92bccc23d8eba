"""Fault injection (port of `aclswarm_tpu.faults`): scripted dropout and
rejoin and lossy links as data riding `SimState.faults`
(`faults.schedule`), and the masked-assignment helpers that re-auction the
alive sub-fleet (`faults.masking`)."""
from aclswarm_torch.faults.masking import (alive_points, apply_pin_forbid,
                                           mask_cost, pin_forbid)
from aclswarm_torch.faults.schedule import (NEVER, FaultSchedule, alive_at,
                                            fault_event_at, link_up_at,
                                            no_faults, sample_schedule)

__all__ = ["FaultSchedule", "NEVER", "no_faults", "sample_schedule",
           "alive_at", "link_up_at", "fault_event_at", "alive_points",
           "pin_forbid", "mask_cost", "apply_pin_forbid"]
