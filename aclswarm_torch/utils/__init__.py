"""Host utilities (port of the parts of `aclswarm_tpu.utils` the port
calls): logging (`utils.log`, the framework root logger ``aclswarm_torch``),
the retry policy, polling and failure records (`utils.retry`), and the
benchmark timer and profiler hook (`utils.timing`)."""
from aclswarm_torch.utils.log import get_logger
from aclswarm_torch.utils.retry import (ExecutionFailure, RetryCancelled,
                                        RetryPolicy, delay_for, jittered,
                                        poll_until, retry_after_delay,
                                        retry_call, subprocess_output)
from aclswarm_torch.utils.timing import (Stopwatch, median_time,
                                         readback_sync, trace)

__all__ = ["get_logger", "Stopwatch", "median_time", "readback_sync",
           "trace", "ExecutionFailure", "RetryCancelled", "RetryPolicy",
           "delay_for", "jittered", "poll_until", "retry_after_delay",
           "retry_call", "subprocess_output"]
