"""Host utilities (port of the parts of `aclswarm_tpu.utils` the port
calls): logging (`utils.log`, the framework root logger ``aclswarm_torch``)
and the retry policy, polling and failure records (`utils.retry`)."""
from aclswarm_torch.utils.log import get_logger
from aclswarm_torch.utils.retry import (ExecutionFailure, RetryCancelled,
                                        RetryPolicy, delay_for, jittered,
                                        poll_until, retry_after_delay,
                                        retry_call, subprocess_output)

__all__ = ["get_logger", "ExecutionFailure", "RetryCancelled",
           "RetryPolicy", "delay_for", "jittered", "poll_until",
           "retry_after_delay", "retry_call", "subprocess_output"]
