"""Host utilities (port of the parts of `aclswarm_tpu.utils` the port
calls): the retry policy and failure records (`utils.retry`). The port
logs through the standard `logging` module under ``aclswarm_torch.*``
names in place of the reference's `utils.log`."""
from aclswarm_torch.utils.retry import (ExecutionFailure, RetryCancelled,
                                        RetryPolicy, delay_for, jittered,
                                        retry_after_delay, retry_call,
                                        subprocess_output)

__all__ = ["ExecutionFailure", "RetryCancelled", "RetryPolicy", "delay_for",
           "jittered", "retry_after_delay", "retry_call",
           "subprocess_output"]
