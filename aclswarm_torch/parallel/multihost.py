"""Multi-process scale-out over `torch.distributed` (port of
`aclswarm_tpu/parallel/multihost.py`).

Every process runs the same program; `initialize` joins them into one
process group, and the agent mesh (`parallel.mesh.make_mesh`) then spans
the group's ranks, one rank per device. The backend is explicit: NCCL
(the default) carries the collectives between cards; two ranks on one
card must ask for ``backend="gloo"`` by name, since NCCL refuses two
ranks on one device, and gloo moves CUDA tensors through the host. With
no card, only ``backend="gloo"`` runs.

The contract of the reference's `initialize`:

- with no cluster in the environment and no explicit coordinator, it
  returns False and the program runs as one process;
- a cluster that is configured (torchrun's ``MASTER_ADDR`` / ``RANK`` /
  ``WORLD_SIZE`` or ``TORCHELASTIC_RUN_ID``, SLURM, Open MPI) but fails
  the handshake raises, rather than running each process alone at the
  wrong scale;
- an explicit coordinator (``host:port`` of rank 0) retries transient
  failures, such as a follower starting before rank 0 listens, under
  `utils.retry`'s policy, tearing a half-made group down between tries.
"""
from __future__ import annotations

import datetime
import os

import torch

# the variables whose presence means a launcher configured a cluster
CLUSTER_VARS = ("TORCHELASTIC_RUN_ID", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")
TORCHRUN_VARS = ("MASTER_ADDR", "RANK", "WORLD_SIZE")
# rank and world size under each launcher, first found wins
_RANK_VARS = ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
_SIZE_VARS = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
HANDSHAKE_TIMEOUT_S = 120.0


def cluster_env(env=None) -> bool:
    """A launcher configured a cluster in ``env`` (default: this
    process's environment)."""
    env = os.environ if env is None else env
    return any(env.get(v) for v in CLUSTER_VARS) \
        or all(env.get(v) for v in TORCHRUN_VARS)


def _env_int(names) -> int | None:
    for v in names:
        if os.environ.get(v):
            return int(os.environ[v])
    return None


def _init(backend: str, init_method: str, world: int | None,
          rank: int | None, timeout_s: float) -> None:
    import torch.distributed as dist

    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA card; pass "
                               "backend='gloo' to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(
        backend=backend, init_method=init_method,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None,
               timeout_s: float = HANDSHAKE_TIMEOUT_S) -> bool:
    """Join the process group (no-op when single-process). Returns True
    when a multi-process group is active. ``backend`` None is NCCL."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    backend = backend or "nccl"
    if num_processes is None and coordinator_address is None:
        if not cluster_env():
            return False
        # a configured cluster: a failed handshake raises
        _init(backend, "env://", _env_int(_SIZE_VARS), _env_int(_RANK_VARS),
              timeout_s)
        return dist.get_world_size() > 1
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("an explicit cluster needs coordinator_address, "
                         "num_processes and process_id together")

    from aclswarm_torch.utils.retry import RetryPolicy, retry_call

    def transient(e: BaseException) -> bool:
        s = str(e).lower()
        return isinstance(e, (RuntimeError, ConnectionError)) and any(
            m in s for m in ("connect", "refused", "unreachable",
                             "timed out", "timeout", "reset"))

    def attempt():
        try:
            _init(backend, f"tcp://{coordinator_address}", num_processes,
                  process_id, timeout_s)
        except BaseException:
            # a half-made group would make the next try raise "already
            # initialized" and hide the real failure
            if dist.is_initialized():
                dist.destroy_process_group()
            raise

    retry_call(attempt, policy=RetryPolicy(attempts=5, base_s=0.5,
                                           max_s=4.0, budget_s=30.0),
               retryable=transient)
    return dist.get_world_size() > 1


def global_agent_mesh(n_agents: int, device=None):
    """The agent mesh over every rank of the group (`mesh.make_mesh`)."""
    from aclswarm_torch.parallel import mesh as meshlib

    return meshlib.make_mesh(n_agents=n_agents, device=device)
