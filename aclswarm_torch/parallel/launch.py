"""The multi-process launch program: every process runs this module
(port of `aclswarm_tpu/parallel/launch.py`).

One run joins the process group (`multihost.initialize`), builds the
agent mesh over its ranks, constructs the reference's seeded
faithful-stack problem (a ring formation on the complete graph, seeded
gains, CBAA every ``ticks // 2`` ticks, flooded localization, avoidance
over the 16 nearest), rolls the sharded engine (`parallel.rollout`) and
prints one JSON line per process: ``process``, ``processes``,
``global_devices`` (the mesh's ranks), ``backend``, ``n``, ``ticks``,
``digest`` (the sum of the final positions, a function of the whole
computation, so equal digests across processes certify that the ranks
agreed) and ``multiprocess``.

Run it on the card, one rank on NCCL:

    python -m aclswarm_torch.parallel.launch --n 1000 --ticks 20

two ranks on one card (NCCL refuses two ranks on one device, so gloo,
which carries the CUDA tensors through the host, is asked for by name),
one command per process:

    python -m aclswarm_torch.parallel.launch --coordinator 127.0.0.1:29500 \\
        --num-processes 2 --process-id $i --backend gloo --n 1000

one rank per card of a host, under torchrun (which sets the cluster
variables `initialize` reads):

    torchrun --nproc-per-node K -m aclswarm_torch.parallel.launch --n 1000

and on the CPU, with ``--cpu`` (gloo). With no card and no ``--cpu`` it
raises. `scripts/pod_up.sh` brings up the reference's launcher, not this
one.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def problem(n: int, ticks: int, seed: int, device, dtype):
    """The reference's seeded problem (`launch.py:57-109`): (formation,
    safety parameters, config, global start state)."""
    from aclswarm_torch import sim
    from aclswarm_torch.core.types import SafetyParams, make_formation

    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r0 = 3.0 * np.sqrt(max(n, 8) / 8.0)
    points = np.stack([r0 * np.cos(ang), r0 * np.sin(ang), np.zeros(n)], 1)
    adj = np.ones((n, n)) - np.eye(n)
    gains = rng.normal(size=(n, n, 3, 3)) * 0.01
    formation = make_formation(points, adj, gains, device=device,
                               dtype=dtype)
    sparams = SafetyParams(bounds_min=(-500.0, -500.0, 0.0),
                           bounds_max=(500.0, 500.0, 10.0))
    block = max(1, min(64, n // 2))
    cfg = sim.SimConfig(assignment="cbaa", assign_every=max(1, ticks // 2),
                        localization="flooded", flood_block=block,
                        cbaa_task_block=block, colavoid_neighbors=16,
                        flight_fsm=False)
    state = sim.init_state(rng.normal(size=(n, 3)) * 4.0 + [0, 0, 2.0],
                           localization=True, device=device, dtype=dtype)
    return formation, sparams, cfg, state


def run(n: int, ticks: int, seed: int = 0, device=None,
        dtype=torch.float32) -> dict:
    """The post-handshake smoke: the sharded faithful-stack rollout."""
    import torch.distributed as dist

    from aclswarm_torch.core.types import ControlGains
    from aclswarm_torch.parallel import mesh as meshlib
    from aclswarm_torch.parallel.rollout import sharded_rollout_fn

    mesh = meshlib.make_mesh(n_agents=n, device=device)
    formation, sparams, cfg, state = problem(n, ticks, seed, mesh.device,
                                             dtype)
    local, form, _, _ = meshlib.shard_problem(state, formation, mesh)
    _, metrics = sharded_rollout_fn(mesh, form, ControlGains(), sparams,
                                    cfg, ticks)(local)
    q = state.swarm.q if metrics is None else metrics.q[-1]
    on = dist.is_initialized()
    return {"process": dist.get_rank() if on else 0,
            "processes": dist.get_world_size() if on else 1,
            "global_devices": mesh.size,
            "backend": dist.get_backend() if on else None,
            "n": n, "ticks": ticks,
            "digest": round(float(q.sum().item()), 6)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (omit under torchrun)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU over gloo")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the process group's backend (default nccl on "
                    "the card, gloo with --cpu); two ranks on one card "
                    "need gloo")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from aclswarm_torch.parallel import multihost

    backend = args.backend or ("gloo" if args.cpu else "nccl")
    multi = multihost.initialize(coordinator_address=args.coordinator,
                                 num_processes=args.num_processes,
                                 process_id=args.process_id,
                                 backend=backend)
    try:
        report = run(args.n, args.ticks, args.seed,
                     device="cpu" if args.cpu else None,
                     dtype=getattr(torch, args.dtype))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    report["multiprocess"] = bool(multi)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
