"""`aclswarm_torch.parallel.multihost` and `parallel.launch` against the
reference's contract, on the CPU.

- `initialize`: False with no cluster in the environment; a raise when a
  launcher's variables are set and the handshake fails (each launcher
  kind); an explicit coordinator retries a transient failure and then
  joins a real one-rank gloo group.
- The launch program as users run it: two ``--cpu`` processes on a free
  port give equal digests, ``processes == 2`` and ``global_devices ==
  2``, each within 2e-6 of the reference's `launch.run` at the same n,
  ticks and seed (float64 on both sides: the digest is printed to 6
  decimals, so the last printed digit may round either way); with no
  card and no ``--cpu`` the launch raises.
- The serving pool's slot placement through `slice_devices`, on fake
  card lists; a job moves to its worker's card once (the ``meta`` device
  stands in for a second card), and a service whose workers each hold a
  card still stages a job's rows once and reuses them every round.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from aclswarm_torch.parallel import launch as tlaunch
from aclswarm_torch.parallel import multihost
from aclswarm_tpu.parallel import launch as jlaunch

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

REPO = str(Path(__file__).resolve().parents[1])
LAUNCH_N, LAUNCH_TICKS = 16, 6
DIGEST_ATOL = 2e-6
ALL_VARS = multihost.CLUSTER_VARS + multihost.TORCHRUN_VARS + (
    "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS", "OMPI_COMM_WORLD_RANK",
    "LOCAL_RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def clean_env(monkeypatch):
    for v in ALL_VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_initialize_without_cluster_returns_false(clean_env):
    import torch.distributed as dist
    assert multihost.initialize() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("env", [
    {"SLURM_JOB_ID": "7"}, {"OMPI_COMM_WORLD_SIZE": "2"},
    {"TORCHELASTIC_RUN_ID": "x"},
    {"MASTER_ADDR": "127.0.0.1", "RANK": "0", "WORLD_SIZE": "2"}],
    ids=["slurm", "ompi", "torchelastic", "torchrun"])
def test_initialize_with_cluster_env_raises_on_failed_handshake(clean_env,
                                                                env):
    import torch.distributed as dist
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert multihost.cluster_env()
    with pytest.raises((ValueError, RuntimeError)):
        multihost.initialize(backend="gloo")
    assert not dist.is_initialized()


def test_explicit_coordinator_retries_then_joins(clean_env):
    import torch.distributed as dist
    calls = []
    real = multihost._init

    def flaky(*a, **kw):
        calls.append(a)
        if len(calls) == 1:
            raise RuntimeError("connection refused by the coordinator")
        return real(*a, **kw)

    clean_env.setattr(multihost, "_init", flaky)
    try:
        multi = multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                                     backend="gloo")
        assert multi is False and dist.is_initialized()
        assert len(calls) == 2
        mesh = multihost.global_agent_mesh(8, device="cpu")
        assert (mesh.size, mesh.rows(8)) == (1, (0, 8))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_explicit_coordinator_needs_every_argument(clean_env):
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("127.0.0.1:1", num_processes=2)


def test_launch_without_card_raises(clean_env):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launch would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--n", "8", "--ticks", "1"])


def test_two_process_launch_agrees_with_reference(clean_env):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ALL_VARS}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "aclswarm_torch.parallel.launch", "--cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(pid), "--n", str(LAUNCH_N), "--ticks",
         str(LAUNCH_TICKS), "--dtype", "float64"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (1, 0)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"launch failed:\n{out}\n{err[-3000:]}"
        reports.append(json.loads([ln for ln in out.splitlines()
                                   if ln.startswith("{")][-1]))
    assert {r["process"] for r in reports} == {0, 1}
    assert all(r["processes"] == 2 and r["global_devices"] == 2
               and r["multiprocess"] and r["backend"] == "gloo"
               for r in reports)
    assert reports[0]["digest"] == reports[1]["digest"]
    ref = jlaunch.run(LAUNCH_N, LAUNCH_TICKS, 0)
    assert abs(reports[0]["digest"] - ref["digest"]) <= DIGEST_ATOL


@pytest.mark.parametrize("slots,cards,want", [
    (3, 1, [None, None, None]),          # one card: every slot shares it
    (2, 2, [0, 1]), (2, 4, [0, 2]), (3, 4, [0, 2, 3]),
    (3, 2, [0, 1, 0])])                  # fewer cards: round-robin
def test_worker_slots_take_their_slice_lead_card(slots, cards, want):
    from aclswarm_torch.serve import ServiceConfig, SwarmService
    svc = SwarmService(ServiceConfig(device="cpu", dtype="float64",
                                     workers=slots), start=False)
    fake = [torch.device("cuda", i) for i in range(cards)]
    got = svc._pool.slot_devices(fake)
    assert got == [None if w is None else fake[w] for w in want]
    # the service's own device is the CPU: no slot is pinned
    assert svc._pool.slot_devices() == [None] * slots


def test_job_moves_to_its_slot_card_once():
    from types import SimpleNamespace

    from aclswarm_torch import sim
    from aclswarm_torch.core.types import Formation
    from aclswarm_torch.parallel.collectives import map_tree
    from aclswarm_torch.serve import SwarmService
    n, f64 = 4, torch.float64
    state = sim.init_state(torch.rand(n, 3, dtype=f64), localization=True,
                           device="cpu", dtype=f64)
    form = Formation(points=torch.rand(n, 3, dtype=f64),
                     adjmat=torch.ones(n, n, dtype=f64),
                     gains=torch.rand(n, n, 2, 2, dtype=f64),
                     dstar_xy=torch.rand(n, n, dtype=f64),
                     dstar_z=torch.rand(n, n, dtype=f64))
    job = SimpleNamespace(state=state, _problem=(form, "gains", "sparams",
                                                 "cfg"))
    card = torch.device("meta")
    SwarmService._on_worker_device(job, SimpleNamespace(device=card))
    devs = set()
    map_tree(lambda x: devs.add(x.device) or x, (job.state,
                                                 job._problem[0]))
    assert devs == {card}
    assert job._problem[1:] == ("gains", "sparams", "cfg")
    # a later round on the same card leaves the trees as they are
    st, fm = job.state, job._problem[0]
    SwarmService._on_worker_device(job, SimpleNamespace(device=card))
    assert job.state is st and job._problem[0] is fm
    # one card (no slot device): nothing moves
    SwarmService._on_worker_device(job, SimpleNamespace(device=None))
    assert job.state is st


def test_pinned_workers_stage_a_job_once(monkeypatch):
    """Each worker holding a card (the CPU here) runs the k-card path; a
    three-chunk rollout is staged once and equals the one-card run."""
    from aclswarm_torch.serve import ServiceConfig, SwarmService
    from aclswarm_torch.serve import staging as stagelib
    from aclswarm_torch.serve import workers as workerslib
    spec = {"n": 5, "ticks": 60, "chunk_ticks": 20, "seed": 5}

    def run():
        svc = SwarmService(ServiceConfig(device="cpu", dtype="float64",
                                         workers=2, max_batch=1,
                                         quantum_chunks=8))
        try:
            res = svc.submit("rollout", spec).result(timeout=240)
            devs = [w.device for w in svc._pool._slots]
        finally:
            svc.close()
        assert res.ok
        return res, devs

    want, devs = run()
    assert devs == [None, None]
    writes = []
    real = stagelib.write_row
    monkeypatch.setattr(stagelib, "write_row",
                        lambda *a, **k: writes.append(1) or real(*a, **k))
    monkeypatch.setattr(
        workerslib.WorkerPool, "slot_devices",
        lambda self, devices=None: [torch.device("cpu")] * len(self._slots))
    got, devs = run()
    assert devs == [torch.device("cpu")] * 2
    assert len(writes) == 1
    assert got.value["digest"] == want.value["digest"]
    assert got.value["chunk_digests"] == want.value["chunk_digests"]
