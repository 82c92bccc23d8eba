"""The port stands alone: nothing under `aclswarm_torch/`, and not
`chip_smoke.py`, imports JAX, Flax or the reference package; and an entry
point asked for no device never falls back to the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from aclswarm_torch import sim

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aclswarm_tpu")
FILES = sorted((ROOT / "aclswarm_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _file_id(path: Path) -> str:
    """The file's name; under the analysis, telemetry, serve, utils and
    interop subpackages its path in the package, so a shared name
    (`registry.py`, `__init__.py`) leaves the other files' ids as they
    were."""
    if path.parent.name in ("analysis", "telemetry", "serve", "utils",
                            "interop"):
        return f"{path.parent.name}/{path.name}"
    return path.name


@pytest.mark.parametrize("path", FILES, ids=_file_id)
def test_no_reference_imports(path):
    assert not _imported(path) & set(FORBIDDEN), path


def test_scan_covers_the_package():
    names = {p.name for p in FILES}
    assert {"engine.py", "sinkhorn.py", "flood.py", "chip_smoke.py",
            "convert.py", "_build.py", "auction.py", "cbaa.py",
            "masking.py", "admm.py", "params.py", "trials.py",
            "supervisor.py", "formations.py", "checkpoint.py", "crash.py",
            "config.py", "summary.py", "prng.py", "schedule.py",
            "timeline.py", "registry.py", "invariants.py", "device.py",
            "spans.py", "locks.py", "review.py", "rosbag1.py",
            "executor.py", "retry.py", "lifecycle.py", "staging.py",
            "service.py", "workers.py", "admission.py", "api.py",
            "stats.py", "client.py", "smoke.py", "lapjv.py", "log.py",
            "timeseries.py", "slo.py", "postmortem.py", "watch.py",
            "messages.py", "codec.py", "native.py", "transport.py",
            "wire.py", "traffic.py", "procworker.py", "router.py",
            "cbaa_ref.py", "planner.py", "bridge.py", "operator.py",
            "viz_markers.py", "ros_fakes.py", "ros_bridge.py", "timing.py",
            "reference.py", "sdp.py", "precalc.py", "libgen.py",
            "replay.py", "overhead.py", "viz.py", "liveplot.py"} <= names
    assert (ROOT / "aclswarm_torch" / "core" / "registry.py") in FILES
    assert ROOT / "aclswarm_torch" / "resilience" / "smoke.py" in FILES
    for sub in ("analysis", "telemetry", "serve", "utils", "interop"):
        assert ROOT / "aclswarm_torch" / sub / "__init__.py" in FILES


def test_telemetry_package_init_stays_stdlib_only():
    """As the reference's: importing `aclswarm_torch.telemetry` pulls in
    neither torch nor numpy (the device counters are imported
    explicitly)."""
    pkg = ROOT / "aclswarm_torch" / "telemetry"
    for name in ("__init__.py", "registry.py", "spans.py",
                 "lifecycle.py", "timeseries.py", "slo.py", "postmortem.py",
                 "watch.py"):
        assert not _imported(pkg / name) & {"torch", "numpy"}, name
    # the registry's locks live where the reference keeps them
    assert not (pkg / "locks.py").exists()
    locks = ROOT / "aclswarm_torch" / "utils" / "locks.py"
    assert not _imported(locks) & {"torch", "numpy"}


def test_wire_modules_import_no_torch():
    """The wire boundary stays light, as the reference's: the interop
    modules and the wire front end import neither torch nor the engine
    (a bridge or a `watch --tcp` process speaks the wire without them)."""
    pkg = ROOT / "aclswarm_torch"
    for rel in ("interop/__init__.py", "interop/messages.py",
                "interop/codec.py", "interop/native.py",
                "interop/transport.py", "interop/ros_fakes.py",
                "serve/wire.py", "serve/traffic.py", "utils/log.py"):
        assert "torch" not in _imported(pkg / rel), rel


def test_init_state_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.init_state(np.zeros((4, 3)))
    state = sim.init_state(np.zeros((4, 3)), device="cpu")
    assert state.swarm.q.device.type == "cpu"


def test_run_trial_without_device_needs_the_card(monkeypatch):
    """`run_trial` with ``device=None`` and no card raises instead of
    flying the trial on the CPU."""
    from aclswarm_torch.harness import trials

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trials.TrialConfig(formation="simform6", verbose=False)
    assert cfg.device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        trials.run_trial(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        trials.run_trials(cfg)


def test_run_trial_batch_without_device_needs_the_card(monkeypatch):
    """The batched driver, like the serial one, raises with ``device=None``
    and no card instead of flying the wave on the CPU."""
    from aclswarm_torch.harness import trials

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trials.TrialConfig(formation="simform6", batch=2, trials=2,
                             chunk_ticks=120, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trials.run_trial_batch(cfg, [0, 1])
    with pytest.raises(RuntimeError, match="CUDA"):
        trials.run_trials(cfg)


def test_service_without_device_needs_the_card(monkeypatch):
    """`SwarmService(ServiceConfig())` with no card raises the
    `resolve_device` error instead of serving on the CPU; asked for the
    CPU, it serves there."""
    from aclswarm_torch.serve import ServiceConfig, SwarmService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ServiceConfig().device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        SwarmService(ServiceConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        SwarmService(ServiceConfig(), start=False)
    svc = SwarmService(ServiceConfig(device="cpu"), start=False)
    assert svc.device.type == "cpu" and svc.dtype == torch.float32
    svc.close(drain=False)


def test_planner_without_device_needs_the_card(monkeypatch):
    """`TorchPlanner(n)`, the bridge daemon's planner and the ROS node's
    own planner raise with no card instead of planning on the CPU; asked
    for the CPU, the planner runs there."""
    from aclswarm_torch.interop import ros_bridge
    from aclswarm_torch.interop.bridge import run_bridge
    from aclswarm_torch.interop.planner import TorchPlanner
    from aclswarm_torch.interop.ros_fakes import FakeMsgs, FakeRospy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchPlanner(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_bridge(4, ns="/asw-nodevice")
    with pytest.raises(RuntimeError, match="CUDA"):
        ros_bridge.run(FakeRospy(params={"/vehs": ["a", "b"]}), FakeMsgs)
    pl = TorchPlanner(4, device="cpu")
    assert pl.v2f.device.type == "cpu" and pl.dtype == torch.float32


def test_precalc_without_device_needs_the_card(monkeypatch, tmp_path):
    """`precalc.main` designs on the card unless ``--device`` names another
    device: with no card it raises and leaves the library as it was."""
    import shutil

    from aclswarm_torch.harness import formations, precalc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lib = tmp_path / "formations.yaml"
    shutil.copy(formations.DEFAULT_LIBRARY, lib)
    before = lib.read_bytes()
    with pytest.raises(RuntimeError, match="CUDA"):
        precalc.main(["--library", str(lib), "--group", "swarm4"])
    assert lib.read_bytes() == before
    precalc.main(["--library", str(lib), "--group", "swarm4",
                  "--device", "cpu"])


def test_resilience_smoke_without_device_needs_the_card(monkeypatch):
    """`resilience.smoke.main` (the smoke, its child and the overhead
    tool) raises with no card and no ``--device`` instead of running on
    the CPU."""
    from aclswarm_torch.resilience import smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--overhead"], ["--child", "--dir", "unused"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            smoke.main(argv)


def test_replay_record_without_device_needs_the_card(monkeypatch):
    """`replay_record` replays on the card unless asked for the CPU."""
    from aclswarm_torch.assignment import replay

    n = 4
    pts = np.stack([np.arange(n) * 5.0, np.zeros(n), np.zeros(n)], 1)
    rec = replay.AuctionRecord(q=pts + 0.1, points=pts,
                               adjmat=np.ones((n, n)) - np.eye(n),
                               v2f_prev=np.arange(n, dtype=np.int32),
                               v2f_new=np.arange(n, dtype=np.int32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        replay.replay_record(rec)
    with pytest.raises(RuntimeError, match="CUDA"):
        replay.replay_device(rec)
    out = replay.replay_record(rec, device="cpu")
    assert out["match"] and out["device_valid"]
