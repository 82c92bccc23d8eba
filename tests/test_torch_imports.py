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
    """The file's name; under the analysis and telemetry subpackages its
    path in the package, so a shared name (`registry.py`, `__init__.py`)
    leaves the other files' ids as they were."""
    if path.parent.name in ("analysis", "telemetry"):
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
            "spans.py", "locks.py", "review.py", "rosbag1.py"} <= names
    for sub in ("analysis", "telemetry"):
        assert ROOT / "aclswarm_torch" / sub / "__init__.py" in FILES


def test_telemetry_package_init_stays_stdlib_only():
    """As the reference's: importing `aclswarm_torch.telemetry` pulls in
    neither torch nor numpy (the device counters are imported
    explicitly)."""
    pkg = ROOT / "aclswarm_torch" / "telemetry"
    for name in ("__init__.py", "registry.py", "spans.py", "locks.py"):
        assert not _imported(pkg / name) & {"torch", "numpy"}, name


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
