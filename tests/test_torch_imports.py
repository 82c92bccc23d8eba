"""The port stands alone: nothing under `aclswarm_torch/`, and not
`chip_smoke.py`, imports JAX, Flax or the reference package; and an entry
point asked for no device never falls back to the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from aclswarm_torch import sim

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


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_reference_imports(path):
    assert not _imported(path) & set(FORBIDDEN), path


def test_scan_covers_the_package():
    names = {p.name for p in FILES}
    assert {"engine.py", "sinkhorn.py", "flood.py", "chip_smoke.py",
            "convert.py", "_build.py", "auction.py", "cbaa.py",
            "masking.py", "admm.py", "params.py"} <= names


def test_init_state_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.init_state(np.zeros((4, 3)))
    state = sim.init_state(np.zeros((4, 3)), device="cpu")
    assert state.swarm.q.device.type == "cpu"
