"""What the benchmark may import and read, and its refusal to run
without a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import json

import pytest
import torch

from swarmbench import harness

CELL = harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"][0][
    "name"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this check runs on the card")
    return torch.device("cuda")


FILES = sorted(harness.HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "aclswarm_tpu"}


def imported_top_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax_and_no_reference_package(path):
    assert not imported_top_names(path) & FORBIDDEN
    needle = "bench" + "marks/"     # the frozen suite's folder
    assert needle not in path.read_text().replace("swarm" + needle, "")


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")) + [
        harness.HERE / "traffic" / "formgen.py",
        harness.HERE / "roofline.py"], ids=lambda p: p.name)
def test_yardstick_imports_nothing_of_the_program(path):
    assert "aclswarm_torch" not in imported_top_names(path)


def test_run_exits_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         CELL, "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_check_of_loaded_modules_compares_whole_names(monkeypatch):
    from swarmbench import run as runmod

    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert "jax" not in runmod.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert runmod.loaded_forbidden() == ["jax"]


def test_one_short_run_on_the_card(card, tmp_path):
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         CELL, "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        cwd=harness.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"] and res["device"]["platform"] == "gpu"
