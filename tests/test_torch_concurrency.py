"""The port's concurrency tier (`aclswarm_torch.analysis.concurrency`,
JC101-JC103) against the reference's: on the reference's fixtures (copied
under `tests/fixtures/torchcheck/` with only the lock import and the
pragma token changed, so every line number holds) the two tools report
the same ``(line, rule)`` lists; the port's host-side tree is clean; the
CLI exits as the reference's; and the port's device reads count as
blocking under a service lock."""
from pathlib import Path

import pytest
import torch

from aclswarm_torch.analysis import concurrency as port
from aclswarm_torch.analysis import lint as port_lint
from aclswarm_tpu.analysis import concurrency as ref

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

ROOT = Path(__file__).parent
REF_FIXTURES = ROOT / "fixtures" / "jaxcheck"
FIXTURES = ROOT / "fixtures" / "torchcheck"
PACKAGE = ROOT.parent / "aclswarm_torch"

# fixture -> the reference's count of its rule (tests/test_analysis.py)
COUNTS = {"bad_jc101.py": ("JC101", 3), "bad_jc102.py": ("JC102", 4),
          "bad_jc103.py": ("JC103", 8)}


def _lines(violations):
    return [(v.line, v.rule) for v in violations]


@pytest.mark.parametrize("fixture", list(COUNTS))
def test_same_findings_as_reference(fixture):
    want = _lines(ref.check_paths([REF_FIXTURES / fixture]))
    got = _lines(port.check_paths([FIXTURES / fixture]))
    rule, count = COUNTS[fixture]
    assert got == want == [(line, rule) for line, _ in want]
    assert len(got) == count


def test_fixture_copies_differ_only_in_import_and_token():
    for fixture in COUNTS:
        a = (REF_FIXTURES / fixture).read_text().splitlines()
        b = (FIXTURES / fixture).read_text().splitlines()
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.replace("aclswarm_tpu.utils.locks",
                             "aclswarm_torch.utils.locks").replace(
                "# jaxcheck:", "# torchcheck:") == y


def test_host_dirs_are_clean():
    """Zero unsuppressed JC101-JC103 across the port's serve/,
    telemetry/, resilience/ and interop/."""
    paths = port.default_paths()
    assert {p.name for p in paths} == {"serve", "telemetry", "resilience",
                                      "interop"}
    violations = port.check_paths(paths)
    assert violations == [], "\n".join(str(v) for v in violations)


def _bad_service(tmp_path, package):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import threading, time\n"
        f"from {package}.utils.locks import OrderedLock\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._lock = OrderedLock('serve.x')\n"
        "    def f(self):\n"
        "        with self._lock:\n"
        "            time.sleep(1)\n")
    return bad


def test_cli_exit_codes(tmp_path):
    assert port.main([str(_bad_service(tmp_path, "aclswarm_torch"))]) == 1
    assert ref.main([str(_bad_service(tmp_path, "aclswarm_tpu"))]) == 1
    assert port_lint.main(["--concurrency", str(PACKAGE / "serve")]) == 0


def test_device_reads_block_under_a_service_lock(tmp_path):
    """A read that waits for the card's queue parks every thread queued on
    the service lock: `.item()`, `.cpu()`, `torch.cuda.synchronize()` and
    an event's `.synchronize()` under it are JC103; outside it, nothing."""
    f = tmp_path / "reads.py"
    f.write_text(
        "import torch\n"
        "from aclswarm_torch.utils.locks import OrderedLock\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._lock = OrderedLock('serve.service')\n"
        "    def f(self, x, ev):\n"
        "        with self._lock:\n"
        "            a = x.item()\n"
        "            b = x.cpu()\n"
        "            torch.cuda.synchronize()\n"
        "            ev.synchronize()\n"
        "        return a, b, x.tolist()\n")
    assert _lines(port.check_paths([f])) == [
        (8, "JC103"), (9, "JC103"), (10, "JC103"), (11, "JC103")]


def test_pragma_with_a_reason_suppresses(tmp_path):
    f = tmp_path / "waived.py"
    f.write_text(
        "import time\n"
        "from aclswarm_torch.utils.locks import OrderedLock\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._lock = OrderedLock('serve.x')\n"
        "    def f(self):\n"
        "        with self._lock:\n"
        "            time.sleep(1)  # torchcheck: disable=JC103 a test\n")
    assert port.check_paths([f]) == []
