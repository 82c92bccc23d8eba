"""`torchcheck` layer 1 (`aclswarm_torch.analysis.lint`): every rule
JC001-JC004 and JC006 fires on its torch fixture (`tests/fixtures/
torchcheck/`) exactly where a line is annotated with it, both pragma
forms suppress, reachability keeps host-only code quiet, the port's
package reads zero violations, and every entry point the trace audit
registers (and `sim.engine.step`) is marked ``device-path``."""
import re
from pathlib import Path

import pytest
import torch

from aclswarm_torch.analysis import lint as lintmod
from aclswarm_torch.analysis import trace_audit as ta
from aclswarm_torch.sim import engine

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

FIXTURES = Path(__file__).parent / "fixtures" / "torchcheck"
PACKAGE = Path(__file__).parents[1] / "aclswarm_torch"
DEVICE_FIXTURES = ("bad_jc001.py", "bad_jc002.py", "bad_jc003.py",
                   "bad_jc004.py", "bad_jc006.py", "suppressed.py",
                   "disable_file.py")


def _by_file(violations):
    out = {}
    for v in violations:
        out.setdefault(Path(v.path).name, []).append(v)
    return out


@pytest.fixture(scope="module")
def fired():
    return _by_file(lintmod.lint_paths([FIXTURES / f
                                        for f in DEVICE_FIXTURES]))


@pytest.mark.parametrize("fixture,rule,count", [
    ("bad_jc001.py", "JC001", 6),
    ("bad_jc002.py", "JC002", 3),
    ("bad_jc003.py", "JC003", 4),
    ("bad_jc004.py", "JC004", 4),
    ("bad_jc006.py", "JC006", 4),
])
def test_rule_fires(fired, fixture, rule, count):
    vs = fired.get(fixture, [])
    assert [v.rule for v in vs] == [rule] * count, \
        f"{fixture}: expected {count}x{rule}, got {vs}"


def test_fixture_lines_match_annotations(fired):
    """Every violation lands on a line whose comment names its rule, and
    every line annotated ``# JCnnn (...)`` fires."""
    for fname in DEVICE_FIXTURES:
        src = (FIXTURES / fname).read_text().splitlines()
        lines = {v.line for v in fired.get(fname, [])}
        for v in fired.get(fname, []):
            assert v.rule in src[v.line - 1], \
                f"{fname}:{v.line} fired {v.rule} on an unannotated " \
                f"line: {src[v.line - 1]!r}"
        annotated = {i for i, line in enumerate(src, 1)
                     if re.search(r"# JC0\d\d \(", line)}
        assert annotated <= lines, (fname, sorted(annotated - lines))


def test_escape_hatch_suppresses(fired):
    assert "suppressed.py" not in fired


def test_file_level_pragma_suppresses(fired):
    assert "disable_file.py" not in fired


def test_pragma_disarmed_fires(tmp_path):
    """The suppressed fixtures do trip their rules without the pragmas."""
    for name in ("suppressed.py", "disable_file.py"):
        src = (FIXTURES / name).read_text()
        bare = re.sub(r"#\s*torchcheck:\s*disable(-file)?[^\n]*", "", src)
        f = tmp_path / name
        f.write_text(bare)
        rules = sorted({v.rule for v in lintmod.lint_paths([f])})
        assert rules == ["JC001", "JC002", "JC003"] if name == \
            "suppressed.py" else ["JC001", "JC004"], (name, rules)


def test_host_only_code_not_flagged(fired):
    """Reachability matters: host code making the same calls is legal."""
    for fname in ("bad_jc001.py", "bad_jc004.py"):
        src = (FIXTURES / fname).read_text().splitlines()
        for v in fired[fname]:
            assert "host_only" not in src[v.line - 1]
        assert all(v.line < src.index(next(
            ln for ln in src if ln.startswith("def host_only"))) + 1
            for v in fired[fname])


def test_one_report_per_site_across_call_paths(tmp_path):
    f = tmp_path / "multipath.py"
    f.write_text(
        "def helper(x):\n"
        "    return x.item()\n"
        "def root_a(x):  # torchcheck: device-path\n"
        "    def inner(y):\n"
        "        return helper(y)\n"
        "    return inner(x)\n"
        "def root_b(x):  # torchcheck: device-path\n"
        "    return helper(x)\n")
    vs = lintmod.lint_paths([f])
    assert [(v.line, v.rule) for v in vs] == [(2, "JC001")], vs


def test_nested_def_defaults_still_scanned(tmp_path):
    f = tmp_path / "nested_default.py"
    f.write_text(
        "def root(x):  # torchcheck: device-path\n"
        "    def inner(y=x.tolist()):\n"
        "        return y\n"
        "    return inner()\n")
    vs = lintmod.lint_paths([f])
    assert [(v.line, v.rule) for v in vs] == [(2, "JC001")], vs


def test_marker_on_a_signature_line(tmp_path):
    f = tmp_path / "signature.py"
    f.write_text(
        "def root(x,\n"
        "         y):  # torchcheck: device-path\n"
        "    return x.cpu()\n"
        "def host(x):\n"
        "    return x.cpu()\n")
    assert [(v.line, v.rule) for v in lintmod.lint_paths([f])] \
        == [(3, "JC001")]
    assert lintmod.device_functions([f]) == {"signature.root"}


def test_disable_file_all_rules(tmp_path):
    f = tmp_path / "vendored.py"
    f.write_text(
        "# torchcheck: disable-file\n"
        "def f(x):  # torchcheck: device-path\n"
        "    return x.item()\n")
    assert lintmod.lint_paths([f]) == []


def test_jc006_keyword_operand_checked(tmp_path):
    f = tmp_path / "kw.py"
    f.write_text(
        "# torchcheck: fault-aware-file\n"
        "import torch\n"
        "def g(q, alive):\n"
        "    return torch.sum(input=q)\n")
    assert [v.rule for v in lintmod.lint_paths([f])] == ["JC006"]


def test_jc006_module_scope(tmp_path):
    f = tmp_path / "elsewhere.py"
    f.write_text(
        "import torch\n"
        "def g(q, alive):\n"
        "    return torch.mean(q) + q.sum()\n")
    assert lintmod.lint_paths([f]) == []
    f2 = tmp_path / "opted_in.py"
    f2.write_text("# torchcheck: fault-aware-file\n" + f.read_text())
    assert [v.rule for v in lintmod.lint_paths([f2])] == ["JC006"]


def test_jc005_is_reserved():
    """Eager torch donates no buffer: the rule id stays reserved and no
    check emits it."""
    assert "JC005" in lintmod.RULES
    assert "reserved" in lintmod.RULES["JC005"]


def test_package_is_clean():
    """Zero unsuppressed violations across aclswarm_torch/."""
    violations = lintmod.lint_paths([PACKAGE])
    assert violations == [], "\n".join(str(v) for v in violations)


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x):  # torchcheck: device-path\n"
                   "    return x.item()\n")
    assert lintmod.main([str(bad)]) == 1
    assert lintmod.main([str(PACKAGE)]) == 0
    assert lintmod.main([str(FIXTURES / "bad_jc003.py")]) == 1


def test_every_pragma_names_its_reason():
    """A pragma in the port says why, on its own line: text follows the
    rule list."""
    pragma = re.compile(r"#\s*torchcheck:\s*disable(-file)?(=\S+)?(.*)$")
    seen = 0
    for path in PACKAGE.rglob("*.py"):
        if path.parent.name == "analysis" and path.name in (
                "lint.py", "concurrency.py", "protocol.py",
                "trace_audit.py"):
            continue        # the tools' own docstrings show the grammar
        for i, line in enumerate(path.read_text().splitlines(), 1):
            m = pragma.search(line)
            if m:
                seen += 1
                assert m.group(2) and len(m.group(3).strip()) >= 4, \
                    f"{path}:{i}: pragma without a reason: {line!r}"
    assert seen > 0


def _fq(fn) -> str:
    return f"{fn.__module__}.{fn.__qualname__}"


def test_registered_entries_are_device_path_roots():
    marked = lintmod.device_functions([PACKAGE])
    wanted = {_fq(e.fn) for e in ta.ENTRY_POINTS} | {_fq(engine.step)}
    assert wanted <= marked, sorted(wanted - marked)
