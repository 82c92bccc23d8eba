"""The port's library tools (`aclswarm_torch.harness.libgen` and
`.precalc`) against the reference package's: each package regenerates
its own copy of the library (libgen, then precalc in float64 on the CPU)
and the two files agree, gains within 1e-11 and everything else equal."""
import shutil

import numpy as np
import pytest
import torch
import yaml

from aclswarm_torch.harness import formations as t_formations
from aclswarm_torch.harness import libgen as t_libgen
from aclswarm_torch.harness import precalc as t_precalc
from aclswarm_tpu.harness import formations as j_formations
from aclswarm_tpu.harness import libgen as j_libgen
from aclswarm_tpu.harness import precalc as j_precalc

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers


def _split_gains(lib: dict):
    """(the library without its gains, {(group, formation): gains})."""
    gains = {}
    for g, group in lib.items():
        if not isinstance(group, dict):
            continue
        for k, f in enumerate(group["formations"]):
            if "gains" in f:
                gains[(g, k)] = np.asarray(f.pop("gains"), np.float64)
    return lib, gains


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    """Each package's libgen then precalc on its own copy of its own
    library (float64, CPU)."""
    d = tmp_path_factory.mktemp("libs")
    t_lib, j_lib = d / "torch.yaml", d / "jax.yaml"
    shutil.copy(t_formations.DEFAULT_LIBRARY, t_lib)
    shutil.copy(j_formations.DEFAULT_LIBRARY, j_lib)
    t_libgen.extend_library(t_lib, verbose=False)
    designs = t_precalc.precalc(t_lib, verbose=False, device="cpu")
    j_libgen.extend_library(j_lib, verbose=False)
    j_precalc.precalc(j_lib, verbose=False)
    return t_lib, j_lib, designs


def test_header_is_the_references():
    assert t_precalc.HEADER == j_precalc.HEADER


def test_build_groups_equal():
    assert t_libgen.build_groups() == j_libgen.build_groups()


def test_shipped_libraries_equal():
    """The port's library copy is the reference's file byte for byte."""
    assert t_formations.DEFAULT_LIBRARY.read_bytes() == \
        j_formations.DEFAULT_LIBRARY.read_bytes()


def test_regenerated_libraries_agree(regenerated):
    t_lib, j_lib, _ = regenerated
    t_rest, t_gains = _split_gains(_load(t_lib))
    j_rest, j_gains = _split_gains(_load(j_lib))
    assert t_rest == j_rest
    assert t_gains.keys() == j_gains.keys() and len(t_gains) == 12
    for key in t_gains:
        np.testing.assert_allclose(t_gains[key], j_gains[key], rtol=0,
                                   atol=1e-11, err_msg=str(key))


def test_regeneration_keeps_the_comment_lines(regenerated):
    """A regeneration rewrites the header byte for byte: the comment
    lines of the regenerated file are the shipped file's."""
    t_lib, _, _ = regenerated

    def comments(path):
        return [ln for ln in path.read_text().splitlines()
                if ln.startswith("#")]

    assert comments(t_lib) == comments(t_formations.DEFAULT_LIBRARY)


def test_regenerated_gains_are_the_shipped_ones(regenerated):
    t_lib, _, designs = regenerated
    _, shipped = _split_gains(_load(t_formations.DEFAULT_LIBRARY))
    _, regen = _split_gains(_load(t_lib))
    assert regen.keys() == shipped.keys()
    for key in shipped:
        np.testing.assert_allclose(regen[key], shipped[key], rtol=0,
                                   atol=1e-11, err_msg=str(key))
    # the designs validate, and precalc reports each one
    assert len(designs) == 12
    assert all(d["no_positive"] and d["kernel_ok"]
               and d["strictly_negative_rest"] for d in designs)


@pytest.fixture
def stripped(tmp_path):
    """A copy of the library with every gains entry removed."""
    lib, _ = _split_gains(_load(t_formations.DEFAULT_LIBRARY))
    path = tmp_path / "formations.yaml"
    with open(path, "w") as f:
        f.write(t_precalc.HEADER)
        yaml.safe_dump(lib, f, sort_keys=False, default_flow_style=None,
                       width=10000)
    return path


def test_group_is_honoured(stripped, capsys):
    """``--group`` designs that group only."""
    t_precalc.main(["--library", str(stripped), "--group", "grid9",
                    "--device", "cpu"])
    _, gains = _split_gains(_load(stripped))
    assert sorted(gains) == [("grid9", 0), ("grid9", 1)]
    assert "grid9/Grid: gains (27, 27) OK" in capsys.readouterr().out


def test_precalc_gains_false_is_skipped(stripped, capsys):
    designs = t_precalc.precalc(stripped, group="swarm100", device="cpu")
    assert designs == []
    assert "swarm100: precalc_gains=false, skipped" in \
        capsys.readouterr().out
    lib = _load(stripped)
    assert not any("gains" in f for f in lib["swarm100"]["formations"])


def test_failed_validation_raises(tmp_path):
    """A formation whose design fails the eigenstructure check (a square
    on a path graph: not rigid) raises, and the file stays as it was."""
    path = tmp_path / "bad.yaml"
    path.write_text(yaml.safe_dump({"bad4": {
        "agents": 4,
        "adjmat": [[0, 1, 0, 0], [1, 0, 1, 0], [0, 1, 0, 1], [0, 0, 1, 0]],
        "formations": [{"name": "Square",
                        "points": [[0, 0, 0], [2, 0, 0], [2, 2, 0],
                                   [0, 2, 0]]}]}}))
    before = path.read_bytes()
    with pytest.raises(RuntimeError, match="bad4/Square"):
        t_precalc.precalc(path, verbose=False, device="cpu")
    assert path.read_bytes() == before
