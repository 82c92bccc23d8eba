"""BENCHMARK.json against the contract's shapes, and every file it names
found by name."""
import json
import re

import pytest

from swarmbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
        for text in (c["why"], c["source"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
            assert "\t" not in text
    metric_names = [e["name"] for e in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_entry_keys():
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_end_to_end_and_bounds():
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert set(e2e) == {"sim_s_per_s", "setup_s"}
    for e in e2e.values():
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell, BENCH)
    for key in ("batch", "assign_every", "chunk",
                "segment_ticks"):
        assert key in c.traffic
    assert c.traffic["chunk"] % c.traffic["assign_every"] == 0
    assert c.traffic["segment_ticks"] % c.traffic["chunk"] == 0
    assert c.workload["config"] == c.entry["config"]
    conf = next(x for x in BENCH["configs"] if x["name"] == c.entry["config"])
    assert c.config["reduced"] == conf["reduced"]
    assert c.config["source"] == conf["source"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_found_by_name(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert callable(harness.load_reader(metric).read)
    assert m["moves"] == "sim_s_per_s"
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    for cell in m["workloads"]:
        assert any(w["name"] == cell for w in BENCH["workloads"])


def test_each_cell_reports_a_per_layer_metric():
    for w in BENCH["workloads"]:
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
