"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file."""

from __future__ import annotations

import json
import re

import pytest

from h100_bench import harness
from h100_bench.tests.tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "h100_bench/run.py"]
    assert SPEC["paths"] == ["h100_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    cells = [w["name"] for w in SPEC["workloads"]]
    for cell in cells:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if harness.applies(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in SPEC["per_layer"]
                 if harness.applies(m, cell) and m["moves"] in e2e]
        assert layer, cell
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(cells) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name_from_data(cell):
    c = harness.find_cell(cell)
    w = c.workload
    assert w["name"] == cell
    cfg = {x["name"]: x for x in SPEC["configs"]}[w["config"]]
    assert c.config == json.loads((ROOT / cfg["file"]).read_text())
    kind = harness.load_part(BENCH, "kinds", c.traffic["kind"])
    assert callable(kind.Driver) and callable(kind.check)
    assert callable(harness.load_part(BENCH, "scenes",
                                      c.config["scene"]["generator"]).generate)
    assert c.limits
    for m in c.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert callable(harness.load_reader(BENCH, m["name"]).read)


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        harness.find_cell("no_such.cell")


def test_fold_kernel_names_are_data():
    names = {k["trace_name"] for k in harness.fold_kernels(BENCH)}
    assert {"dense_resident_kernel", "dense_stream_kernel",
            "dense_super_kernel"} <= names
