"""The shape-fitting cell on the CPU: ``cornell_shape.edges_256`` found by
name, and its kind (``kinds/train_edges.py``) driven by files alone on a
tiny copy of its configuration, checked against ``reference/edges.py``;
the new readers on records made by hand."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from h100_bench import harness
from h100_bench.tests import tiny

SEED = 2 ** 31 + 12345
CELL = "tiny_shape.edges_16"


def test_the_cell_is_found_by_name():
    cell = harness.find_cell("cornell_shape.edges_256")
    assert cell.workload["chips"] == 1
    assert cell.traffic["kind"] == "train_edges"
    assert cell.traffic["edge_samples"] == 65536
    assert cell.traffic["shadow_edge_samples"] == 65536
    assert cell.config["scene"]["args"]["subdiv"] == 5
    assert cell.config["target"]["args"]["subdiv"] == 5
    assert {m["name"] for m in cell.end_to_end} == {"step_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle_pct.train", "bwd_ms.train", "recompute_ms.train",
        "edges_ms.train", "edges_kept_pct.train"}
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    desc = harness.make_scene(cell.bench_dir, cell.config["scene"])
    assert desc["tris"].shape[0] == cell.config["triangles"] == 20516


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny tree with a copy of cornell_shape at subdiv 1, a 16^2 mix
    of the new kind and its limits, as files and entries alone."""
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    bench = root / "h100_bench"
    cfg = json.loads((bench / "configs" / "cornell_shape.json").read_text())
    for part in ("scene", "target"):
        cfg[part]["args"]["subdiv"] = 1
    (bench / "configs" / "tiny_shape.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "edges_16.json").write_text(json.dumps(dict(
        kind="train_edges", size=16, samples_per_step=1, edge_samples=256,
        shadow_edge_samples=256, lr=1e-4, first_steps=2, trace_steps=1)))
    # the program's readings at this size: 0 to 1.3e-3 (five seeds); the
    # control's and the faults': 0.03 to 1.0 (my CPU runs)
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"loss_gap": 0.01, "grad_gap": 0.005, "change_gap": 0.01}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="tiny_shape",
                                source="https://example.org",
                                file="h100_bench/configs/tiny_shape.json",
                                reduced=[], why="test size"))
    spec["workloads"].append(dict(name=CELL, config="tiny_shape",
                                  traffic="edges_16", chips=1, why="test"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "cornell_shape.edges_256" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_the_kind_runs_from_files_alone(root):
    torch.set_num_threads(2)
    m = harness.measure(CELL, SEED, 0.2, False, "cpu", **tiny.where(root))
    assert m.steps >= 1
    names = m.outputs["names"]
    assert names[-3:] == ["hero.x", "hero.y", "hero.z"]
    hero = 10 * 4 + 2
    verts = m.outputs["grads"][0]
    assert torch.equal(m.outputs["grads"][names.index("hero.x")],
                       verts[-hero:])
    # the target is the moved hero's scene, the same topology
    moved = (m.outputs["target_verts"] - m.arrays["verts"]).abs().amax(1)
    assert (moved[:-hero] == 0).all() and (moved[-hero:] > 0).all()
    numbers = m.kind.check(m.outputs, m.cell.config, m.cell.traffic,
                           m.arrays)
    assert set(numbers) == {"loss_gap", "grad_gap", "change_gap"}
    assert all(v <= m.cell.limits[k] for k, v in numbers.items()), numbers


def test_the_control_and_the_faults_read_past_the_limits(root):
    torch.set_num_threads(2)
    m = harness.measure(CELL, SEED + 1, 0.2, False, "cpu",
                        **tiny.where(root))
    r = m.kind.control_readings(m.outputs, m.cell.config, m.cell.traffic,
                                m.arrays)
    assert set(r["faults"]) == {"boundary terms left out",
                                "edge weights x 1.05"}
    lim = m.cell.limits
    for name, numbers in [("control", r["control"]), *r["faults"].items()]:
        assert any(v > lim[k] for k, v in numbers.items()), (name, numbers)


def test_a_run_line(root):
    torch.set_num_threads(2)
    line = harness.run(CELL, SEED, 0.3, False, device="cpu",
                       **tiny.where(root))
    assert line["correct"] is True
    assert set(line["metrics"]) == {"step_ms", "setup_s"}


def _rec(kind, name, id_, parent, root, attrs=None, n=None, ms=None):
    return SimpleNamespace(kind=kind, name=name, id=id_, parent=parent,
                           root=root, attrs=attrs or {}, n=n, device_ms=ms,
                           start_ns=0, end_ns=0)


def test_the_readers_on_records():
    edges_ms = harness.load_reader(tiny.BENCH, "edges_ms.train")
    kept = harness.load_reader(tiny.BENCH, "edges_kept_pct.train")
    recs = [
        _rec("span", "diff.forward", 0, None, 0, ms=9.0),   # the target
        _rec("span", "diff.forward", 1, None, 1, ms=50.0),
        _rec("count", "edges.drawn", 2, 3, 1, n=100),
        _rec("count", "edges.kept", 4, 3, 1, n=4),
        _rec("span", "diff.edges.primary", 3, 1, 1, ms=10.0),
        _rec("count", "edges.drawn", 5, 6, 1, n=100),
        _rec("count", "edges.kept", 7, 6, 1, n=2),
        _rec("span", "diff.edges.shadow", 6, 1, 1, ms=5.0),
        _rec("span", "diff.forward", 8, None, 8, ms=60.0),
        _rec("span", "diff.edges.primary", 9, 8, 8, ms=20.0),
        _rec("span", "diff.edges.shadow", 10, 8, 8, ms=7.0),
        _rec("span", "diff.recompute", 11, None, 11, ms=3.0),
    ]
    assert edges_ms.edges_ms(recs) == pytest.approx((15.0 + 27.0) / 2)
    assert kept.edges_kept_pct(recs) == pytest.approx(3.0)
    assert kept.edges_kept_pct(recs[:2]) is None
    assert edges_ms.edges_ms(recs[:2]) is None
