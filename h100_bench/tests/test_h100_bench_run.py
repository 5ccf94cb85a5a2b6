"""Whole runs at test size on the CPU (the harness's look for a card
skipped), the entry's refusals, and the imports."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h100_bench import harness
from h100_bench.tests import tiny

SEED = 2 ** 31 + 12345   # past 32 signed bits, as the driver's are


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False, seed=SEED):
    torch.set_num_threads(2)
    return harness.run(cell, seed, 0.5, trace, device="cpu",
                       **tiny.where(root))


@pytest.mark.parametrize("cell,e2e", [
    ("tiny_col.pt", {"mrays_per_s", "pass_ms_p95", "setup_s"}),
    ("tiny_col.tr", {"step_ms", "setup_s"})])
def test_last_line_schema(root, cell, e2e):
    line = _run(root, cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == e2e
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)


def test_traced_line_has_layers_and_breakdown(root):
    line = _run(root, "tiny_col.pt", trace=True)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
    # on the CPU the device trace is empty: its readers return nothing
    assert set(line["metrics"]) == {"packets_ms_per_sample.render"}
    assert line["correct"] is True


def test_same_seed_same_outputs(root):
    a = harness.measure("tiny_cb.bd", 7, 0.2, False, "cpu",
                        **tiny.where(root)).outputs
    b = harness.measure("tiny_cb.bd", 7, 0.2, False, "cpu",
                        **tiny.where(root)).outputs
    assert torch.equal(a["idx"], b["idx"])
    n = min(a["images"][-1][1], b["images"][-1][1])
    if n == a["images"][-1][1] == b["images"][-1][1]:
        assert torch.equal(a["images"][-1][2], b["images"][-1][2])


def _digest(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_new_cell_added_as_files_alone(tmp_path):
    root = tiny.make_root(tmp_path)
    before = _digest(root)
    bench = root / "h100_bench"
    cfg = json.loads((bench / "configs" / "cornell_sphere.json").read_text())
    cfg["scene"]["args"]["subdiv"] = 1
    (bench / "configs" / "new_cb.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "pt_16.json").write_text(json.dumps(dict(
        kind="progressive", size=16, samples_per_pass=1, passes_per_image=0,
        trace_steps=1, check_pixels=64)))
    (bench / "limits" / "new_cb.pt_16.json").write_text(
        json.dumps({"pixels_off_pct": 30.0}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="new_cb", source="https://example.org",
                                file="h100_bench/configs/new_cb.json",
                                reduced=[], why="a new configuration"))
    spec["workloads"].append(dict(name="new_cb.pt_16", config="new_cb",
                                  traffic="pt_16", chips=1, why="new"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "colonnade.ptnee_1024" in m.get("workloads", []):
            m["workloads"].append("new_cb.pt_16")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(root)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {Path("BENCHMARK.json")}
    cell = harness.find_cell("new_cb.pt_16", **tiny.where(root))
    assert cell.config["scene"]["args"]["subdiv"] == 1
    line = _run(root, "new_cb.pt_16")
    assert line["correct"] is True
    assert set(line["metrics"]) == {"mrays_per_s", "pass_ms_p95", "setup_s"}


def test_new_kind_and_scene_added_as_files_alone(tmp_path):
    """A mix of a kind no file had yet, over a scene no generator made yet:
    new files and entries, and no existing file edited."""
    root = tiny.make_root(tmp_path)
    before = _digest(root)
    bench = root / "h100_bench"
    (bench / "scenes" / "open_box.py").write_text(
        "from h100_bench.meshes import cornell_box\n\n\n"
        "def generate():\n"
        "    return cornell_box(with_boxes=False)\n")
    (bench / "kinds" / "preview.py").write_text(
        "from h100_bench.kinds import progressive\n"
        "from h100_bench.kinds.progressive import check, control_readings"
        "  # noqa: F401\n\n\n"
        "class Driver(progressive.Driver):\n"
        "    \"\"\"Every pass a fresh image.\"\"\"\n\n"
        "    def __init__(self, *args):\n"
        "        super().__init__(*args)\n"
        "        self.per_image = 1\n")
    cfg = json.loads((bench / "configs" / "cornell_sphere.json").read_text())
    cfg["scene"] = {"generator": "open_box", "args": {}}
    (bench / "configs" / "open_box.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "preview_16.json").write_text(json.dumps(dict(
        kind="preview", size=16, samples_per_pass=1, trace_steps=1,
        check_pixels=64)))
    (bench / "limits" / "open_box.preview_16.json").write_text(
        json.dumps({"pixels_off_pct": 30.0}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="open_box", source="https://example.org",
                                file="h100_bench/configs/open_box.json",
                                reduced=[], why="a new scene"))
    spec["workloads"].append(dict(name="open_box.preview_16",
                                  config="open_box", traffic="preview_16",
                                  chips=1, why="new"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "cornell_sphere.bdpt_512" in m.get("workloads", []):
            m["workloads"].append("open_box.preview_16")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(root)
    assert {p for p in before if before[p] != after[p]} == \
        {Path("BENCHMARK.json")}
    m = harness.measure("open_box.preview_16", SEED, 0.3, False, "cpu",
                        **tiny.where(root))
    assert m.arrays["tris"].shape[0] == 12
    # the last finished image and the next, once a second pass has run
    assert len(m.outputs["images"]) == min(m.steps, 2)
    line = _run(root, "open_box.preview_16")
    assert line["correct"] is True
    assert set(line["metrics"]) == {"mrays_per_s", "pass_ms_p95", "setup_s"}


def _entry(args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "h100_bench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


ARGS = ["--workload", "colonnade.ptnee_1024", "--seed", str(SEED),
        "--seconds", "1", "--trace", "0"]


def test_a_run_without_a_card_fails_and_prints_nothing():
    p = _entry(ARGS, tiny.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_run_without_the_program_fails(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _entry(ARGS, tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_no_jax_in_a_run(root):
    """A whole run in a fresh process: no module whose top-level name is
    jax, jaxlib, flax or the JAX package is loaded."""
    code = (
        "import sys, json, torch; torch.set_num_threads(1)\n"
        "from h100_bench import harness\n"
        f"line = harness.run('tiny_col.pt', 5, 0.2, False, 'cpu', "
        f"root={str(root)!r}, bench_dir={str(root / 'h100_bench')!r})\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cudapathtracer_tpu_torch_x", sys)
    assert "cudapathtracer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cudapathtracer_tpu.sub", sys)
    assert harness.forbidden_modules() == ["cudapathtracer_tpu"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (tiny.BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "cudapathtracer_tpu",
                               "cudapathtracer_tpu_torch"), (path, name)


def test_no_benchmark_file_imports_jax():
    for path in tiny.BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "cudapathtracer_tpu"), path


@pytest.mark.cuda
def test_one_run_on_the_card():
    """A short run of the first cell on the card, from the entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "h100_bench/run.py", *ARGS],
                       cwd=tiny.ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
