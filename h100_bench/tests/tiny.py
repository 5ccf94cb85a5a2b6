"""A benchmark tree at test size: the files found by name (metrics, fold
kernels, configurations, mixes, limits, kinds, scenes) copied into a
temporary root, and four cells beside the real ones that run on the CPU
in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
DATA = ("configs", "traffic", "limits", "metrics", "fold_kernels",
        "kinds", "scenes")

# name: (config, base configuration, scene arguments, mix, the real cell
# whose metrics it reports, the limits at this size); a name ending in
# ".x4" runs on four ranks; the limits are set
# from the readings at this size: the program's (0-6.3% of pixels off,
# 1e-7-1e-5 in the train numbers) and the control's (23-36% of pixels off,
# 0.38-1.0 in the train numbers)
CELLS = {
    "tiny_col.pt": ("tiny_col", "colonnade", {"subdiv": 0},
                    dict(kind="progressive", size=16, samples_per_pass=1,
                         passes_per_image=0, trace_steps=2,
                         check_pixels=128),
                    "colonnade.ptnee_1024", {"pixels_off_pct": 5.0}),
    "tiny_cb.bd": ("tiny_cb", "cornell_sphere", {"subdiv": 2},
                   dict(kind="progressive", size=32, samples_per_pass=1,
                        passes_per_image=3, trace_steps=2,
                        check_pixels=256),
                   "cornell_sphere.bdpt_512", {"pixels_off_pct": 15.0}),
    "tiny_col.tr": ("tiny_col", "colonnade", {"subdiv": 0},
                    dict(kind="train", size=8, samples_per_step=1, lr=1e-4,
                         first_steps=3, trace_steps=1),
                    "colonnade.train_256",
                    {"loss_gap": 0.01, "grad_gap": 0.005,
                     "change_gap": 0.01}),
    "tiny_col.x4": ("tiny_col", "colonnade", {"subdiv": 0},
                    dict(kind="progressive", size=16, samples_per_pass=1,
                         passes_per_image=0, trace_steps=2,
                         check_pixels=128),
                    "colonnade.ptnee_1024", {"pixels_off_pct": 5.0}),
}


def make_root(tmp: Path) -> Path:
    """-> a root holding BENCHMARK.json and h100_bench's data files, with
    the tiny cells added as files and entries only."""
    bench = tmp / "h100_bench"
    for d in DATA:
        shutil.copytree(BENCH / d, bench / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {}
    for cell, (cfg, base, args, mix, like, limits) in CELLS.items():
        if cfg not in configs:
            c = json.loads((BENCH / "configs" / f"{base}.json").read_text())
            c["scene"]["args"].update(args)
            (bench / "configs" / f"{cfg}.json").write_text(json.dumps(c))
            configs[cfg] = dict(name=cfg, source="https://example.org",
                                file=f"h100_bench/configs/{cfg}.json",
                                reduced=[], why="test size")
        mix_name = cell.replace(".", "_")
        (bench / "traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        chips = 4 if cell.endswith(".x4") else 1
        spec["workloads"].append(dict(name=cell, config=cfg,
                                      traffic=mix_name, chips=chips,
                                      why="test size"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    spec["configs"] += list(configs.values())
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


def where(root: Path) -> dict:
    return dict(root=root, bench_dir=root / "h100_bench")
