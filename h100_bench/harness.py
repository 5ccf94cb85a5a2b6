"""One run of one cell: find the cell's files by the names in
``BENCHMARK.json``, set up, warm up, measure for the given seconds, check
the outputs against the plain reference, and build the result line.

Files, each found by a name in ``BENCHMARK.json``:

* ``<config file>`` (the ``file`` of the configuration): the scene
  generator and its arguments, the camera and the render settings;
* ``traffic/<traffic>.json``: the mix's ``kind`` and its parameters;
* ``kinds/<kind>.py``: what a mix of that kind drives and how its outputs
  are checked: ``Driver(config, traffic, seed, device, spans, mesh,
  scene)`` (``warm()``, ``step()`` -> samples, ``rays(samples)``,
  ``outputs()``, ``release()``, and ``arrays``, ``scene``, ``spp``),
  ``check(outputs, config, traffic, arrays)`` -> {number: value} and
  ``control_readings(...)`` (``control.py``);
* ``scenes/<generator>.py``: ``generate(**args)`` -> the host arrays of
  the configuration's ``scene`` (``{"generator", "args"}``);
* ``limits/<cell>.json``: the limit of each number the check compares;
* ``metrics/<per-layer metric>.py``: its reader, ``read(readings)``, which
  returns a number or None (nothing to read), and what it needs:
  ``SPANS`` ({span name: "module:attribute"} of program calls to time),
  ``FOLDS`` (the fold kernels' captured calls);
* ``fold_kernels/*.json``: each fold kernel's name as the device trace
  shows it, the packet engine's call into its wrapper, and whether that
  call passes a super factor.

With ``trace`` the window's first ``trace_steps`` steps run under
``torch.profiler`` (and the fold calls are captured), and the rest with
the spans timed; without it nothing is traced, timed inside a step, or
synchronized but at the end of each step.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import check, devtrace, drivers, timing

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cudapathtracer_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell(SimpleNamespace):
    """A cell and its files: ``workload``, ``config``, ``traffic``,
    ``limits``, ``end_to_end`` and ``per_layer`` (the metric entries it
    reports)."""


def find_cell(name: str, root=ROOT, bench_dir=BENCH_DIR) -> Cell:
    spec = load_json(Path(root) / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if m["moves"] in moved and applies(m, name)]
    bench_dir = Path(bench_dir)
    return Cell(workload=w, config=load_json(Path(root) / cfg["file"]),
                traffic=load_json(bench_dir / "traffic"
                                  / f"{w['traffic']}.json"),
                limits=load_json(bench_dir / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer, bench_dir=bench_dir)


def load_part(bench_dir, folder: str, name: str):
    """The module of ``<bench_dir>/<folder>/<name>.py``."""
    path = Path(bench_dir) / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py under {bench_dir}")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(bench_dir, name: str):
    return load_part(bench_dir, "metrics", name)


def make_scene(bench_dir, spec: dict) -> dict:
    """The host arrays of a configuration's ``{"generator", "args"}``."""
    return load_part(bench_dir, "scenes", spec["generator"]).generate(
        **spec.get("args", {}))


def fold_kernels(bench_dir) -> list:
    return [load_json(p) for p in
            sorted((Path(bench_dir) / "fold_kernels").glob("*.json"))]


def process_age() -> float:
    """Seconds since this process started, from /proc (0.01 s steps); the
    time since the interpreter imported this module where /proc has it
    not."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, chips: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    limits = smi.stdout.split()
    index = dev.index or 0
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(dev),
            "power_limit_w": float(limits[index]) if smi.returncode == 0
            and len(limits) > index else None}


def _agree(stop: bool, mesh) -> bool:
    """Rank 0's decision, on every rank of a mesh."""
    if mesh is None:
        return stop
    import torch.distributed as dist

    flag = torch.tensor([int(stop)], device=mesh.device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _loop(driver, seconds, t_start, samples=0, steps=0, durations=None,
          mesh=None):
    """Steps until ``seconds`` have passed since ``t_start`` (on a mesh,
    on rank 0's clock: every rank runs as many steps)."""
    while True:
        t0 = time.perf_counter()
        samples += driver.step()
        t1 = time.perf_counter()
        steps += 1
        if durations is not None:
            durations.append(t1 - t0)
        if _agree(t1 - t_start >= seconds, mesh):
            return samples, steps, t1 - t_start


def _mesh(device, rank: int, world: int, init):
    """-> (this rank's device, its TileMesh or None for one process)."""
    if world == 1:
        return torch.device(device), None
    from datetime import timedelta

    from cudapathtracer_tpu_torch.parallel.mesh import initialize_distributed

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
    mesh = initialize_distributed(init_method=init, world_size=world,
                                  rank=rank, device=dev,
                                  timeout=timedelta(seconds=600))
    return dev, mesh


def _over_ranks(info: dict, mesh) -> dict:
    """The fullest card's peak and the cards' mean busy and window."""
    if mesh is None:
        return info
    import torch.distributed as dist

    parts = [None] * mesh.world
    dist.all_gather_object(parts, info)
    out = dict(parts[0])
    out["memory_peak_bytes"] = max(p["memory_peak_bytes"] for p in parts)
    for k in ("busy_s", "window_s"):
        if k in out:
            out[k] = sum(p[k] for p in parts) / len(parts)
    return out


def measure(workload: str, seed: int, seconds: float, trace: bool,
            device="cuda", root=ROOT, bench_dir=BENCH_DIR, log=sys.stderr,
            rank=0, init=None):
    """Set-up, warm-up and the window of one run (of one rank of a cell on
    several cards, all started with one ``init`` address); the program's
    state is freed before it returns. -> the cell, the line's metrics,
    device and breakdown, the steps attempted, and the outputs to check
    with the scene's arrays; None on a rank but 0. Raises on a forbidden
    module."""
    cell = find_cell(workload, root, bench_dir)
    kind = load_part(bench_dir, "kinds", cell.traffic["kind"])
    device, mesh = _mesh(device, rank, cell.workload["chips"], init)
    readers = ({m["name"]: load_reader(bench_dir, m["name"])
                for m in cell.per_layer} if trace else {})
    spans = drivers.Spans(device)
    t_build = process_age()
    driver = kind.Driver(cell.config, cell.traffic, seed, device, spans,
                         mesh, make_scene(bench_dir, cell.config["scene"]))
    t_warm = process_age()
    folds = None
    if trace:
        for r in readers.values():
            for name, target in getattr(r, "SPANS", {}).items():
                spans.wrap(name, target)
        if any(getattr(r, "FOLDS", False) for r in readers.values()):
            folds = drivers.FoldCapture(fold_kernels(bench_dir))
            folds.install(spans)
    driver.warm()
    setup_s = process_age()
    print(f"# set-up {setup_s:.2f} s: to the cell's build {t_build:.2f}, "
          f"build {t_warm - t_build:.2f}, warm-up {setup_s - t_warm:.2f}",
          file=log)
    durations, summary = [], None
    if not trace:
        samples, steps, window_s = _loop(driver, seconds,
                                         time.perf_counter(),
                                         durations=durations, mesh=mesh)
    else:
        span_samples, span_steps, summary = _traced(driver, cell, spans,
                                                    folds, device, seconds,
                                                    mesh)
        steps = span_steps + cell.traffic["trace_steps"]
    info = device_info(device, cell.workload["chips"])
    if trace:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    info = _over_ranks(info, mesh)
    spans.unwrap()
    found = forbidden_modules()
    if rank:
        driver.release()
        import torch.distributed as dist

        dist.destroy_process_group()
    if found:
        raise RuntimeError(f"modules loaded in the run of rank {rank}: "
                           f"{found}")
    if rank:
        return None

    metrics = {}
    if not trace:
        values = {
            "setup_s": setup_s,
            "mrays_per_s": driver.rays(samples) / window_s / 1e6,
            "pass_ms_p95": timing.percentile(durations, 95) * 1e3,
            "step_ms": window_s / steps * 1e3,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        q = [timing.percentile(durations, p) * 1e3 for p in (0, 25, 50, 75,
                                                                 100)]
        print(f"# window {window_s:.3f} s, {steps} steps, {samples} "
              f"samples, set-up {setup_s:.3f} s; step ms min, quartiles, "
              f"max {' '.join(f'{v:.2f}' for v in q)}", file=log)
    else:
        num_tris = driver.scene.num_tris
        readings = SimpleNamespace(
            trace=summary, spans=spans.seconds,
            samples=span_samples, steps=span_steps,
            traced_samples=cell.traffic["trace_steps"] * driver.spp,
            traced_steps=cell.traffic["trace_steps"],
            folds=folds.bounds(num_tris) if folds else {},
            fold_kernels=fold_kernels(bench_dir))
        for m in cell.per_layer:
            v = readers[m["name"]].read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        print(f"# traced window {summary.window_s:.6f} s, busy "
              f"{summary.busy_s:.6f} s, {summary.device_events} device "
              f"events; folds {readings.folds}", file=log)

    outputs = driver.outputs()
    arrays = driver.arrays
    driver.release()
    del driver
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    breakdown = None if not trace else {
        "device_ops": timing.top(summary.device_s),
        "idle_gaps": timing.top(summary.idle_s)}
    return SimpleNamespace(cell=cell, kind=kind, metrics=metrics, info=info,
                           breakdown=breakdown, steps=steps,
                           outputs=outputs, arrays=arrays)


def rank_main(workload, seed, seconds, trace, device, root, bench_dir, rank,
              init):
    """A rank but 0 of a cell on several cards, in a process of its own;
    raises (the process exits with 1) on a forbidden module."""
    torch.set_num_threads(1)
    measure(workload, seed, seconds, trace, device, root, bench_dir,
            sys.stderr, rank, init)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def measure_all(workload: str, seed: int, seconds: float, trace: bool,
                device="cuda", root=ROOT, bench_dir=BENCH_DIR,
                log=sys.stderr, rank_target=rank_main):
    """``measure`` on every rank of the cell: rank 0 here, each other rank
    as ``rank_target`` in a spawned process; waits for every one and stops
    any left. Raises where a rank failed."""
    import multiprocessing

    world = find_cell(workload, root, bench_dir).workload["chips"]
    init = f"tcp://localhost:{_free_port()}" if world > 1 else None
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=rank_target,
                         args=(workload, seed, seconds, trace, device,
                               root, bench_dir, r, init))
             for r in range(1, world)]
    for p in ranks:
        p.start()
    try:
        m = measure(workload, seed, seconds, trace, device, root, bench_dir,
                    log, 0, init)
    finally:
        for p in ranks:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    failed = [r for r, p in enumerate(ranks, 1) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} failed")
    return m


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", root=ROOT, bench_dir=BENCH_DIR, log=sys.stderr,
        rank_target=rank_main):
    """One run. -> the result line's dict; raises on a forbidden module or
    a failed rank."""
    m = measure_all(workload, seed, seconds, trace, device, root, bench_dir,
                    log, rank_target)
    numbers = m.kind.check(m.outputs, m.cell.config, m.cell.traffic,
                           m.arrays)
    correct, checks = check.verdict(numbers, m.cell.limits)
    line = {"correct": correct, "attempted": m.steps, "failed": 0,
            "metrics": m.metrics, "device": m.info}
    if m.breakdown is not None:
        line["breakdown"] = m.breakdown
    line["checks"] = checks
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded in the run: {found}")
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=log)
    return line


def _traced(driver, cell, spans, folds, device, seconds, mesh=None):
    """The traced run's window: ``trace_steps`` steps under the profiler,
    then steps with the spans timed until ``seconds`` have passed. -> the
    samples and steps of the timed part and the trace's summary."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    t_start = time.perf_counter()
    spans.mode = "profile"
    if folds:
        folds.on = True
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            for _ in range(cell.traffic["trace_steps"]):
                with record_function("bench.step"):
                    driver.step()
    if folds:
        folds.on = False
    spans.mode = "time"
    summary = devtrace.summarize(devtrace.events_of(prof))
    del prof
    samples, steps, _ = _loop(driver, seconds, t_start, mesh=mesh)
    spans.mode = None
    return samples, steps, summary
