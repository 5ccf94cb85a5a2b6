"""Where the time of the PyTorch port's headline render goes, on one GPU.

The headline is chip_smoke.py's: colonnade subdiv 3 (20,884 triangles),
1024x1024, pt_nee, 3 bounces, pinhole camera at (0, 2, 3.4), focal length 2,
primary hit reused; ``--integrator bdpt --size 512`` profiles chip_smoke.py's
bdpt path instead. Phases, each printing lines that start with its name:

1. render_batch: wall seconds at 1, 4 and 8 spp after one warm-up,
   ``--repeats`` times each, each ended by torch.cuda.synchronize();
2. trace: one sample with every trace call (sort, cull, topk, K1, _finish)
   timed between synchronizes, against that sample's wall time;
3. rng: CUDA-event ms of one sample's random numbers over all pixels (the
   pixel keys, then a 6-value uniform_sites draw per bounce; BDPT: one
   7-value draw);
4. profile: torch.profiler over one 1-spp render_batch: the device time of
   all kernels, copies and sets and their count, the profiled wall, K1's
   device time, and the host ops whose kernels took the most device time
   (the whole table goes to ``--out`` when given).

``--train`` profiles the bench's train step instead (bench.py:189-225;
chip_smoke.py's phase 12): colonnade subdiv 3 at 256x256, pt_nee, 1 spp,
primary hit not reused, one SGD step of the L2 loss against a key-9 target
through ``render_grad.make_loss_fn``, with ``--edge-samples`` samples of
each boundary term (default 0). It prints the step's wall (median of 3),
then ``torch.profiler`` over the forward (the loss) and over the backward
(the per-sample recompute and the backward proper, and the update) apart:
device ms, device events, the idle share (1 - device ms / wall ms), K1's
device ms and launches, the ops that launched the most device time, and
the device ms inside the float64 FMA emulation (forward and backward) and
the threefry RNG (``record_function`` ranges set around them here).

Run on a CUDA machine from the repo root:
    python3 tools/profile_torch_slice.py [--size 1024] [--repeats 3]
        [--integrator pt_nee|bdpt] [--out table.txt]
    python3 tools/profile_torch_slice.py --train [--size 256]
        [--edge-samples 16384] [--out table.txt]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cudapathtracer_tpu_torch as cpt  # noqa: E402
from cudapathtracer_tpu_torch.models import procedural  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as k1  # noqa: E402
from cudapathtracer_tpu_torch.ops.rng import (  # noqa: E402
    SiteGroups, pixel_keys, prng_key, sample_key, uniform_sites)
from cudapathtracer_tpu_torch.render import renderer  # noqa: E402
from cudapathtracer_tpu_torch.render.camera import camera_rays  # noqa: E402


def sync_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_us(e):
    return e.self_device_time_total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=None,
                    help="image width and height (default 1024; --train "
                    "256)")
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--integrator", default="pt_nee",
                    choices=("pt_nee", "bdpt"))
    ap.add_argument("--out", default=None,
                    help="file for the whole profiler table")
    ap.add_argument("--train", action="store_true",
                    help="profile the bench's train step instead")
    ap.add_argument("--edge-samples", type=int, default=0,
                    help="--train: samples of each boundary term")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; {smi}")
    if args.train:
        return train(args, dev)
    args.size = args.size or 1024

    n = args.size
    scene = procedural.to_scene(procedural.colonnade(subdiv=args.subdiv), dev)
    cfg = cpt.RenderConfig(width=n, height=n, integrator=args.integrator,
                           reuse_primary_hit=True)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
    prep = renderer.make_packet_prep(scene, bvh)
    cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=n, height=n,
                          focal_length=2.0, device=dev)
    key = prng_key(1234, dev)
    P = renderer.resolve_tile_size(cfg, scene.num_tris)
    print(f"scene: tris={scene.num_tris} clusters={prep.pdata.num_clusters} "
          f"C={prep.pdata.cluster_size} P={P} pixels={cfg.num_pixels}")

    def batch(spp):
        return cpt.render_batch(scene, bvh, cam, cfg, key,
                                cpt.init_accum(cfg, device=dev), spp,
                                prep=prep)

    # ---- 1. render_batch walls ---------------------------------------------
    batch(1)
    for spp in (1, 4, 8):
        walls = [sync_s(lambda: batch(spp))[1] for _ in range(args.repeats)]
        rays = cfg.num_pixels * spp * (cfg.num_bounces + 1)
        print(f"render_batch: spp={spp} seconds={[round(w, 4) for w in walls]}"
              f" mrays_per_s={[round(rays / w / 1e6, 3) for w in walls]}")

    # ---- 2. trace calls of one sample --------------------------------------
    trace_fn = renderer.make_trace_fn(scene, cfg, bvh, prep=prep)
    idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    trace_s = []

    def timed(o, d, mask, **kw):
        h, s = sync_s(lambda: trace_fn(o, d, mask, **kw))
        trace_s.append(s)
        return h

    def one_sample():
        keys = pixel_keys(sample_key(key, 0), idx)
        o0, d0 = camera_rays(cam, idx, keys, lens=False)
        primary = timed(o0, d0, torch.ones(idx.shape, dtype=torch.bool,
                                           device=dev))
        return renderer._radiance(o0, d0, scene, timed, keys, cfg,
                                  primary_hit=primary)

    one_sample()
    trace_s.clear()
    _, wall = sync_s(one_sample)
    print(f"trace: calls={len(trace_s)} ms={[round(s * 1e3, 3) for s in trace_s]}"
          f" total_ms={sum(trace_s) * 1e3:.3f} sample_wall_ms={wall * 1e3:.3f}"
          " (primary trace included; synchronize after every call)")

    # ---- 3. RNG of one sample ----------------------------------------------
    def rng():
        keys = pixel_keys(sample_key(key, 0), idx)
        if cfg.integrator == "bdpt":
            uniform_sites(keys, SiteGroups.BDPT, 7)
            return
        for b in range(cfg.num_bounces):
            uniform_sites(keys, SiteGroups.PT_BOUNCE, 6, bounce=b)

    rng()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        rng()
    stop.record()
    torch.cuda.synchronize()
    draws = ("1 uniform_sites draw of 7" if cfg.integrator == "bdpt"
             else f"{cfg.num_bounces} uniform_sites draws of 6")
    print(f"rng: ms_per_sample={start.elapsed_time(stop) / 5:.3f} "
          f"(pixel keys + {draws})")

    # ---- 4. torch.profiler over one sample ---------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch(1)
    torch.cuda.synchronize()
    launches0 = k1.dense_intersect_resident.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pwall = sync_s(lambda: batch(1))
    ka = prof.key_averages()
    # device rows are the kernels, copies and sets themselves (the table's
    # own "Self CUDA time total"); host rows are the ops that launched them
    dev_rows = [e for e in ka if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation]
    total_us = sum(device_us(e) for e in dev_rows)
    k1_us = sum(device_us(e) for e in dev_rows if "dense_resident" in e.key)
    print(f"profile: wall_ms={pwall * 1e3:.3f} device_ms={total_us / 1e3:.3f}"
          f" device_events={sum(e.count for e in dev_rows)} "
          f"k1_device_ms={k1_us / 1e3:.3f} "
          f"k1_launches={k1.dense_intersect_resident.launches - launches0}")
    if total_us == 0:
        print("profile: the profiler recorded no device time")
    ops = sorted((e for e in ka if e.device_type == DeviceType.CPU),
                 key=device_us, reverse=True)
    for e in ops[:20]:
        print(f"profile_op: {e.key[:60]!r} calls={e.count} "
              f"self_device_ms={device_us(e) / 1e3:.3f}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(ka.table(sort_by="self_device_time_total", row_limit=-1))
    return 0


def annotate(module, name, label):
    """Run ``module.name`` inside ``record_function(label)`` from now on."""
    from torch.profiler import record_function

    fn = getattr(module, name)

    def wrapped(*a, **kw):
        with record_function(label):
            return fn(*a, **kw)

    setattr(module, name, wrapped)


def profile_window(label, fn, k1_before, out=None):
    """torch.profiler over ``fn()``: one line of totals, the top ops, and
    the device ms inside the annotated ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = sync_s(fn)
    ka = prof.key_averages()
    dev_rows = [e for e in ka if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation]
    total_us = sum(device_us(e) for e in dev_rows)
    k1_rows = [e for e in dev_rows if "dense_resident" in e.key]
    k1_us = sum(device_us(e) for e in k1_rows)
    wall_ms = wall * 1e3
    print(f"{label}: wall_ms={wall_ms:.3f} device_ms={total_us / 1e3:.3f} "
          f"device_events={sum(e.count for e in dev_rows)} idle_share="
          f"{1 - total_us / 1e3 / wall_ms:.4f} k1_device_ms={k1_us / 1e3:.3f}"
          f" k1_device_launches={sum(e.count for e in k1_rows)} "
          f"k1_wrapper_launches="
          f"{k1.dense_intersect_resident.launches - k1_before}")
    for e in ka:
        # the host-side range: its device time is that of the kernels
        # launched inside it (the device-side row spans idle gaps too)
        if (e.key in ("fma_emulation", "fma_backward", "threefry")
                and e.device_type == DeviceType.CPU):
            print(f"{label}_range: {e.key} calls={e.count} device_ms="
                  f"{e.device_time_total / 1e3:.3f} share_of_device="
                  f"{e.device_time_total / max(total_us, 1):.4f}")
    ops = sorted((e for e in ka if e.device_type == DeviceType.CPU
                  and not e.is_user_annotation), key=device_us,
                 reverse=True)
    for e in ops[:15]:
        print(f"{label}_op: {e.key[:60]!r} calls={e.count} "
              f"self_device_ms={device_us(e) / 1e3:.3f}")
    if out:
        with open(out, "a") as f:
            f.write(f"==== {label}\n")
            f.write(ka.table(sort_by="self_device_time_total",
                             row_limit=-1))


def train(args, dev):
    """--train: the bench's train step, timed and profiled."""
    from cudapathtracer_tpu_torch.diff import render_grad as rg
    from cudapathtracer_tpu_torch.ops import rng, vecmath

    n = args.size or 256
    scene = procedural.to_scene(procedural.colonnade(subdiv=args.subdiv), dev)
    cfg = cpt.RenderConfig(width=n, height=n, spp=1, samples_per_call=1,
                           integrator="pt_nee", reuse_primary_hit=False)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
    cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=n, height=n,
                          focal_length=2.0, device=dev)
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, cfg, prng_key(9, dev), 1,
                                      bvh=bvh)
    es = args.edge_samples
    loss_fn = rg.make_loss_fn(scene, cam, cfg, prng_key(1234, dev), 1,
                              bvh=bvh, edge_samples=es,
                              shadow_edge_samples=es)
    print(f"train: tris={scene.num_tris} {n}x{n} spp=1 pt_nee "
          f"edge_samples={es} shadow_edge_samples={es}")

    def params():
        p = rg.targets_of(scene)
        return p, torch.optim.SGD(rg.target_leaves(p), lr=1e-4)

    def step():
        p, opt = params()
        loss_fn(p, target).backward()
        opt.step()

    step()
    walls = [sync_s(step)[1] * 1e3 for _ in range(3)]
    rays = cfg.num_pixels * (cfg.num_bounces + 1)
    med = sorted(walls)[1]
    print(f"train: step_ms={[round(w, 3) for w in walls]} median_ms="
          f"{med:.3f} grad_mrays_per_s={rays / med / 1e3:.3f}")

    annotate(vecmath, "_fma_rounded", "fma_emulation")
    annotate(vecmath, "_cotangent", "fma_backward")
    annotate(rng, "threefry2x32", "threefry")
    step()
    p, opt = params()
    holder = {}
    before = k1.dense_intersect_resident.launches
    profile_window("train_forward",
                   lambda: holder.setdefault("loss", loss_fn(p, target)),
                   before, args.out)
    before = k1.dense_intersect_resident.launches

    def backward():
        holder["loss"].backward()
        opt.step()

    profile_window("train_backward", backward, before, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
