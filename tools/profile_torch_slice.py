"""Where the time of the PyTorch port's headline render goes, on one GPU.

The headline is chip_smoke.py's: colonnade subdiv 3 (20,884 triangles),
1024x1024, pt_nee, 3 bounces, pinhole camera at (0, 2, 3.4), focal length 2,
primary hit reused. Phases, each printing lines that start with its name:

1. render_batch: wall seconds at 1, 4 and 8 spp after one warm-up,
   ``--repeats`` times each, each ended by torch.cuda.synchronize();
2. trace: one sample with every trace call (sort, cull, topk, K1, _finish)
   timed between synchronizes, against that sample's wall time;
3. rng: CUDA-event ms of one sample's random numbers over all pixels (the
   pixel keys, then a 6-value uniform_sites draw per bounce);
4. profile: torch.profiler over one 1-spp render_batch: the device time of
   all kernels, copies and sets and their count, the profiled wall, K1's
   device time, and the host ops whose kernels took the most device time
   (the whole table goes to ``--out`` when given).

Run on a CUDA machine from the repo root:
    python3 tools/profile_torch_slice.py [--size 1024] [--repeats 3]
                                         [--out table.txt]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cudapathtracer_tpu_torch as cpt  # noqa: E402
from cudapathtracer_tpu_torch.integrators.pt_nee import radiance_pt_nee  # noqa: E402
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
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--subdiv", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="file for the whole profiler table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}")

    n = args.size
    scene = procedural.to_scene(procedural.colonnade(subdiv=args.subdiv), dev)
    cfg = cpt.RenderConfig(width=n, height=n, integrator="pt_nee",
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

    def timed(o, d, mask):
        h, s = sync_s(lambda: trace_fn(o, d, mask))
        trace_s.append(s)
        return h

    def one_sample():
        keys = pixel_keys(sample_key(key, 0), idx)
        o0, d0 = camera_rays(cam, idx, keys, lens=False)
        primary = timed(o0, d0, torch.ones(idx.shape, dtype=torch.bool,
                                           device=dev))
        return radiance_pt_nee(o0, d0, scene, timed, keys,
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
        for b in range(cfg.num_bounces):
            uniform_sites(keys, SiteGroups.PT_BOUNCE, 6, bounce=b)

    rng()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        rng()
    stop.record()
    torch.cuda.synchronize()
    print(f"rng: ms_per_sample={start.elapsed_time(stop) / 5:.3f} "
          f"(pixel keys + {cfg.num_bounces} uniform_sites draws of 6)")

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


if __name__ == "__main__":
    sys.exit(main())
