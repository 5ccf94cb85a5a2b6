"""Scaling efficiency of the tile-sharded render, 1 rank -> N ranks.

Counterpart of the repository's ``bench_scaling.py`` (the JAX package's):
the same workload rendered by one rank and by N, and the parallel
efficiency rn / (r1 N) of their Mrays/s. Run as

    python -m cudapathtracer_tpu_torch.bench_scaling [--device cuda|cpu]
        [--world N] [--backend nccl|gloo]

It prints one JSON line on stdout, ``bench_scaling.py``'s:
``{"metric": "scaling efficiency 1->N (gpu|cpu)", "value": eff, "unit":
"ratio", "vs_baseline": eff / 0.85, "profile_artifact": dir or null}``
(BASELINE.md's target: at least 85% from 1 card to N), and on stderr each
world's Mrays/s, windows and kernel launches, and the largest |delta|
between the N-rank and the 1-rank image (the sharded render is bit for bit
the unsharded one, so it reads 0).

Every rank is a process of its own (``parallel/launch.py:start_ranks``),
which loads this file by its path, so the imports are absolute. N defaults
to the cards present (one rank a card over NCCL); on a one-card machine the
efficiency is 1.0 by definition and nothing runs twice. On the CPU ``--world
N`` runs N gloo ranks, and ``--backend gloo --device cuda:0 --world 2`` two
ranks sharing one card (NCCL refuses that): a check of the sharded path, not
a scaling number. Each rank warms up (its first collective included), then
times ``REPEATS`` windows of ``render_sharded`` over its Morton range, each
window between two barriers, so that it spans the whole world's render;
Mrays/s counts the whole image's rays (kernel.cu:757) over the best window.

The world's ranks also write a ``torch.profiler`` trace of one sharded
render and one distributed train step (the gradient all-reduce), each
warmed up outside the capture, into SCALE_PROFILE_DIR, one file a rank.

Knobs (``bench_scaling.py``'s): SCALE_SIZE (512), SCALE_SPP (4),
SCALE_SUBDIV (2: colonnade), SCALE_PROFILE_DIR (default
``cpt_scaling_profile`` in the temporary directory; empty skips the trace).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from cudapathtracer_tpu_torch import RenderConfig, init_accum, make_camera
from cudapathtracer_tpu_torch.cli import require_device
from cudapathtracer_tpu_torch.ops.kernels import kernel_counts
from cudapathtracer_tpu_torch.utils.build import BUILD_DIR

REPEATS = 3
TARGET_EFFICIENCY = 0.85
RANK_TIMEOUT_S = 900


def scaling_rank(mesh, out_dir, size, spp, subdiv, profile_dir):
    """One rank (run by ``start_ranks``): the timed windows of its range,
    then, with ``profile_dir``, the profiler trace. -> every window's
    seconds, the kernels' counts over the windows and (rank 0) the
    gathered image (3, R) of the last window."""
    from cudapathtracer_tpu_torch.models import procedural
    from cudapathtracer_tpu_torch.ops.rng import prng_key
    from cudapathtracer_tpu_torch.parallel.mesh import (gather_pixels,
                                                        tile_range)
    from cudapathtracer_tpu_torch.parallel.shard import render_sharded
    from cudapathtracer_tpu_torch.render.renderer import (build_bvh_for_scene,
                                                          make_packet_prep)

    dev = mesh.device
    # bench_scaling.py:55-61's scene, BVH, camera, config and key
    scene = procedural.to_scene(procedural.colonnade(subdiv=subdiv), dev)
    bvh = build_bvh_for_scene(scene, 4)
    cam = make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                      focal_length=2.0, device=dev)
    cfg = RenderConfig(width=size, height=size, spp=spp, integrator="pt_nee",
                       samples_per_call=spp)
    key = prng_key(7, dev)
    prep = make_packet_prep(scene, bvh)
    start, stop = tile_range(cfg.num_pixels, mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def window():
        state = render_sharded(scene, bvh, cam, cfg, key,
                               init_accum(cfg, device=dev,
                                          num_pixels=stop - start),
                               spp, mesh, prep=prep)
        sync()
        return state

    def barrier():
        # NCCL's barrier runs on a card: name the rank's
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[dev.index])
        else:
            dist.barrier()

    window()
    barrier()  # the group's first collective: outside every window
    before = kernel_counts()
    seconds = []
    for _ in range(REPEATS):
        barrier()
        t0 = time.perf_counter()
        state = window()
        barrier()
        seconds.append(time.perf_counter() - t0)
    counts = {k: v - before[k] for k, v in kernel_counts().items()}
    img = gather_pixels(mesh, state.img)
    out = dict(seconds=np.asarray(seconds),
               **{k: np.asarray(v) for k, v in counts.items()})
    if mesh.rank == 0:
        out["img"] = np.stack([c.cpu().numpy() for c in img])
    if profile_dir:
        _profile(mesh, scene, bvh, cam, size, key, profile_dir)
    return out


def _profile(mesh, scene, bvh, cam, size, key, profile_dir):
    """``bench_scaling.py:79-107``: one sharded 1-spp render at min(size,
    256)^2 and one train step of the sharded L2 loss (its gradient
    all-reduce), each once outside the capture, then both inside it."""
    from cudapathtracer_tpu_torch.diff import render_grad as rg
    from cudapathtracer_tpu_torch.parallel.mesh import tile_range
    from cudapathtracer_tpu_torch.parallel.shard import (make_train_step,
                                                         render_sharded)
    from cudapathtracer_tpu_torch.utils.profiling import profile_trace

    dev = mesh.device
    small = RenderConfig(width=min(size, 256), height=min(size, 256), spp=1,
                         integrator="pt_nee", samples_per_call=1)
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, small, key, 1, bvh=bvh)
    step = make_train_step(scene, cam, small, mesh, spp=1, bvh=bvh,
                           learning_rate=1e-3)
    params = rg.targets_of(scene)
    start, stop = tile_range(small.num_pixels, mesh)

    def render_and_step():
        state = render_sharded(scene, bvh, cam, small, key,
                               init_accum(small, device=dev,
                                          num_pixels=stop - start), 1, mesh)
        float(state.img.x[0])
        loss, _, _ = step(params, None, target, key)
        float(loss)

    render_and_step()
    with profile_trace(profile_dir):
        render_and_step()


def run_world(world, device, backend, size, spp, subdiv, profile_dir=""):
    """``scaling_rank`` on ``world`` ranks. -> each rank's results."""
    from cudapathtracer_tpu_torch.parallel.launch import start_ranks

    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as out_dir:
        wait = start_ranks(os.path.abspath(__file__), "scaling_rank", world,
                           out_dir, device=device, backend=backend,
                           args=(size, spp, subdiv, profile_dir),
                           timeout=RANK_TIMEOUT_S)
        return wait()


def _mrays(ranks, size, spp):
    """The world's Mrays/s over its best window (every rank times the same
    span between barriers; rank 0's is taken)."""
    rays = size * size * spp * (RenderConfig().num_bounces + 1)
    return rays / float(ranks[0]["seconds"].min()) / 1e6


def _report(label, ranks, mrays):
    for r, res in enumerate(ranks):
        print(f"# {label} rank {r}: window_s="
              f"{[round(float(s), 4) for s in res['seconds']]} "
              + " ".join(f"{k}={int(res[k])}" for k in
                         ("k1_launches", "k2_launches", "k3_launches",
                          "plain_calls")), file=sys.stderr)
    print(f"# {label}: {mrays:.2f} Mrays/s", file=sys.stderr)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m cudapathtracer_tpu_torch.bench_scaling",
        description="scaling efficiency of the sharded render, 1 -> N ranks "
                    "(one JSON line)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (one card a rank; the default; fails without "
                         "a card), cuda:i (every rank on that card, gloo) or "
                         "cpu")
    ap.add_argument("--world", type=int, default=None,
                    help="N (default: the cards present; 1 on the CPU)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: NCCL on a card, gloo on the CPU")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    world = args.world
    if world is None:
        world = (torch.cuda.device_count()
                 if dev.type == "cuda" and dev.index is None else 1)
    size = int(os.environ.get("SCALE_SIZE", "512"))
    spp = int(os.environ.get("SCALE_SPP", "4"))
    subdiv = int(os.environ.get("SCALE_SUBDIV", "2"))
    profile_dir = os.environ.get("SCALE_PROFILE_DIR", os.path.join(
        tempfile.gettempdir(), "cpt_scaling_profile"))

    def run(n, prof):
        return run_world(n, args.device, args.backend, size, spp, subdiv,
                         prof)

    one = run(1, profile_dir if world == 1 else "")
    r1 = _mrays(one, size, spp)
    _report("1 rank", one, r1)
    if world == 1:
        eff, rn = 1.0, r1
    else:
        ranks = run(world, profile_dir)
        rn = _mrays(ranks, size, spp)
        _report(f"{world} ranks", ranks, rn)
        eff = rn / (r1 * world)
        delta = float(np.abs(ranks[0]["img"] - one[0]["img"]).max())
        print(f"# sharded vs 1-rank image max |delta| = {delta!r} (bit for "
              "bit expected)", file=sys.stderr)
        if dev.type == "cuda" and dev.index is not None:
            print(f"# the {world} ranks share {args.device}: two ranks "
                  "sharing one card, not a scaling number", file=sys.stderr)
    if profile_dir:
        print(f"# profiler trace written to {profile_dir}", file=sys.stderr)
    result = {
        "metric": f"scaling efficiency 1->{world} "
                  f"({'gpu' if dev.type == 'cuda' else 'cpu'})",
        "value": round(eff, 3),
        "unit": "ratio",
        "vs_baseline": round(eff / TARGET_EFFICIENCY, 3),
        "profile_artifact": profile_dir or None,
    }
    print(json.dumps(result))
    print(f"# 1-rank {r1:.2f} Mrays/s; {world}-rank {rn:.2f} Mrays/s",
          file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
