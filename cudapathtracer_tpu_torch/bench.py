"""The headline benchmark on the card: Mrays/s of the colonnade scenes.

Counterpart of the repository's ``bench.py`` (the JAX package's), with its
JSON, its ray accounting and its environment knobs. Run as

    python -m cudapathtracer_tpu_torch.bench [--device cuda|cpu]

It prints ONE JSON line on stdout, with ``bench.py``'s keys and strings:
``metric``, ``value`` (Mrays/s), ``unit``, ``vs_baseline``; with the sweep
``mrays_82k``, ``mrays_328k``, ``mrays_1310k`` and
``mrays_328k_vs_baseline``; with BDPT ``bdpt_mrays`` and
``bdpt_vs_baseline``; with the train step ``train_step_ms`` and
``grad_mrays``. A line of context goes to stderr: the scene, the BVH build,
each timed window's seconds and the device (on a card, its name and power
limit as ``nvidia-smi`` reads them).

Accounting (the reference's, kernel.cu:757): rays = pixels x spp x
(bounces + 1) over the best of ``REPEATS`` timed windows, each after one
untimed warm-up window (which also builds the kernels into ``build/``) and
each ending in a ``torch.cuda.synchronize``. Baseline: the reference's best
recorded sponza run, 1170 ms for 512^2 x 100 x 4 rays, 89.62 Mrays/s on its
contemporary GPU; ``vs_baseline`` = ours / that.

Knobs (``bench.py``'s, with its defaults): BENCH_SPP (16), BENCH_SIZE
(1024), BENCH_SUBDIV (3: colonnade, 20,884 triangles), BENCH_SBATCH (1),
BENCH_ROUNDS (1), BENCH_FIRST (2), BENCH_SORTWIN (0), BENCH_C, BENCH_TILE,
BENCH_TWO_LEVEL (auto, 0, 1 or super; any other value raises KeyError),
BENCH_SUPERF (8), BENCH_SUPERLIST (255), BENCH_WARM and BENCH_RAYGROUPS
(the TPU schedule knobs: any value raises NotImplementedError, as
``utils/config.check_supported`` does); BENCH_SWEEP=0 skips the sweep
(colonnade subdiv 4, 5 and 6 at max(4, spp // 2) spp), BENCH_BIG=0 its
subdiv-6 point; BENCH_BDPT=0 skips BDPT (512^2, BENCH_BDPT_SPP default
max(8, spp // 4), BENCH_BDPT_SBATCH 2, BENCH_BDPT_TILE 256,
BENCH_BDPT_TILE_VIS); BENCH_TRAIN=0 skips the train step (BENCH_TRAIN_SIZE
256, BENCH_TRAIN_SPP 1).

``parts(device, env)`` runs the parts one at a time as its caller iterates,
so a caller can read the kernels' launch counts part by part; ``main``
joins their keys into the line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from .cli import require_device
from .diff import render_grad as rg
from .models import procedural
from .ops.rng import prng_key
from .render.camera import make_camera
from .render.renderer import (build_bvh_for_scene, init_accum,
                              make_packet_prep, render_batch)
from .utils.config import RenderConfig, check_supported

BASELINE_MRAYS = 512 * 512 * 100 * 4 / (1170.0 * 1000.0)  # 89.62
REPEATS = 3
BDPT_SIZE = 512
# the sweep: colonnade subdiv and its key; the last is BENCH_BIG's
SWEEP = ((4, "mrays_82k"), (5, "mrays_328k"), (6, "mrays_1310k"))


class Measurement(NamedTuple):
    """One timed part: ``mrays`` over the best window (the reference's
    accounting), every timed window's ``seconds``, its config, the last
    window's ``result`` (an AccumState; the train step's (loss,
    GradTargets of gradients)), and the scene, BVH and camera it ran on
    with the BVH's build seconds."""

    mrays: float
    seconds: list
    cfg: RenderConfig
    result: object
    scene: object
    bvh: object
    cam: object
    build_s: float = 0.0


def _int(env, name, default):
    return int(env.get(name, str(default)))


def _opt_int(env, name):
    return int(env[name]) if name in env else None


def bench_config(size: int, spp: int, env=os.environ) -> RenderConfig:
    """The headline's pt_nee config (``bench.py:67-86``) from the knobs in
    ``env``; the primary hit is reused (pinhole camera, no jitter)."""
    return RenderConfig(
        width=size, height=size, spp=spp, integrator="pt_nee",
        samples_per_call=spp, sample_batch=_int(env, "BENCH_SBATCH", 1),
        packet_rounds=_int(env, "BENCH_ROUNDS", 1),
        packet_first_round=_int(env, "BENCH_FIRST", 2),
        sort_window=_int(env, "BENCH_SORTWIN", 0),
        cluster_size=_opt_int(env, "BENCH_C"),
        tile_size=_opt_int(env, "BENCH_TILE"),
        two_level_cull={"auto": None, "0": False, "1": True,
                        "super": "super"}[env.get("BENCH_TWO_LEVEL", "auto")],
        super_factor=_int(env, "BENCH_SUPERF", 8),
        super_list=_int(env, "BENCH_SUPERLIST", 255),
        warm_start=_opt_int(env, "BENCH_WARM"),
        ray_groups=_opt_int(env, "BENCH_RAYGROUPS"),
        reuse_primary_hit=True)


def bench_camera(size: int, device):
    return make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                       focal_length=2.0, device=device)


def best_of(fn, device):
    """One untimed warm-up call of ``fn``, then ``REPEATS`` timed calls,
    each to a synchronize of ``device``. -> (the last call's result, each
    timed call's seconds)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    seconds = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        out = fn()
        sync()
        seconds.append(time.perf_counter() - t0)
    return out, seconds


def _mrays(cfg: RenderConfig, spp: int, seconds) -> float:
    return cfg.num_pixels * spp * (cfg.num_bounces + 1) / min(seconds) / 1e6


def measure(subdiv: int, spp: int, size: int, device,
            env=os.environ) -> Measurement:
    """pt_nee on colonnade ``subdiv`` at ``size``^2, windows of ``spp``
    samples from a fresh state, key 1234 (``bench.py:67-119``)."""
    dev = torch.device(device)
    cfg = bench_config(size, spp, env)
    check_supported(cfg)
    scene = procedural.to_scene(procedural.colonnade(subdiv=subdiv), dev)
    t0 = time.perf_counter()
    bvh = build_bvh_for_scene(scene, cfg.leaf_size,
                              cluster_size=cfg.cluster_size)
    build_s = time.perf_counter() - t0
    cam = bench_camera(size, dev)
    key = prng_key(1234, dev)
    prep = make_packet_prep(scene, bvh)
    state, seconds = best_of(
        lambda: render_batch(scene, bvh, cam, cfg, key,
                             init_accum(cfg, device=dev), spp, prep=prep),
        dev)
    return Measurement(_mrays(cfg, spp, seconds), seconds, cfg, state,
                       scene, bvh, cam, build_s)


def measure_bdpt(scene, bvh, cfg: RenderConfig, device, size=BDPT_SIZE,
                 spp=8, env=os.environ) -> Measurement:
    """BDPT, the reference's live integrator, on the headline's scene at
    ``size``^2 (``bench.py:150-187``): ``cfg`` with ``sample_batch``
    BENCH_BDPT_SBATCH, tile BENCH_BDPT_TILE and BENCH_BDPT_TILE_VIS."""
    dev = torch.device(device)
    tile_vis = env.get("BENCH_BDPT_TILE_VIS")
    bcfg = dataclasses.replace(
        cfg, width=size, height=size, integrator="bdpt", spp=spp,
        samples_per_call=spp, sample_batch=_int(env, "BENCH_BDPT_SBATCH", 2),
        tile_size=_int(env, "BENCH_BDPT_TILE", 256),
        tile_size_vis=int(tile_vis) if tile_vis else None)
    cam = bench_camera(size, dev)
    key = prng_key(1234, dev)
    prep = make_packet_prep(scene, bvh)
    state, seconds = best_of(
        lambda: render_batch(scene, bvh, cam, bcfg, key,
                             init_accum(bcfg, device=dev), spp, prep=prep),
        dev)
    return Measurement(_mrays(bcfg, spp, seconds), seconds, bcfg, state,
                       scene, bvh, cam)


def measure_train(scene, bvh, cfg: RenderConfig, device, size=256,
                  spp=1) -> Measurement:
    """One step of the inverse-rendering L2 loss and its gradients in every
    scene parameter (``bench.py:189-225``): ``cfg`` at ``size``^2, one
    sample a batch, the primary hit traced each sample, the target rendered
    at key 9 and the loss at key 1234. A timed step runs the forward and
    the backward to a synchronize; ``mrays`` counts the forward's rays
    (grad_mrays)."""
    dev = torch.device(device)
    tcfg = dataclasses.replace(cfg, width=size, height=size, spp=spp,
                               samples_per_call=spp, sample_batch=1,
                               reuse_primary_hit=False)
    cam = bench_camera(size, dev)
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, tcfg, prng_key(9, dev), spp,
                                      bvh=bvh)
    loss_fn = rg.make_loss_fn(scene, cam, tcfg, prng_key(1234, dev), spp,
                              bvh=bvh)
    params = rg.targets_of(scene)
    leaves = rg.target_leaves(params)

    def step():
        loss = loss_fn(params, target)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), rg.from_leaves(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)])

    out, seconds = best_of(step, dev)
    return Measurement(_mrays(tcfg, spp, seconds), seconds, tcfg, out,
                       scene, bvh, cam)


def parts(device, env=os.environ):
    """The bench's parts in ``bench.py``'s order, each run when the caller
    asks for the next: yields (part name, its keys of the JSON line, its
    Measurement). A scale of the sweep is released before the next one
    runs: drop the Measurement before asking for the next part."""
    spp = _int(env, "BENCH_SPP", 16)
    size = _int(env, "BENCH_SIZE", 1024)
    subdiv = _int(env, "BENCH_SUBDIV", 3)
    head = measure(subdiv, spp, size, device, env)
    yield "headline", {
        "metric": "Mrays/s (colonnade %dk tris, %d^2, pt_nee, %d bounces)" % (
            head.scene.num_tris // 1000, size, head.cfg.num_bounces),
        "value": round(head.mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(head.mrays / BASELINE_MRAYS, 3),
    }, head

    if env.get("BENCH_SWEEP", "1") != "0":
        sweep = SWEEP if env.get("BENCH_BIG", "1") != "0" else SWEEP[:-1]
        for sub, name in sweep:
            m = head if sub == subdiv else measure(sub, max(4, spp // 2),
                                                   size, device, env)
            keys = {name: round(m.mrays, 2)}
            if name == "mrays_328k":
                keys["mrays_328k_vs_baseline"] = round(
                    keys[name] / BASELINE_MRAYS, 3)
            yield name, keys, m
            del m
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()

    if env.get("BENCH_BDPT", "1") != "0":
        bspp = _int(env, "BENCH_BDPT_SPP", max(8, spp // 4))
        m = measure_bdpt(head.scene, head.bvh, head.cfg, device, BDPT_SIZE,
                         bspp, env)
        yield "bdpt", {"bdpt_mrays": round(m.mrays, 2),
                       "bdpt_vs_baseline": round(m.mrays / BASELINE_MRAYS,
                                                 3)}, m
        del m

    if env.get("BENCH_TRAIN", "1") != "0":
        m = measure_train(head.scene, head.bvh, head.cfg, device,
                          _int(env, "BENCH_TRAIN_SIZE", 256),
                          _int(env, "BENCH_TRAIN_SPP", 1))
        yield "train", {"train_step_ms": round(min(m.seconds) * 1000.0, 1),
                        "grad_mrays": round(m.mrays, 2)}, m


def device_line(device) -> str:
    """The device as the context line names it: on a card its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit`` reads them
    (a failure of ``nvidia-smi`` raises)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return f"{dev} ({smi[index]})"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m cudapathtracer_tpu_torch.bench",
        description="Mrays/s of the colonnade scenes (one JSON line)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    device = device_line(dev)
    result, windows, head = {}, [], None
    for name, keys, m in parts(dev):
        result.update(keys)
        windows.append(f"{name}={[round(s, 4) for s in m.seconds]}")
        if name == "headline":
            head = m
        del m
    print(json.dumps(result))
    print(f"# tris={head.scene.num_tris} bvh_build={head.build_s:.2f}s "
          f"window={min(head.seconds):.2f}s spp={head.cfg.spp} "
          f"device={device}", file=sys.stderr)
    print("# window seconds: " + " ".join(windows), file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
