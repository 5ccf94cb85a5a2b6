"""Render windows of one path from several checkouts of the port on one GPU,
in turns, and print each checkout's Mrays/s.

Each ``--tree NAME=DIR`` names a checkout: this repository (``.``) or
another commit unpacked with ``git archive`` into the ignored ``build/``.
Every round starts one process per checkout, in order and then in reverse
order on alternate rounds (a, b, b, a, ...); the process imports the
package from its checkout (which builds its kernels into that checkout's
``build/``), renders one warm-up window and ``--windows`` timed ones, and
prints its window seconds as JSON. The tool prints each checkout's
Mrays/s (pixels x spp x (bounces + 1) over the summed window seconds) per
round and over all rounds, the card's name and power limit beside them.

Paths (the bench camera (0, 2, 3.4), focal length 2, seed 1234):
* headline: colonnade subdiv 3, pt_nee 1024^2, 4-spp windows;
* bdpt: colonnade subdiv 3, BDPT 512^2, 8-spp windows.

Run on a CUDA machine from the repo root:
    python3 tools/compare_trees.py --tree parent=build/parent --tree change=.
        [--path headline] [--rounds 2] [--windows 3]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# path -> (subdiv, size, integrator, spp)
PATHS = {"headline": (3, 1024, "pt_nee", 4), "bdpt": (3, 512, "bdpt", 8)}


def child(root, path, windows):
    """One checkout's windows: -> its window seconds, printed as JSON."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch.models import procedural
    from cudapathtracer_tpu_torch.ops.rng import prng_key
    from cudapathtracer_tpu_torch.render import renderer

    if not cpt.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {cpt.__file__}, not from {root}")
    subdiv, size, integrator, spp = PATHS[path]
    dev = torch.device("cuda:0")
    scene = procedural.to_scene(procedural.colonnade(subdiv=subdiv), dev)
    cfg = cpt.RenderConfig(width=size, height=size, spp=spp,
                           integrator=integrator, samples_per_call=spp,
                           reuse_primary_hit=True)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
    prep = renderer.make_packet_prep(scene, bvh)
    cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                          focal_length=2.0, device=dev)
    key = prng_key(1234, dev)

    def window():
        return cpt.render_batch(scene, bvh, cam, cfg, key,
                                cpt.init_accum(cfg, device=dev), spp,
                                prep=prep)

    window()
    torch.cuda.synchronize()
    walls = []
    for _ in range(windows):
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"walls": walls}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout of the repository")
    ap.add_argument("--path", choices=sorted(PATHS), default="headline")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.path, args.windows)
        return 0
    trees = [t.split("=", 1) for t in args.tree]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    subdiv, size, integrator, spp = PATHS[args.path]
    rays = size * size * spp * 4 * args.windows      # 3 bounces + 1
    walls = {name: [] for name, _ in trees}
    for r in range(args.rounds):
        for name, root in (trees if r % 2 == 0 else trees[::-1]):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--tree", "x=.",
                 "--child", root, "--path", args.path, "--windows",
                 str(args.windows)], capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"{name} ({root}) failed:\n{out.stderr}")
            w = json.loads(out.stdout.strip().splitlines()[-1])["walls"]
            walls[name].append(w)
            print(f"{args.path}: round={r} tree={name} window_seconds="
                  f"{[round(x, 4) for x in w]} mrays_per_s="
                  f"{rays / sum(w) / 1e6:.3f}", flush=True)
    for name, ws in walls.items():
        per = [rays / sum(w) / 1e6 for w in ws]
        print(f"{args.path}: tree={name} mrays_per_s_by_round="
              f"{[round(p, 3) for p in per]} overall="
              f"{rays * len(ws) / sum(map(sum, ws)) / 1e6:.3f} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
