"""Register caps for the gated fold kernels K2 and K3, timed on one GPU.

Builds ``csrc/dense.cu`` (K2) and ``csrc/dense_super.cu`` (K3) once for each
``-maxrregcount`` in ``--caps`` (0: no cap), all builds at once, and prints
what ptxas reports for each (registers, spills). Then, on the sorted primary
and first bounce batches of one pt_nee sample of chip_smoke.py's stream path
(colonnade subdiv 6, adaptive C = 1024, K2) and super path (colonnade
subdiv 5, C = 256, super_factor 8, K3) at 1024^2, it times every build by
CUDA events in turns (the caps in order, then in reverse) and prints each
build's mean ms. Every build must return the kernel's own result, bit for
bit.

Run on a CUDA machine from the repo root:
    python3 tools/tune_gated_fold.py [--caps 0,64,72,80,96] [--reps 3]
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import cudapathtracer_tpu_torch as cpt  # noqa: E402
from cudapathtracer_tpu_torch.models import procedural  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels import dense as k2  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels import dense_super as k3  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels.dense_resident import (  # noqa: E402
    launch_fold, load_fold_kernel)
from cudapathtracer_tpu_torch.ops.rng import prng_key  # noqa: E402
from cudapathtracer_tpu_torch.render import renderer  # noqa: E402
from cudapathtracer_tpu_torch.utils.build import BUILD_LOG  # noqa: E402

PATHS = (
    # label, subdiv, RenderConfig knobs, kernel module, symbol, ints
    ("stream", 6, {}, k2, "dense_stream_launch", 5),
    ("super", 5, dict(cluster_size=256, two_level_cull="super",
                      super_factor=8, super_list=255), k3,
     "dense_super_launch", 6),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--caps", default="0,64,72,80,96")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_gated_fold: no CUDA device", file=sys.stderr)
        return 1
    caps = [int(c) for c in args.caps.split(",")]
    dev = torch.device("cuda:0")
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}")

    def build(job):
        label, mod, symbol, n_ints, cap = job
        stem = os.path.splitext(os.path.basename(mod.SOURCE))[0]
        name = f"lib{stem}_maxrreg{cap}.so"
        fn = load_fold_kernel(name, mod.SOURCE, symbol, n_ints,
                              flags=[f"-maxrregcount={cap}"] if cap else [])
        return (label, cap), (name, fn)

    jobs = [(label, mod, symbol, n_ints, cap)
            for label, _, _, mod, symbol, n_ints in PATHS for cap in caps]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(pool.map(build, jobs))
    for (label, cap), (name, _) in built.items():
        for line in BUILD_LOG.get(name, "").splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas[{label} cap={cap}]: {line.strip()}")

    base_key = prng_key(1234, dev)
    for label, subdiv, kw, mod, _, _ in PATHS:
        size = chip_smoke.HEADLINE_SIZE
        scene = procedural.to_scene(procedural.colonnade(subdiv=subdiv), dev)
        cfg = cpt.RenderConfig(width=size, height=size, spp=2,
                               integrator="pt_nee", samples_per_call=2,
                               reuse_primary_hit=True, **kw)
        bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size,
                                           cluster_size=cfg.cluster_size)
        prep = renderer.make_packet_prep(scene, bvh)
        cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                              focal_length=2.0, device=dev)
        P = renderer.resolve_tile_size(cfg, scene.num_tris)
        trace_fn = renderer.make_trace_fn(scene, cfg, bvh, prep=prep)
        batches = chip_smoke.record_batches(scene, trace_fn, cam, cfg,
                                            base_key)
        F = cfg.super_factor if label == "super" else None
        pack = prep.resident_pack
        extra = (F, pack[0].shape[0] - 1) if F else (pack[0].shape[0] - 1,)
        for bname, batch in batches.items():
            sl = chip_smoke.sorted_shortlists(batch, prep.pdata, P, cfg,
                                              super_factor=F)
            fargs = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
            want = (mod.dense_intersect_super(*fargs, F) if F
                    else mod.dense_intersect(*fargs))

            def run(cap):
                fn = built[(label, cap)][1]
                return launch_fold(lambda: fn, label, *fargs, extra=extra)

            for cap in caps:
                got = run(cap)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{label} cap={cap} differs")
            ms = {cap: [] for cap in caps}
            for cap in caps + caps[::-1]:
                ms[cap].append(chip_smoke.cuda_ms(lambda: run(cap),
                                                  args.reps))
            print(f"{label}/{bname}: P={P} C={pack[0].shape[2]} "
                  + " ".join(f"cap{cap}_ms={sum(v) / len(v):.4f} "
                             f"({v[0]:.4f}, {v[1]:.4f})"
                             for cap, v in ms.items()))
        del scene, bvh, prep, trace_fn, batches
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
