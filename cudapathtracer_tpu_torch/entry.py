"""The port's graft entry points: one card's forward step and a dry run of
the distributed train step over n ranks.

Counterpart of the repository's ``__graft_entry__.py``, with its names,
scenes, shapes and keys:

* ``entry(device)`` -> ``(fn, example_args)``: the progressive pt_nee
  sample pass at 128^2 over ``cornell_with_sphere_mesh(subdiv=2)`` (356
  triangles). On a card the packet engine folds with K1
  (``csrc/dense_resident.cu``, the resident route of ``ops/packets.route``);
  on the CPU with K1's plain version.
* ``dryrun_multichip(n, device, backend)``: the sharded forward render and
  the FULL distributed train step (the sharded differentiable render with
  both boundary terms at 32 samples each, the all-reduce of the loss and
  the gradients, the replicated SGD update) on 16^2 over n ranks, one
  process each (``parallel/launch.py:start_ranks``). NCCL takes one rank
  per card; gloo runs the ranks on the CPU, or shares one card between
  them when the device names it (``cuda:0``). Nothing switches backend or
  device on its own: asking for more NCCL ranks than cards raises.

Run the dry run as ``python -m cudapathtracer_tpu_torch.entry [n]
[--device cpu]``.

The imports are absolute: each rank loads this file by its path.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from cudapathtracer_tpu_torch import (RenderConfig, init_accum, make_camera,
                                      render_batch)
from cudapathtracer_tpu_torch.models import procedural
from cudapathtracer_tpu_torch.ops.kernels import kernel_counts
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.render.renderer import build_bvh_for_scene
from cudapathtracer_tpu_torch.utils.build import BUILD_DIR

# the forward step's configuration (``__graft_entry__.py:28-29``)
ENTRY_CFG = RenderConfig(width=128, height=128, spp=1, integrator="pt_nee",
                         samples_per_call=1)
# the dry run's (:76-77): 16^2 pixels split over any n up to 256 ranks
DRYRUN_CFG = RenderConfig(width=16, height=16, spp=1, integrator="pt_nee",
                          samples_per_call=1)
DRYRUN_EDGE_SAMPLES = 32
DRYRUN_LEARNING_RATE = 1e-4
DRYRUN_TIMEOUT_S = 600


def entry(device="cuda"):
    """-> (fn, example_args): the forward render step on one device,
    ``fn(scene, bvh, cam, base_key, state)`` rendering one sample into
    ``state``."""
    dev = torch.device(device)
    cfg = ENTRY_CFG
    scene = procedural.to_scene(procedural.cornell_with_sphere_mesh(subdiv=2),
                                dev)
    bvh = build_bvh_for_scene(scene, cfg.leaf_size)
    cam = make_camera(width=cfg.width, height=cfg.height, device=dev)
    state = init_accum(cfg, device=dev)
    base_key = prng_key(1234, dev)

    def fn(scene, bvh, cam, base_key, state):
        return render_batch(scene, bvh, cam, cfg, base_key, state,
                            num_samples=1)

    return fn, (scene, bvh, cam, base_key, state)


def dryrun_rank(mesh, out_dir):
    """One rank of the dry run (run by ``start_ranks``): (1) its range of
    the sharded 1-spp render, gathered; (2) one train step toward a key-7
    target. -> the loss, the sample count, whether the image is finite, and
    the rank's kernel counts."""
    from cudapathtracer_tpu_torch.diff import render_grad as rg
    from cudapathtracer_tpu_torch.parallel.mesh import (gather_pixels,
                                                        tile_range)
    from cudapathtracer_tpu_torch.parallel.shard import (make_train_step,
                                                         render_sharded)

    dev = mesh.device
    cfg = DRYRUN_CFG
    scene = procedural.to_scene(procedural.cornell_box(), dev)
    bvh = build_bvh_for_scene(scene, cfg.leaf_size)
    cam = make_camera(width=cfg.width, height=cfg.height, device=dev)
    key = prng_key(0, dev)

    start, stop = tile_range(cfg.num_pixels, mesh)
    state = render_sharded(scene, bvh, cam, cfg, key,
                           init_accum(cfg, device=dev,
                                      num_pixels=stop - start), 1, mesh)
    img = gather_pixels(mesh, state.img)
    finite = all(bool(torch.isfinite(c).all()) for c in img)

    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, cfg, prng_key(7, dev), 1,
                                      bvh=bvh)
    step = make_train_step(scene, cam, cfg, mesh, spp=1, bvh=bvh,
                           learning_rate=DRYRUN_LEARNING_RATE,
                           edge_samples=DRYRUN_EDGE_SAMPLES,
                           shadow_edge_samples=DRYRUN_EDGE_SAMPLES)
    loss, _, _ = step(rg.targets_of(scene), None, target, key)
    return dict(loss=np.asarray(float(loss), np.float64),
                n=np.asarray(state.n), finite=np.asarray(finite),
                **{k: np.asarray(v) for k, v in kernel_counts().items()})


def dryrun_ranks(n_devices: int, device="cuda", backend=None):
    """Run ``dryrun_rank`` on ``n_devices`` ranks and return each rank's
    results in rank order. ``device``: the ranks' device ("cuda": rank r on
    card r; "cuda:0": every rank on that card; "cpu"). ``backend``: None
    for NCCL on a card and gloo on the CPU, or the one named."""
    from cudapathtracer_tpu_torch.parallel.launch import start_ranks

    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as out_dir:
        wait = start_ranks(os.path.abspath(__file__), "dryrun_rank",
                           n_devices, out_dir, device=device, backend=backend,
                           timeout=DRYRUN_TIMEOUT_S)
        return wait()


def dryrun_loss(n_devices: int, ranks) -> float:
    """The dry run's loss from ``dryrun_ranks``'s results; raises unless
    every rank's render holds one sample of finite pixels and the ranks
    agree on a finite loss. Prints the JAX package's line."""
    losses = [float(r["loss"]) for r in ranks]
    for r, res in enumerate(ranks):
        if int(res["n"]) != 1 or not bool(res["finite"]):
            raise AssertionError(f"dryrun_multichip({n_devices}): rank {r} "
                                 f"rendered n={int(res['n'])}, finite="
                                 f"{bool(res['finite'])}")
    loss = losses[0]
    if not np.isfinite(loss) or any(x != loss for x in losses):
        raise AssertionError(f"dryrun_multichip({n_devices}): the ranks' "
                             f"losses {losses}")
    print(f"dryrun_multichip({n_devices}): forward + train step "
          f"(incl. boundary-term grads) OK, loss={loss:.6f}")
    return loss


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> float:
    """One full distributed train step on ``n_devices`` ranks, tiny shapes:
    ``dryrun_ranks``, then ``dryrun_loss``. -> the loss."""
    return dryrun_loss(n_devices, dryrun_ranks(n_devices, device=device,
                                               backend=backend))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudapathtracer_tpu_torch.entry",
        description="one distributed train step over n ranks (the dry run)")
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="ranks (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, a card per rank) or cpu (gloo)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)


if __name__ == "__main__":
    main()
