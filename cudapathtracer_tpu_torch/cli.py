"""Command-line interface: the reference's main() as a CLI, on PyTorch.

Counterpart of ``cudapathtracer_tpu/cli.py``, with its ``render`` and
``heatmap`` commands and their flags. It renders on the card
(``--device cuda``, the default) and fails when there is none; it renders on
the CPU only when asked (``--device cpu``). ``--packet-engine`` takes
``auto`` only. ``--sharded`` splits the image's Morton pixel range over
the ranks of a ``torch.distributed`` group (parallel/): one process per
card under ``torchrun``, else one rank. Examples:

    # the reference's live config (cornell + hero object, BDPT, 512^2)
    python -m cudapathtracer_tpu_torch.cli render --scene cornell-sphere \\
        --integrator bdpt --size 512 --spp 99 -o image.png

    # load OBJs like the reference's loadOBJ calls (repeatable; each takes
    # path[:ox,oy,oz[:scale[:flip]]])
    python -m cudapathtracer_tpu_torch.cli render \\
        --obj models/CornellBox.obj \\
        --obj "models/teapot.obj:0.35,0.6,0.3:0.75" -o out.ppm

    # resumable progressive render with checkpoints every 16 samples
    python -m cudapathtracer_tpu_torch.cli render --scene cornell --spp 256 \\
        --checkpoint ckpt.npz --checkpoint-every 16 -o out.ppm

    # multi-GPU: one rank per card, each rendering its range of pixels
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m cudapathtracer_tpu_torch.cli render --scene colonnade \\
        --sharded -o out.png

    # traversal heatmap (the reference's out.csv, kernel.cu:742-750)
    python -m cudapathtracer_tpu_torch.cli heatmap --scene cornell -o out.csv
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def _parse_obj_spec(spec: str):
    parts = spec.split(":")
    path = parts[0]
    origin = (0.0, 0.0, 0.0)
    scale = 1.0
    flip = False
    if len(parts) > 1 and parts[1]:
        origin = tuple(float(x) for x in parts[1].split(","))
    if len(parts) > 2 and parts[2]:
        scale = float(parts[2])
    if len(parts) > 3:
        flip = parts[3].lower() in ("1", "true", "flip")
    return path, origin, scale, flip


def build_scene(args, device):
    from .models import procedural
    from .models.loader import load_objs

    if args.obj:
        return load_objs([_parse_obj_spec(s) for s in args.obj],
                         device=device)
    name = args.scene
    if name == "cornell":
        return procedural.to_scene(procedural.cornell_box(), device)
    if name == "cornell-sphere":
        return procedural.to_scene(procedural.cornell_with_sphere_mesh(),
                                   device)
    if name == "cornell-empty":
        return procedural.to_scene(procedural.cornell_box(with_boxes=False),
                                   device)
    if name == "colonnade":
        return procedural.to_scene(
            procedural.colonnade(subdiv=args.scene_detail), device)
    raise SystemExit(f"unknown scene '{name}'")


def make_config(args):
    from .utils.config import RenderConfig

    return RenderConfig(
        width=args.size,
        height=args.size,
        spp=args.spp,
        num_bounces=args.bounces,
        integrator=args.integrator,
        traversal=args.traversal,
        leaf_size=args.leaf_size,
        samples_per_call=args.samples_per_call,
        orthonormal_frame=args.orthonormal_frame,
        light_normal_mode=args.light_normal_mode,
        branch_pdf_correction=args.branch_pdf_correction,
        jitter=args.jitter,
        compensated_accum=not args.no_compensated_accum,
        tile_size=args.tile_size,
        cluster_size=args.cluster_size,
        max_clusters=args.max_clusters,
        packet_sort=not args.no_packet_sort,
        packet_engine=args.packet_engine,
    )


def _device(args) -> torch.device:
    """The device the command runs on; a CUDA device without a card is an
    error, never a quiet fall back to the CPU."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    return dev


def cmd_render(args):
    dev = _device(args)
    if not args.sharded:
        _render(args, dev, None)
        return
    import torch.distributed as dist

    from .parallel.mesh import initialize_distributed

    mesh = initialize_distributed(device=dev)
    try:
        _render(args, mesh.device, mesh)
    finally:
        dist.destroy_process_group()


def _render(args, dev, mesh):
    """The render command on ``dev``; with a ``mesh`` (``--sharded``) this
    rank renders its Morton range, the state is gathered for each
    checkpoint and the image, and only rank 0 prints and writes."""
    from . import make_camera, write_render
    from .parallel.mesh import gather_pixels, shard_pixels, tile_range
    from .render.renderer import build_bvh_for_scene, render
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.profiling import RenderTimer

    lead = mesh is None or mesh.rank == 0

    def say(msg):
        if lead:
            print(msg, file=sys.stderr)

    # device banner (the reference's cudaGetDeviceProperties block,
    # kernel.cu:567-584)
    if dev.type == "cuda":
        say(f"devices: {torch.cuda.device_count()} x "
            f"{torch.cuda.get_device_name(dev)} (cuda)")
    else:
        say(f"devices: 1 x {dev.type} ({dev.type})")

    scene = build_scene(args, dev)
    cfg = make_config(args)
    cam = make_camera(pos=tuple(args.camera), width=cfg.width,
                      height=cfg.height, dist_from_film=args.dist_from_film,
                      focal_length=args.focal_length, radius=args.aperture,
                      device=dev)
    say(f"scene: {scene.num_tris} tris, {scene.num_lights} lights, "
        f"light area {float(scene.total_light_area):.4f}")

    t0 = time.time()
    bvh = build_bvh_for_scene(scene, cfg.leaf_size,
                              cluster_size=cfg.cluster_size) \
        if cfg.traversal in ("bvh", "packets") else None
    if bvh is not None:
        say(f"bvh: {bvh.fine.num_nodes} nodes, {bvh.fine.num_leaves} "
            f"leaves ({time.time()-t0:.2f}s)")

    state = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        state, seed = load_checkpoint(args.checkpoint, cfg, device=dev)
        say(f"resumed from {args.checkpoint} at sample {state.n}")
        if seed != args.seed:
            raise SystemExit(f"checkpoint seed {seed} != --seed {args.seed}")

    start_n = 0 if state is None else state.n
    timer = RenderTimer(on_slow=say, device=dev).start()

    def whole(st):
        return st if mesh is None else gather_pixels(mesh, st)

    def progress(done, st):
        timer.lap(f"(sample {done})")
        if done % 10 == 0:
            say(f"sample {done}")  # kernel.cu:714-715
        if args.checkpoint and args.checkpoint_every and \
                done % args.checkpoint_every == 0:
            st = whole(st)
            if lead:
                save_checkpoint(args.checkpoint, st, args.seed, cfg)

    idx = None
    if mesh is not None:
        # this rank's range: render_sharded's Morton indices
        say(f"mesh: {mesh.world} devices")
        idx = torch.arange(*tile_range(cfg.num_pixels, mesh),
                           dtype=torch.int64, device=dev)
        if state is not None:
            state = shard_pixels(mesh, state)
    state = whole(render(scene, cam, cfg, seed=args.seed, bvh=bvh,
                         state=state, progress_cb=progress, idx=idx,
                         device=dev))

    if args.checkpoint and lead:
        save_checkpoint(args.checkpoint, state, args.seed, cfg)
    # the reference's closing block, kernel.cu:752-757, over the samples
    # this run rendered (the JAX CLI counts a resumed render's earlier
    # samples too) and the whole image's pixels
    rep = timer.report(cfg.num_pixels, state.n - start_n, cfg.num_bounces)
    if not lead:
        return
    print(f"Render took {rep['total_ms']:f} ms "
          f"({rep['total_ms']/1000:f} s)", file=sys.stderr)
    print(f"{rep['ms_per_loop']:f} ms per loop", file=sys.stderr)
    print(f"{rep['mrays_per_sec']:f} Mrays/s", file=sys.stderr)

    write_render(args.output, state, cfg)
    print(f"wrote {args.output}", file=sys.stderr)


def cmd_heatmap(args):
    """Per-triangle visit histogram over one sample (reference out.csv)."""
    from . import make_camera
    from .ops import traversal
    from .ops.rng import pixel_keys, prng_key, sample_key
    from .render.camera import camera_rays
    from .render.renderer import build_bvh_for_scene
    from .utils.profiling import dump_visit_csv

    dev = _device(args)
    scene = build_scene(args, dev)
    cfg = make_config(args)
    cam = make_camera(pos=tuple(args.camera), width=cfg.width,
                      height=cfg.height, device=dev)
    bvh = build_bvh_for_scene(scene, cfg.leaf_size)
    td = traversal.make_trace_data(scene, bvh.fine)
    idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    keys = pixel_keys(sample_key(prng_key(args.seed, dev), 0), idx)
    o, d = camera_rays(cam, idx, keys)
    _, stats = traversal.trace(o, d, td, with_stats=True)
    dump_visit_csv(args.output, stats.tri_visits[:-1])
    print(f"wrote {args.output} ({scene.num_tris} rows, "
          f"{int(stats.steps)} traversal steps)", file=sys.stderr)

    if args.falsecolor:
        # the 'sponza bvh.ppm' keeper: per-pixel traversal-cost falsecolor
        from . import write_render
        from .utils.profiling import falsecolor_state

        st, _ = falsecolor_state(scene, bvh, cam, cfg, seed=args.seed)
        write_render(args.falsecolor, st, cfg)
        print(f"wrote {args.falsecolor} (BVH falsecolor)", file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(prog="cudapathtracer_tpu_torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; "
                             "fails without a card)")
        sp.add_argument("--scene", default="cornell",
                        choices=["cornell", "cornell-sphere",
                                 "cornell-empty", "colonnade"])
        sp.add_argument("--scene-detail", type=int, default=3)
        sp.add_argument("--obj", action="append", default=[],
                        help="OBJ spec path[:ox,oy,oz[:scale[:flip]]]; "
                             "repeatable, overrides --scene")
        sp.add_argument("--size", type=int, default=512)
        sp.add_argument("--spp", type=int, default=99)
        sp.add_argument("--bounces", type=int, default=3)
        sp.add_argument("--integrator", default="bdpt",
                        choices=["bdpt", "pt_nee"])
        sp.add_argument("--traversal", default="packets",
                        choices=["packets", "bvh", "brute"])
        sp.add_argument("--leaf-size", type=int, default=4)
        # None = auto by scene size
        sp.add_argument("--tile-size", type=int, default=None)
        sp.add_argument("--cluster-size", type=int, default=None)
        sp.add_argument("--max-clusters", type=int, default=4095)
        sp.add_argument("--no-packet-sort", action="store_true")
        # the engine follows the tensors' device: the CUDA kernels on the
        # card, their plain versions on the CPU
        sp.add_argument("--packet-engine", default="auto",
                        choices=["auto"])
        sp.add_argument("--samples-per-call", type=int, default=1)
        sp.add_argument("--seed", type=int, default=1234)
        sp.add_argument("--camera", type=float, nargs=3,
                        default=[0.0, 1.0, 3.0])
        sp.add_argument("--dist-from-film", type=float, default=1.0)
        sp.add_argument("--focal-length", type=float, default=3.0)
        sp.add_argument("--aperture", type=float, default=0.0)
        # quirk flags (defaults replicate the reference)
        sp.add_argument("--orthonormal-frame", action="store_true")
        sp.add_argument("--light-normal-mode", default="fixed",
                        choices=["fixed", "true"])
        sp.add_argument("--branch-pdf-correction", action="store_true")
        sp.add_argument("--jitter", action="store_true")
        sp.add_argument("--no-compensated-accum", action="store_true")

    r = sub.add_parser("render", help="progressive render to PPM or PNG")
    common(r)
    r.add_argument("-o", "--output", default="image.ppm")
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--sharded", action="store_true",
                   help="split the pixels over the ranks of a "
                        "torch.distributed group: one per card under "
                        "torchrun, else one")
    r.set_defaults(fn=cmd_render)

    h = sub.add_parser("heatmap", help="BVH visit histogram CSV (out.csv)")
    common(h)
    h.add_argument("-o", "--output", default="out.csv")
    h.add_argument("--falsecolor", default=None, metavar="IMG",
                   help="also write a per-pixel traversal-cost falsecolor "
                        "render (the reference's 'sponza bvh' keeper)")
    h.set_defaults(fn=cmd_heatmap)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
