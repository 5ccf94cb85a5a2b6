"""One rank of the port's tile-sharded tests (test_torch_parallel.py,
test_torch_checkpoint_sharded.py, test_torch_parallel_cuda.py).

``spawn_ranks`` starts the ranks through the port's
``parallel.launch.start_ranks``: each imports torch and the port only,
joins a gloo group (or the backend named) with a 60 s timeout and runs
``run``, which runs each job of the comma-separated ``jobs``; the parent
builds the references, the JAX package's included, and compares. Jobs:

* ``render``: the replicated BVH's arrays; the pt_nee Cornell render (16^2,
  3 spp, seed 4) and the BDPT one (16^2, 1 spp, seed 1), each rank's range
  gathered into the whole image;
* ``grad``: ``make_sharded_grad_fn`` at 16^2 pt_nee 1 spp against a key-9
  target, interior and with both boundary terms at 256 samples each; three
  SGD steps (lr 0.03) toward a target with a 1.5x brighter light (the
  parameters after the first kept); one step
  of a ``torch.optim.Adam`` factory (lr 1e-3) on the interior inputs;
* ``checkpoint``: a 16^2 pt_nee render (samples_per_call 2) saved sharded at
  2 spp, loaded and resumed to 4, gathered; a set whose ranks saved
  different seeds must fail to load on every rank.
"""

import os
import sys

import numpy as np
import torch

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.models import procedural as P
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.ops.vecmath import Vec3
from cudapathtracer_tpu_torch.parallel import shard
from cudapathtracer_tpu_torch.parallel.launch import start_ranks
from cudapathtracer_tpu_torch.parallel.mesh import gather_pixels, tile_range
from cudapathtracer_tpu_torch.render.renderer import build_bvh_for_scene
from cudapathtracer_tpu_torch.utils import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 16
# the sharded grad and train-step cases: the boundary terms' samples, the
# SGD rate and steps of the descent (a rate that descends at every step
# with the hits of the moved walls: at 0.3 and 0.1 the second step
# overshoots), Adam's rate
EDGE_SAMPLES = 256
SGD_LR = 0.03
SGD_STEPS = 3
ADAM_LR = 1e-3


def cornell(dev, **kw):
    scene = P.to_scene(P.cornell_box(**kw), dev)
    return scene, T.make_camera(width=SIZE, height=SIZE, device=dev)


def cfg_of(integrator, spp, samples_per_call=None):
    return T.RenderConfig(width=SIZE, height=SIZE, spp=spp,
                          integrator=integrator,
                          samples_per_call=samples_per_call or spp)


def sharded_render(mesh, scene, cam, bvh, cfg, seed, spp, state=None):
    start, stop = tile_range(cfg.num_pixels, mesh)
    if state is None:
        state = T.init_accum(cfg, device=mesh.device,
                             num_pixels=stop - start)
    return shard.render_sharded(scene, bvh, cam, cfg,
                                prng_key(seed, mesh.device), state, spp,
                                mesh)


def state_arrays(prefix, st):
    return {f"{prefix}_{k}": t.cpu().numpy() for k, t in zip(
        ("img_x", "img_y", "img_z", "comp_x", "comp_y", "comp_z"),
        (*st.img, *st.comp))} | {f"{prefix}_n": np.asarray(st.n)}


def job_render(mesh, out, out_dir):
    dev = mesh.device
    scene, cam = cornell(dev)
    bvh = build_bvh_for_scene(scene, 4)
    for name, t in zip(bvh.fine._fields, bvh.fine):
        out[f"bvh_fine_{name}"] = t.cpu().numpy()
    for name in bvh._fields[1:]:
        out[f"bvh_{name}"] = getattr(bvh, name).cpu().numpy()
    for label, integrator, spp, seed in (("pt_nee", "pt_nee", 3, 4),
                                         ("bdpt", "bdpt", 1, 1)):
        cfg = cfg_of(integrator, spp)
        tile = sharded_render(mesh, scene, cam, bvh, cfg, seed, spp)
        out |= state_arrays(f"{label}_tile", tile)
        out |= state_arrays(label, gather_pixels(mesh, tile))


def job_grad(mesh, out, out_dir):
    dev = mesh.device
    scene, cam = cornell(dev)
    bvh = build_bvh_for_scene(scene, 4)
    cfg = cfg_of("pt_nee", 1)
    key = prng_key(0, dev)
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, cfg, prng_key(9, dev), 1,
                                      bvh=bvh)
    out["target"] = np.stack([c.cpu().numpy() for c in target], axis=1)
    idx = torch.arange(*tile_range(cfg.num_pixels, mesh), device=dev)
    tile_target = Vec3(*(c[idx] for c in target))
    for label, n_edge in (("interior", 0), ("both_terms", EDGE_SAMPLES)):
        fn = shard.make_sharded_grad_fn(scene, cam, cfg, mesh, 1, bvh=bvh,
                                        edge_samples=n_edge,
                                        shadow_edge_samples=n_edge)
        loss, g = fn(rg.targets_of(scene), tile_target, idx, key)
        out[f"{label}_loss"] = loss.cpu().numpy()
        for i, t in enumerate(rg.target_leaves(g)):
            out[f"{label}_g{i}"] = t.cpu().numpy()

    adam = shard.make_train_step(
        scene, cam, cfg, mesh, 1, bvh=bvh,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=ADAM_LR))
    _, params, opt = adam(rg.targets_of(scene), None, target, key)
    for i, t in enumerate(rg.target_leaves(params)):
        out[f"adam_p{i}"] = t.cpu().numpy()

    with torch.no_grad():
        bright = rg.render_image_diff(cornell(dev, light_scale=1.5)[0], cam,
                                      cfg, key, 1, bvh=bvh)
    sgd = shard.make_train_step(scene, cam, cfg, mesh, 1, bvh=bvh,
                                learning_rate=SGD_LR)
    params, losses = rg.targets_of(scene), []
    for step in range(SGD_STEPS + 1):
        loss, params, _ = sgd(params, None, bright, key)
        losses.append(float(loss))
        if step == 0:
            for i, t in enumerate(rg.target_leaves(params)):
                out[f"sgd_first_p{i}"] = t.cpu().numpy()
    out["sgd_losses"] = np.asarray(losses)
    out["sgd_emission_x"] = params.emission.x.cpu().numpy()


def job_checkpoint(mesh, out, out_dir):
    dev = mesh.device
    scene, cam = cornell(dev)
    bvh = build_bvh_for_scene(scene, 4)
    cfg = cfg_of("pt_nee", 4, samples_per_call=2)
    path = os.path.join(out_dir, "ck.npz")
    part = sharded_render(mesh, scene, cam, bvh, cfg, 1234, 2)
    ck.save_checkpoint_sharded(path, part, 1234, cfg, mesh)
    loaded, seed = ck.load_checkpoint_sharded(path, mesh, cfg)
    same = all(torch.equal(a, b) for a, b in zip((*loaded.img, *loaded.comp),
                                                 (*part.img, *part.comp)))
    out["reload_equal"] = np.asarray(same and loaded.n == 2 and seed == 1234)
    resumed = sharded_render(mesh, scene, cam, bvh, cfg, seed, 2,
                             state=loaded)
    out |= state_arrays("resumed", gather_pixels(mesh, resumed))

    mixed = os.path.join(out_dir, "mixed.npz")
    ck.save_checkpoint_sharded(mixed, part, 1234 + mesh.rank, cfg, mesh)
    try:
        ck.load_checkpoint_sharded(mixed, mesh, cfg)
        out["mixed_raised"] = np.asarray("")
    except AssertionError as e:
        out["mixed_raised"] = np.asarray(str(e))


JOBS = {"render": job_render, "grad": job_grad,
        "checkpoint": job_checkpoint}


def run(mesh, out_dir, jobs):
    """The rank's jobs; -> their results, keyed ``<job>.<name>``."""
    torch.set_num_threads(1)
    res = {}
    for job in jobs.split(","):
        out = dict(rank=np.asarray(mesh.rank), world=np.asarray(mesh.world))
        JOBS[job](mesh, out, out_dir)
        res |= {f"{job}.{k}": v for k, v in out.items()}
    assert "jax" not in sys.modules, "the port imported jax"
    return res


def spawn_ranks(jobs, world, out_dir, device="cpu", backend="gloo",
                timeout=300):
    """Start ``world`` ranks running ``jobs`` (one thread each) and return
    a function that waits for them (``start_ranks``'s) and returns each
    job's per-rank results, {job: [dict of arrays of rank r]}."""
    wait = start_ranks(__file__, "run", world, out_dir, device=device,
                       backend=backend, args=[jobs],
                       env={"OMP_NUM_THREADS": "1"}, timeout=timeout)

    def results():
        ranks = wait()
        return {job: [{k[len(job) + 1:]: v for k, v in r.items()
                       if k.startswith(job + ".")} for r in ranks]
                for job in jobs.split(",")}

    return results
