"""Sharded rendering and the distributed differentiable train step.

Counterpart of ``cudapathtracer_tpu/parallel/shard.py``, with its design:

* **Forward render**: data parallel over pixel ranges. The scene, the BVH
  and the camera are replicated; each rank renders its contiguous Morton
  range into its own slice of the accumulation state (``render_batch``
  with the range's indices). There is no collective: the randoms key on
  the pixel index, so a range's pixels equal the whole image's.
* **Gradient pass**: each rank differentiates its range's share of the
  global mean loss, then the loss and every parameter's gradient are
  summed over the ranks with ``dist.all_reduce`` (the JAX package's
  ``jax.lax.psum``), in one flattened buffer.
* **Optimizer step**: every rank then holds the same gradients, so the
  update runs replicated.

The port is eager: ``render_sharded`` is also what the JAX package calls
``render_sharded_jit``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..diff import render_grad as rg
from ..diff.edge_sampling import build_edge_table
from ..render.renderer import AccumState, render_batch
from ..utils.config import RenderConfig
from .mesh import TileMesh, shard_pixels, tile_range


def render_sharded(scene, bvh, cam, cfg: RenderConfig, base_key,
                   state: AccumState, num_samples: int, mesh: TileMesh,
                   prep=None) -> AccumState:
    """Render ``num_samples`` progressive samples of the rank's Morton
    range into ``state``, the rank's slice of the image's AccumState
    (R / W pixels; ``n`` the replicated sample count): ``render_batch``
    over ``arange(*tile_range(cfg.num_pixels, mesh))``, as ``render(idx=)``
    renders it in chunks. ``prep``: the packet precompute, built once by
    the caller (``make_packet_prep``) or on every call. The JAX package's
    ``idx`` (the whole image's indices, for its shard_map to split) has no
    counterpart: a rank's indices follow from the mesh."""
    idx = torch.arange(*tile_range(cfg.num_pixels, mesh), dtype=torch.int64,
                       device=mesh.device)
    return render_batch(scene, bvh, cam, cfg, base_key, state, num_samples,
                        prep=prep, idx=idx)


def make_sharded_grad_fn(scene, cam, cfg: RenderConfig, mesh: TileMesh,
                         spp: int, bvh=None, edge_samples: int = 0,
                         shadow_edge_samples: int = 0):
    """-> ``fn(params, target_tile, idx_tile, key) -> (global loss,
    all-reduced GradTargets of gradients)``.

    ``params``: GradTargets (the caller's tensors are not modified);
    ``target_tile``: the target image's Vec3 over ``idx_tile``, the rank's
    Morton indices. The range's squared error is divided by the GLOBAL
    ``cfg.num_pixels``, so that the sum over ranks is the gradient of the
    whole image's mean loss (JAX shard.py:149-153). Each rank draws the
    same global edge samples and scatters only those in its range
    (``render_image_diff(idx=)``); the edge table is built once, from the
    host geometry. Every rank must call ``fn``: its all-reduce runs over
    the default process group."""
    edge_table = None
    if edge_samples > 0 or shadow_edge_samples > 0:
        edge_table = build_edge_table(scene.host_tris, device=mesh.device)

    def fn(params: rg.GradTargets, target_tile, idx_tile, key):
        leaves = [t.detach().clone().requires_grad_()
                  for t in rg.target_leaves(params)]
        img = rg.render_image_diff(
            rg.scene_with(scene, rg.from_leaves(leaves)), cam, cfg, key,
            spp, bvh=bvh, idx=idx_tile, edge_samples=edge_samples,
            edge_table=edge_table, shadow_edge_samples=shadow_edge_samples)
        dx = img.x - target_tile.x
        dy = img.y - target_tile.y
        dz = img.z - target_tile.z
        loss = torch.sum(dx * dx + dy * dy + dz * dz) / cfg.num_pixels
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        buf = torch.cat([loss.detach().reshape(1)]
                        + [g.reshape(-1) for g in grads])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        out, at = [], 1
        for g in grads:
            out.append(buf[at:at + g.numel()].view_as(g))
            at += g.numel()
        return buf[0], rg.from_leaves(out)

    return fn


def make_train_step(scene, cam, cfg: RenderConfig, mesh: TileMesh, spp: int,
                    bvh=None, optimizer=None, learning_rate: float = 1e-2,
                    edge_samples: int = 0, shadow_edge_samples: int = 0):
    """The distributed train step over scene parameters:

        (params, opt_state, target, key) -> (loss, params, opt_state)

    Each rank renders and differentiates its range, the loss and the
    gradients are all-reduced, then the update runs replicated.
    ``target``: the whole (R,) Morton-ordered target image (Vec3); each
    rank takes its range. ``optimizer``: None for plain SGD with
    ``learning_rate`` (``opt_state`` passes through), or a factory
    ``optimizer(list of tensors) -> torch.optim.Optimizer``, where the JAX
    package takes an optax transformation. With a factory, ``opt_state``
    is that optimizer: pass None on the first step, and it is made over
    copies of the parameters; pass back the one returned afterwards. The
    edge samples enable the boundary terms inside the step, as in the JAX
    package."""
    grad_fn = make_sharded_grad_fn(scene, cam, cfg, mesh, spp, bvh=bvh,
                                   edge_samples=edge_samples,
                                   shadow_edge_samples=shadow_edge_samples)
    idx = torch.arange(*tile_range(cfg.num_pixels, mesh), dtype=torch.int64,
                       device=mesh.device)

    def step(params: rg.GradTargets, opt_state, target, key):
        loss, grads = grad_fn(params, shard_pixels(mesh, target), idx, key)
        if optimizer is None:
            return loss, rg.from_leaves(
                [p.detach() - learning_rate * g
                 for p, g in zip(rg.target_leaves(params),
                                 rg.target_leaves(grads))]), opt_state
        if opt_state is None:
            opt_state = optimizer([p.detach().clone()
                                   for p in rg.target_leaves(params)])
        tensors = [p for group in opt_state.param_groups
                   for p in group["params"]]
        with torch.no_grad():
            for t, p, g in zip(tensors, rg.target_leaves(params),
                               rg.target_leaves(grads)):
                if t is not p:
                    t.copy_(p)
                t.grad = g
        opt_state.step()
        return loss, rg.from_leaves(tensors), opt_state

    return step
