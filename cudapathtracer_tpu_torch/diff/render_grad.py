"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

Counterpart of ``cudapathtracer_tpu/diff/render_grad.py``: the gradients of
an image loss w.r.t. the vertex positions, the sphere centers and radii and
the materials' albedo and emission.

The detach trick: the hit search is discrete and detached (every engine
runs under ``torch.no_grad()``, and the CUDA kernels have no backward),
but once a ray's hit id is known its t is evaluated again, with gradients,
from the hit triangle's current vertices (``ray_triangle_t_unchecked``) or
sphere (``ray_sphere_t_unchecked``). Everything downstream (hit point,
normals through ``recompute_derived``, BSDF, light pdf, geometric terms) is
plain torch, so autograd differentiates the continuous part of the
estimator exactly. Two boundary terms (diff/edge_sampling.py) add the
silhouette motion of primary visibility (``edge_samples``) and of the NEE
shadow (``shadow_edge_samples``) as value-zero images.

Every sample but the last is one ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint`` inside ``lax.scan``): its graph is freed after
the forward and rebuilt in the backward, where its traces run again. The
last sample keeps its graph: autograd reaches it first and frees it before
it recomputes any earlier sample, so the backward still holds one sample's
graph at a time, and a call of 1 spp traces each ray once. Where boundary
terms run, their graph is built while the last sample's is alive, so the
peak rises by at most one sample's graph. The samples are summed in order
and scaled by 1/spp, as the scan does. The gradients use the primal's
sample keys (common random numbers), so finite differences of the loss
converge to them.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..accel.bvh import refit
from ..models.scene import Scene, recompute_derived
from ..ops.intersect import ray_sphere_t_unchecked, ray_triangle_t_unchecked
from ..ops.rng import fold_in, pixel_keys, sample_key
from ..ops.shading import make_shade_table, tri_shading
from ..ops.traversal import Hit
from ..ops.vecmath import Vec3, gather, stop_gradient, take_clip
from ..render.camera import camera_rays
from ..render.renderer import _radiance, make_trace_fn
from ..utils import tracing
from ..utils.config import RenderConfig, check_supported
from .edge_sampling import (boundary_image, build_edge_table,
                            shadow_boundary_image)

# fold_in words of the boundary terms' sample keys (render_grad.py:195,
# 219) and the boundary radiance's sample index
PRIMARY_EDGE_KEY = 0xED6E
SHADOW_EDGE_KEY = 0x5AD0
BOUNDARY_SAMPLE = 1 << 20


def make_diff_trace_fn(scene: Scene, base_trace_fn):
    """Wrap a detached trace so that its t is differentiable.

    ``base_trace_fn(o, d, mask, t_cap=None, vis_band=0.0)`` -> Hit runs
    under ``torch.no_grad()``; the wrapper evaluates t again from the found
    id with the scene's (differentiable) vertices or sphere parameters.
    Misses keep the MAX_FLOAT sentinel with no gradient. A visibility lane
    retired as occluded keeps its occluder's id, whose t lies below the
    band floor, so the band decision does not change."""
    T = scene.num_tris
    S = scene.num_spheres

    def diff_trace(o: Vec3, d: Vec3, mask, t_cap=None, vis_band=0.0) -> Hit:
        with torch.no_grad():
            hit = base_trace_fn(o, d, mask, t_cap=t_cap, vis_band=vis_band)
        tri = torch.clamp(hit.tri, min=0)
        tric = torch.clamp(tri, max=max(T - 1, 0))  # sphere ids past T
        v0, v1, v2 = (gather(scene.verts, take_clip(c, tric))
                      for c in (scene.tri_v0, scene.tri_v1, scene.tri_v2))
        t_re = ray_triangle_t_unchecked(o, d, v0, v1, v2)
        if S > 0:
            s = torch.clamp(tri - T, 0, S - 1)
            t_sph = ray_sphere_t_unchecked(o, d, gather(scene.sph_center, s),
                                           take_clip(scene.sph_radius, s))
            t_re = torch.where(tri >= T, t_sph, t_re)
        return Hit(tri=hit.tri, t=torch.where(hit.tri >= 0, t_re, hit.t))

    return diff_trace


def _checkpointed(s: int, spp: int) -> bool:
    """Whether sample ``s`` of ``spp`` is checkpointed: all but the
    last."""
    return s < spp - 1


def render_image_diff(scene: Scene, cam, cfg: RenderConfig, base_key,
                      spp: int, bvh=None, trace_data=None, idx=None,
                      edge_samples: int = 0, edge_table=None,
                      shadow_edge_samples: int = 0) -> Vec3:
    """The differentiable image, (R,) Vec3 in Morton order: the mean of
    ``spp`` samples, all but the last checkpointed, plus the boundary
    terms.

    The scene's normals and light area are recomputed from its vertices
    first, and the trace closure is built from the current (detached)
    vertices on every call, so the packets are gathered again after each
    update. ``bvh`` is the accel structure the engines need (all but
    ``traversal='brute'``); its topology stays the input scene's and its
    boxes are refit to the current vertices (``accel.bvh.refit``), so the
    hits are the current geometry's however far the vertices moved (a far
    move costs speed alone). Without ``bvh``, a
    fine ``trace_data`` (``traversal.make_trace_data``) serves every engine
    but brute force with the per-ray walk, the analytic spheres folded in
    (JAX render_grad.py:123-139); its vertices are the caller's, not the
    current ones. ``idx``: an optional
    Morton-contiguous pixel tile; the boundary terms scatter only into it,
    so the tiles' images add up to the whole image's. ``edge_table``
    (``build_edge_table``) is needed by either boundary term."""
    with tracing.span("diff.forward"):
        return _render_image_diff(scene, cam, cfg, base_key, spp, bvh,
                                  trace_data, idx, edge_samples, edge_table,
                                  shadow_edge_samples)


def _render_image_diff(scene, cam, cfg, base_key, spp, bvh, trace_data, idx,
                       edge_samples, edge_table, shadow_edge_samples):
    check_supported(cfg)
    scene = recompute_derived(scene)
    dev = scene.verts.x.device
    # the hit search reads the current geometry, detached: the accel's
    # boxes are refit to it, and the packets (no cached prep) and the fine
    # TraceData are built again on every call
    if bvh is not None and cfg.traversal != "brute":
        with torch.no_grad():
            bvh = refit(bvh, scene.verts, (scene.tri_v0, scene.tri_v1,
                                           scene.tri_v2))
    if cfg.traversal != "brute" and bvh is None and trace_data is not None:
        base_trace = make_trace_fn(
            stop_gradient(scene), dataclasses.replace(cfg, traversal="bvh"),
            None, trace_data=trace_data)
    else:
        base_trace = make_trace_fn(stop_gradient(scene), cfg, bvh)
    trace_fn = make_diff_trace_fn(scene, base_trace)
    if idx is None:
        idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    r = idx.shape[0]

    def radiance(o, d, keys):
        return _radiance(o, d, scene, trace_fn, keys, cfg)

    def one_sample(s):
        keys = pixel_keys(sample_key(base_key, s), idx)
        o, d = camera_rays(cam, idx, keys, jitter=cfg.jitter)
        return tuple(radiance(o, d, keys))

    acc = Vec3.zeros((r,), dev)
    for s in range(spp):
        if _checkpointed(s, spp):
            # the randoms are counters, so the recompute needs no RNG
            # state; the backward's run of the sample is the span
            # diff.recompute
            sample = checkpoint(
                one_sample, s, use_reentrant=False, preserve_rng_state=False,
                context_fn=lambda: (nullcontext(), tracing.span(
                    "diff.recompute", sample=s)))
        else:
            # the last sample's graph is backpropagated and freed before
            # any earlier sample is recomputed, so keeping it holds the
            # peak at one sample's graph; the boundary terms below build
            # theirs beside it, at most one sample's graph more
            tracing.count("diff.kept_graphs", 1)
            sample = one_sample(s)
        acc = acc + Vec3(*sample)
    img = acc * (1.0 / spp)

    # every tile draws the same global edge samples and scatters only those
    # in its Morton range [idx[0], idx[0] + r)
    tile_offset = int(idx[0]) if r != cfg.num_pixels else 0
    if (edge_samples > 0 or shadow_edge_samples > 0) and edge_table is None:
        raise ValueError("the boundary terms need an EdgeTable "
                         "(build_edge_table)")
    if edge_samples > 0:
        def boundary_radiance(o, d, kidx):
            # a one-sample detached estimate on its own sample index
            keys = pixel_keys(sample_key(base_key, BOUNDARY_SAMPLE), kidx)
            return radiance(o, d, keys)

        img = img + boundary_image(
            scene, cam, edge_table, boundary_radiance,
            fold_in(base_key, PRIMARY_EDGE_KEY), edge_samples,
            cfg.num_pixels, tile_offset=tile_offset, tile_pixels=r)

    if shadow_edge_samples > 0:
        if cfg.integrator != "pt_nee":
            raise ValueError("the shadow boundary term models the PT+NEE "
                             "direct term")
        stab = make_shade_table(scene)

        def shade_normal_fn(tri):
            n, alb, _ = tri_shading(stab, tri)
            return stop_gradient(n), stop_gradient(alb)

        img = img + shadow_boundary_image(
            scene, cam, edge_table, base_trace, shade_normal_fn,
            fold_in(base_key, SHADOW_EDGE_KEY), shadow_edge_samples,
            cfg.num_pixels,
            branch_factor=1.0 if cfg.branch_pdf_correction else 0.5,
            light_normal_mode=cfg.light_normal_mode,
            tile_offset=tile_offset, tile_pixels=r)
    return img


class GradTargets(NamedTuple):
    """The differentiable parameters (BASELINE.json's grad targets)."""

    verts: Vec3
    albedo: Vec3
    emission: Vec3
    sph_center: Vec3
    sph_radius: torch.Tensor


def target_leaves(p: GradTargets):
    """A GradTargets' 13 tensors in one list (an optimizer's parameters)."""
    return [*p.verts, *p.albedo, *p.emission, *p.sph_center, p.sph_radius]


def from_leaves(ts) -> GradTargets:
    """``target_leaves``' inverse: 13 tensors in that order -> a
    GradTargets."""
    return GradTargets(Vec3(*ts[0:3]), Vec3(*ts[3:6]), Vec3(*ts[6:9]),
                       Vec3(*ts[9:12]), ts[12])


def targets_of(scene: Scene) -> GradTargets:
    """The scene's parameters as fresh leaf tensors that require grad."""
    return from_leaves([t.detach().clone().requires_grad_()
                        for t in target_leaves(GradTargets(
                            scene.verts, scene.mat_albedo,
                            scene.mat_emission, scene.sph_center,
                            scene.sph_radius))])


def scene_with(scene: Scene, p: GradTargets) -> Scene:
    return scene._replace(verts=p.verts, mat_albedo=p.albedo,
                          mat_emission=p.emission, sph_center=p.sph_center,
                          sph_radius=p.sph_radius)


def l2_loss(img: Vec3, target: Vec3):
    dx = img.x - target.x
    dy = img.y - target.y
    dz = img.z - target.z
    return torch.mean(dx * dx + dy * dy + dz * dz)


def make_loss_fn(scene: Scene, cam, cfg: RenderConfig, base_key, spp: int,
                 bvh=None, edge_samples: int = 0,
                 shadow_edge_samples: int = 0):
    """loss(params, target) -> scalar tensor, differentiable in params.

    The boundary terms' edge table is built here, on the host, from the
    scene's ``host_tris``. The BVH topology is the input scene's, its boxes
    refit on every call: rebuild it between optimizer steps that move
    vertices far for speed, not for the hits. ``shadow_edge_samples`` is
    the sharded train step's second term (JAX
    parallel/shard.py:make_sharded_grad_fn)."""
    edge_table = None
    if edge_samples > 0 or shadow_edge_samples > 0:
        edge_table = build_edge_table(scene.host_tris,
                                      device=scene.verts.x.device)

    def loss(params: GradTargets, target: Vec3):
        img = render_image_diff(scene_with(scene, params), cam, cfg,
                                base_key, spp, bvh=bvh,
                                edge_samples=edge_samples,
                                edge_table=edge_table,
                                shadow_edge_samples=shadow_edge_samples)
        return l2_loss(img, target)

    return loss


def render_and_grad(scene: Scene, cam, cfg: RenderConfig, base_key,
                    spp: int, target: Vec3, bvh=None, edge_samples: int = 0,
                    shadow_edge_samples: int = 0):
    """(loss, GradTargets of gradients): the backward pass's entry point.
    A parameter the loss does not reach gets zeros."""
    loss_fn = make_loss_fn(scene, cam, cfg, base_key, spp, bvh=bvh,
                           edge_samples=edge_samples,
                           shadow_edge_samples=shadow_edge_samples)
    params = targets_of(scene)
    loss = loss_fn(params, target)
    leaves = target_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), from_leaves(
        [torch.zeros_like(p) if g is None else g
         for p, g in zip(leaves, grads)])
