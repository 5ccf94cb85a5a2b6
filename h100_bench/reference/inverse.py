"""Plain inverse-rendering steps: the L2 loss of a PT+NEE image, its
gradients in the scene's parameters, and SGD.

The differentiable estimator is the detach trick: each ray's closest
triangle is found without gradients (``scene.closest_hits``), then its t is
evaluated again from that triangle's current vertices by Moller-Trumbore
with no hit test (|a| raised to 1e-12), and everything after it (hit point,
face normals, light areas and points, the BRDF and geometric terms) is plain
autograd. The image is one sample per pixel with every sample's camera rays
traced (no reused first hit).
"""

from __future__ import annotations

import torch

from . import rng
from .integrators import pinhole_rays, pt_nee
from .scene import closest_hits, cross, dot, make_geometry

LEAVES = ("verts", "albedo", "emission")


def diff_trace(g):
    def trace(o, d, mask, t_cap=None):
        t, tri = closest_hits(g, o, d, mask, t_cap)
        tc = tri.clamp(min=0)
        v0, e1, e2 = g.v0[tc], g.e1[tc], g.e2[tc]
        a = dot(e1, cross(d, e2))
        a = torch.where(torch.abs(a) < 1e-12, torch.full_like(a, 1e-12), a)
        s = (o - v0) / a[:, None]
        t_re = dot(e2, cross(s, e1))
        return torch.where(tri >= 0, t_re, t), tri
    return trace


def image(params: dict, scene: dict, cam: dict, size: int, base_key,
          num_bounces: int = 3):
    """The one-sample image (R, 3), Morton order, of sample 0 of
    ``base_key``; ``params`` holds verts, albedo and emission tensors."""
    g = make_geometry(params["verts"], scene["tris"], scene["tri_mats"],
                      params["albedo"], params["emission"])
    dt = params["verts"].dtype
    idx = torch.arange(size * size, dtype=torch.int64,
                       device=params["verts"].device)
    o, d = pinhole_rays(cam, size, size, idx, dt)
    keys = rng.pixel_keys(base_key, 0, idx)
    return pt_nee(g, o, d, keys, diff_trace(g), None, num_bounces)


def l2(img, target):
    return torch.mean(((img - target) ** 2).sum(-1))


def follow(scene: dict, cam: dict, size: int, step_keys, target_key,
           lr: float, dtype, num_bounces: int = 3) -> dict:
    """SGD from the scene's own parameters over one step per key of
    ``step_keys``, against the image of ``target_key``. ``scene``: the
    tensors verts, tris, tri_mats, albedo, emission. -> losses (one per
    step), first_grad (the first step's gradients) and change (the
    parameters after the last step minus before the first), each a dict of
    (V or M, 3) tensors by parameter name."""
    p = {k: scene[k].to(dtype).clone().requires_grad_() for k in LEAVES}
    start = {k: v.detach().clone() for k, v in p.items()}
    with torch.no_grad():
        target = image(p, scene, cam, size, target_key, num_bounces)
    losses, first = [], None
    for key in step_keys:
        loss = l2(image(p, scene, cam, size, key, num_bounces), target)
        grads = torch.autograd.grad(loss, [p[k] for k in LEAVES])
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(LEAVES, grads)}
        with torch.no_grad():
            for k, gk in zip(LEAVES, grads):
                p[k] -= lr * gk
    change = {k: (p[k].detach() - start[k]) for k in LEAVES}
    return dict(losses=losses, first_grad=first, change=change)
