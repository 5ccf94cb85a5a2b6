"""Batched ray-primitive intersection.

Counterpart of ``cudapathtracer_tpu/ops/intersect.py``, formula for formula
and in the same operation order: the slab test (BVH.h:51-83, clipped to
[0, t_best]), Moller-Trumbore with the reference's epsilons
(modelLoader.h:49-123: |a| < 1e-5 is parallel, strict ``< 0`` barycentric
rejects, no ``t > 0`` check, miss = MAX_FLOAT), the Baldwin-Weber
precomputed form, and ray-sphere.

Rounding: every formula forms the fused multiply-adds that XLA forms for it
under ``jit`` (ops/vecmath.py), so the port's t equals the JAX package's bit
for bit and its hits are the same, edges included. The CUDA kernel uses
``fmaf`` at the same places and is built with ``-fmad=false`` so that the
compiler fuses nothing else.
"""

from __future__ import annotations

import torch

from ..utils.constants import EPS_PARALLEL, MAX_FLOAT
from .vecmath import Vec3, cross, dot, fma, fma3


def ray_aabb(o: Vec3, inv_d: Vec3, lo: Vec3, hi: Vec3, t_best):
    """Slab test clipped to [0, t_best] -> bool mask of box overlaps
    (``inv_d`` = 1/d)."""
    tx0 = (lo.x - o.x) * inv_d.x
    tx1 = (hi.x - o.x) * inv_d.x
    ty0 = (lo.y - o.y) * inv_d.y
    ty1 = (hi.y - o.y) * inv_d.y
    tz0 = (lo.z - o.z) * inv_d.z
    tz1 = (hi.z - o.z) * inv_d.z
    tmin = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.minimum(tz0, tz1),
    )
    tmax = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.maximum(tz0, tz1),
    )
    return (tmin <= tmax) & (tmax >= 0.0) & (tmin <= t_best)


def ray_triangle(o: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Moller-Trumbore; t may be negative, MAX_FLOAT on a miss."""
    q = cross(d, e2)
    a = dot(e1, q)
    parallel = torch.abs(a) < EPS_PARALLEL
    inv_a = torch.where(parallel, 0.0, 1.0 / torch.where(parallel, 1.0, a))
    s = (o - v0) * inv_a
    r = cross(s, e1)
    b0 = dot(s, q)
    b1 = dot(r, d)
    b2 = 1.0 - b0 - b1
    reject = parallel | (b0 < 0.0) | (b1 < 0.0) | (b2 < 0.0)
    t = dot(e2, r)
    return torch.where(reject, MAX_FLOAT, t)


def bw_precompute(e1: Vec3, e2: Vec3):
    """Baldwin-Weber attributes (n, m1, m2): n = e1 x e2,
    m1 = (e2 x n)/|n|^2, m2 = (n x e1)/|n|^2. Degenerate triangles
    (all-zero padding included) give n = m1 = m2 = 0 and reject through the
    parallel test."""
    n = cross(e1, e2)
    nn = dot(n, n)
    inv_nn = torch.where(nn > 0.0, 1.0 / torch.where(nn > 0.0, nn, 1.0),
                         0.0)
    m1 = cross(e2, n) * inv_nn
    m2 = cross(n, e1) * inv_nn
    return n, m1, m2


def ray_triangle_bw(o: Vec3, d: Vec3, v0: Vec3, n: Vec3, m1: Vec3, m2: Vec3):
    """Baldwin-Weber test on precomputed attributes; the same contract as
    ``ray_triangle`` (decision-equivalent in exact arithmetic)."""
    sx = o - v0
    nd = dot(d, n)
    parallel = torch.abs(nd) < EPS_PARALLEL
    inv = torch.where(parallel, 0.0, 1.0 / torch.where(parallel, 1.0, nd))
    t = -dot(sx, n) * inv
    w = fma3(d, t, sx)
    bu = dot(m1, w)
    bv = dot(m2, w)
    bw = 1.0 - bu - bv
    reject = parallel | (bu < 0.0) | (bv < 0.0) | (bw < 0.0)
    return torch.where(reject, MAX_FLOAT, t)


def ray_sphere(o: Vec3, d: Vec3, center: Vec3, radius):
    """Nearest t > 0 of a ray-sphere hit (sphere.h:7-13), MAX_FLOAT on miss."""
    oc = o - center
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = fma(b, b, -(4.0 * a * c))
    miss = disc < 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = torch.where(t0 > 0.0, t0, t1)
    return torch.where(miss | (t <= 0.0), MAX_FLOAT, t)
