"""Direction and light-point sampling with the reference's estimators.

Counterpart of ``cudapathtracer_tpu/ops/sampling.py`` (all but its
``pick_light``, which ops/shading.py:pick_light_slot replaces), quirks
included (SURVEY.md §7), with the fused multiply-adds XLA forms for them
(ops/vecmath.py): the tangent frame is NOT normalized (kernel.cu:44-54),
the uniform hemisphere takes y = u1 (kernel.cu:60-77), the cosine
hemisphere maps r = sqrt(u1), y = sqrt(1 - u1) (kernel.cu:78-99), and
triangle points fold u + v > 1 by mirroring (kernel.cu:254-258).
"""

from __future__ import annotations

import torch

from ..utils.constants import PI_REF
from .vecmath import Vec3, cos, cross, dot, fma, fma3, gather, length, \
    normalized, sin, sqrt, take_clip, where


def tangent_frame(n: Vec3, orthonormal: bool = False):
    """Reference getTangent (kernel.cu:44-54) + bitangent (kernel.cu:70),
    unnormalized unless ``orthonormal``."""
    dev = n.x.device
    c1 = cross(n, Vec3.full(n.shape, 0.0, 0.0, 1.0, dev))
    c2 = cross(n, Vec3.full(n.shape, 0.0, 1.0, 0.0, dev))
    t = where(dot(c1, c1) > dot(c2, c2), c1, c2)
    if orthonormal:
        t = normalized(t)
    b = cross(n, t)
    return t, b


def _frame_dir(n: Vec3, local: Vec3, orthonormal: bool) -> Vec3:
    """norm*y + tangent*x + bitangent*z, then normalize (kernel.cu:71-74)."""
    t, b = tangent_frame(n, orthonormal)
    d = fma3(b, local.z, fma3(n, local.y, t * local.x))
    return normalized(d)


def uniform_hemisphere(n: Vec3, u1, u2, orthonormal: bool = False) -> Vec3:
    """randRay (kernel.cu:60-77): u1 is the cosine itself (uniform in cos,
    not in solid angle). Nominal pdf 1/(2*pi)."""
    r = sqrt(fma(-u1, u1, torch.ones_like(u1)))
    phi = 2.0 * PI_REF * u2
    local = Vec3(r * cos(phi), u1, r * sin(phi))
    return _frame_dir(n, local, orthonormal)


def cosine_hemisphere(n: Vec3, u1, u2, orthonormal: bool = False) -> Vec3:
    """cosineWeightedRay (kernel.cu:78-99). Nominal pdf cos(theta)/pi."""
    r = sqrt(u1)
    theta = 2.0 * PI_REF * u2
    local = Vec3(r * cos(theta), sqrt(torch.clamp(1.0 - u1, min=0.0)),
                 r * sin(theta))
    return _frame_dir(n, local, orthonormal)


def sample_triangle_point(v0: Vec3, a1: Vec3, a2: Vec3, u, v):
    """Uniform point on a triangle with the reference's fold
    (kernel.cu:254-261)."""
    over = (u + v) > 1.0
    u = torch.where(over, 1.0 - u, u)
    v = torch.where(over, 1.0 - v, v)
    return fma3(a2, v, fma3(a1, u, v0))


def triangle_areas(scene, light_idx):
    """Areas of the given triangles from the current vertex positions."""
    v0 = gather(scene.verts, take_clip(scene.tri_v0, light_idx))
    v1 = gather(scene.verts, take_clip(scene.tri_v1, light_idx))
    v2 = gather(scene.verts, take_clip(scene.tri_v2, light_idx))
    return length(cross(v1 - v0, v2 - v0)) * 0.5
