"""Shading and light tables and their lookups.

Counterpart of ``cudapathtracer_tpu/ops/shading.py``. The JAX package packs
each table into 16-wide float rows and carries integer ids as floats
id + 2^23, both workarounds for the TPU's slow scalar gathers; its one-hot
matmul light lookup (shading.py:138-146) is another. Here each table is a
plain (rows, 16) float tensor read by an index gather with the row clamped,
which returns the same values bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vecmath import Vec3, gather, normalized_safe, take_clip, where


class ShadeTable(NamedTuple):
    """(T+1, 9) per-triangle rows [n.xyz, albedo.xyz, emission.xyz]; row T
    is a zero default."""

    tri_rows: torch.Tensor


class LightTable(NamedTuple):
    """(L+1, 15) per-light rows [v0.xyz, a1.xyz, a2.xyz, n.xyz,
    emission.xyz] with a1 = v1-v0, a2 = v2-v0. Row L is the no-match
    fallback, scene triangle 0 (the reference's fall-through,
    kernel.cu:232)."""

    light_rows: torch.Tensor


class SphereTable(NamedTuple):
    """(S+1, 10) per-sphere rows [center.xyz, radius, albedo.xyz,
    emission.xyz]; the last row is a zero sentinel."""

    sph_rows: torch.Tensor


def make_shade_table(scene) -> ShadeTable:
    alb = gather(scene.mat_albedo, scene.tri_mat)
    emi = gather(scene.mat_emission, scene.tri_mat)
    rows = torch.stack([*scene.tri_norm, *alb, *emi], dim=1)
    return ShadeTable(tri_rows=torch.cat([rows, rows.new_zeros(1, 9)]))


def tri_shading(table: ShadeTable, tri):
    """tri: (R,) ids >= 0 -> (normal, albedo, emission)."""
    r = take_clip(table.tri_rows, tri)
    return (Vec3(r[:, 0], r[:, 1], r[:, 2]), Vec3(r[:, 3], r[:, 4], r[:, 5]),
            Vec3(r[:, 6], r[:, 7], r[:, 8]))


def make_light_table(scene) -> LightTable:
    idx = torch.cat([scene.lights.to(torch.int32),
                     torch.zeros(1, dtype=torch.int32,
                                 device=scene.lights.device)])
    v0 = gather(scene.verts, take_clip(scene.tri_v0, idx))
    v1 = gather(scene.verts, take_clip(scene.tri_v1, idx))
    v2 = gather(scene.verts, take_clip(scene.tri_v2, idx))
    n = gather(scene.tri_norm, idx)
    emi = gather(scene.mat_emission, take_clip(scene.tri_mat, idx))
    rows = torch.stack([*v0, *(v1 - v0), *(v2 - v0), *n, *emi], dim=1)
    return LightTable(light_rows=rows)


def light_lookup(table: LightTable, slot, with_emission: bool = False):
    """slot: (R,) in [0, L], clamped. -> (v0, a1, a2, normal[, emission])
    of the picked lights."""
    r = take_clip(table.light_rows, slot)
    out = (Vec3(r[:, 0], r[:, 1], r[:, 2]), Vec3(r[:, 3], r[:, 4], r[:, 5]),
           Vec3(r[:, 6], r[:, 7], r[:, 8]), Vec3(r[:, 9], r[:, 10], r[:, 11]))
    if with_emission:
        return out + (Vec3(r[:, 12], r[:, 13], r[:, 14]),)
    return out


def make_sphere_table(scene) -> SphereTable:
    alb = gather(scene.mat_albedo, scene.sph_mat)
    emi = gather(scene.mat_emission, scene.sph_mat)
    rows = torch.stack([*scene.sph_center, scene.sph_radius, *alb, *emi],
                       dim=1)
    return SphereTable(sph_rows=torch.cat([rows, rows.new_zeros(1, 10)]))


def hit_shading(shade_tab: ShadeTable, sph_tab, num_tris: int, tri, pos):
    """Shading for a mixed triangle/sphere hit id (ids >= num_tris are
    spheres, id - num_tris). ``sph_tab`` is None for a sphere-free scene.
    -> (normal, albedo, emission)."""
    n, alb, emi = tri_shading(shade_tab, tri)
    if sph_tab is None:
        return n, alb, emi
    is_s = tri >= num_tris
    r = take_clip(sph_tab.sph_rows, torch.clamp(tri - num_tris, min=0))
    c = Vec3(r[:, 0], r[:, 1], r[:, 2])
    n = where(is_s, normalized_safe(pos - c), n)
    alb = where(is_s, Vec3(r[:, 4], r[:, 5], r[:, 6]), alb)
    emi = where(is_s, Vec3(r[:, 7], r[:, 8], r[:, 9]), emi)
    return n, alb, emi


def _cumsum_f32(a):
    """Prefix sums of a short 1-D float32 tensor, added in order in float32:
    the order XLA's cumsum takes for short inputs (``torch.cumsum``
    accumulates in float64 on the CPU and rounds otherwise)."""
    acc = torch.zeros((), dtype=a.dtype, device=a.device)
    parts = []
    for i in range(a.shape[0]):
        acc = acc + a[i]
        parts.append(acc)
    return torch.stack(parts)


def pick_light_slot(rand_area, areas):
    """The reference's light-pick scan (kernel.cu:231-244) -> light slot;
    no match -> slot L (the fallback row). Light j matches iff
    prev_cum[j] < x < cum[j] strictly; the first match wins.

    L <= 64: the (R, L) broadcast scan. L > 64: binary search over the
    cumulative areas, with the scan's exact comparisons on the found row,
    so the two agree except within one-ULP bin-boundary windows."""
    L = areas.shape[0]
    if L == 0:
        return torch.zeros(rand_area.shape, dtype=torch.int32,
                           device=rand_area.device)
    cum = _cumsum_f32(areas)
    if L <= 64:
        prev_cum = cum - areas
        rem = rand_area[:, None] - prev_cum[None, :]
        match = (rem > 0.0) & (rem < areas[None, :])
        any_match = torch.any(match, dim=1)
        j = torch.argmax(match.to(torch.int8), dim=1).to(torch.int32)
        return torch.where(any_match, j, L)
    j = torch.searchsorted(cum, rand_area, side="left").to(torch.int32)
    jc = torch.clamp(j, 0, L - 1)
    area_j = take_clip(areas, jc)
    prev_j = take_clip(cum, jc) - area_j
    rem = rand_area - prev_j
    matched = (rem > 0.0) & (rem < area_j)
    return torch.where(matched, jc, L)
