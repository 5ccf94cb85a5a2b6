"""Unidirectional path tracer with next-event estimation.

Counterpart of ``cudapathtracer_tpu/integrators/pt_nee.py`` (the reference's
``radianceAlongSingleStep2``, kernel.cu:417-515), with every quirk kept:

* t -= 0.001; t < 0.001 kills the path weight; a miss (t > MAX_FLOAT-1)
  kills it and clamps the hit to triangle 0 (kernel.cu:431-441);
* emission is tested on the red channel, added, and ends the path
  (kernel.cu:453-457);
* a 50/50 branch between a cosine BRDF bounce and a light sample, without
  the 2x branch-probability factor unless ``branch_pdf_correction``
  (kernel.cu:459-464);
* the light sample traces no shadow ray and forces exactly one more bounce
  (kernel.cu:507), and its light-side cosine uses the fixed normal
  (0, -1, 0) unless ``light_normal_mode='true'`` (kernel.cu:503).

Bounce 0 is peeled out of the loop so the renderer can hand in the primary
hit, which a pinhole camera without jitter shares across samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.rng import SiteGroups, uniform_sites
from ..ops.sampling import (
    cosine_hemisphere,
    sample_triangle_point,
    triangle_areas,
)
from ..ops.shading import (
    hit_shading,
    light_lookup,
    make_light_table,
    make_shade_table,
    make_sphere_table,
    pick_light_slot,
)
from ..ops.vecmath import Vec3, dot, fma3, normalized_safe, where
from ..utils.constants import EPS_HIT, MAX_FLOAT, PI_REF


class PTParams(NamedTuple):
    num_bounces: int = 3
    orthonormal_frame: bool = False      # reference: unnormalized (quirk)
    light_normal_mode: str = "fixed"     # 'fixed' = (0,-1,0) quirk; 'true'
    branch_pdf_correction: bool = False  # reference omits the 2x (quirk)


def radiance_pt_nee(o: Vec3, d: Vec3, scene, trace_fn, keys,
                    params: PTParams = PTParams(),
                    primary_hit=None) -> Vec3:
    """Radiance of R rays. ``trace_fn(o, d, mask) -> Hit``; ``keys``: the
    (R, 2) per-pixel keys of this sample; ``primary_hit``: an optional
    precomputed Hit of the incoming rays."""
    R = o.x.shape[0]
    dev = o.x.device
    areas = triangle_areas(scene, scene.lights)
    total_area = scene.total_light_area
    shade_tab = make_shade_table(scene)
    light_tab = make_light_table(scene)
    num_tris = scene.num_tris
    sph_tab = make_sphere_table(scene) if scene.num_spheres > 0 else None

    zero = Vec3.zeros((R,), dev)
    one = Vec3.full((R,), 1.0, 1.0, 1.0, dev)
    down = Vec3.full((R,), 0.0, -1.0, 0.0, dev)

    def bounce(carry, b, hit=None):
        o, d, weight, accum, remaining = carry
        active = remaining > 0
        if hit is None:
            # dead paths (all-zero weight) are masked out of the trace;
            # everything below still uses `active`, so nothing changes
            alive = active & ((weight.x != 0.0) | (weight.y != 0.0)
                              | (weight.z != 0.0))
            hit = trace_fn(o, d, alive)

        t = hit.t - EPS_HIT                       # kernel.cu:431
        near = t < EPS_HIT                        # kernel.cu:432-435
        missed = t > MAX_FLOAT - 1.0              # kernel.cu:436-441
        weight = where(near | missed, zero, weight)
        tri = torch.where(missed, 0, torch.clamp(hit.tri, min=0))
        t = torch.where(missed, 0.0, t)

        pos = fma3(d, t, o)
        normal, albedo, emission = hit_shading(shade_tab, sph_tab, num_tris,
                                               tri, pos)

        is_emissive = emission.x != 0.0           # kernel.cu:453-457
        accum = accum + where(active & is_emissive, weight * emission, zero)
        weight = where(is_emissive, zero, weight)

        us = uniform_sites(keys, SiteGroups.PT_BOUNCE, 6, bounce=b)
        brdf_branch = us[0] < 0.5                 # kernel.cu:459-460

        # branch A: cosine BRDF bounce (kernel.cu:462-464)
        l_brdf = cosine_hemisphere(normal, us[1], us[2],
                                   params.orthonormal_frame)
        w_brdf = weight * albedo
        if params.branch_pdf_correction:
            w_brdf = w_brdf * 2.0

        # branch B: explicit light sample (kernel.cu:467-507)
        slot = pick_light_slot(total_area * us[3], areas)
        lv0, la1, la2, lnorm = light_lookup(light_tab, slot)
        p1 = sample_triangle_point(lv0, la1, la2, us[4], us[5])
        dvec = p1 - pos
        l_nee = normalized_safe(dvec)
        light_n = down if params.light_normal_mode == "fixed" else lnorm
        cos_l = torch.clamp(dot(l_nee, normal), min=0.0)
        cos_o1 = torch.clamp(dot(light_n, -l_nee), min=0.0)
        d2 = dot(dvec, dvec)
        g = cos_l * cos_o1 / torch.where(d2 > 0.0, d2, 1.0)
        w_nee = weight * albedo * ((1.0 / PI_REF) * g * total_area)
        if params.branch_pdf_correction:
            w_nee = w_nee * 2.0

        l_dir = where(brdf_branch, l_brdf, l_nee)
        new_weight = where(brdf_branch, w_brdf, w_nee)
        new_remaining = remaining - 1
        # kernel.cu:507: exactly one more bounce after a light sample
        new_remaining = torch.where(brdf_branch, new_remaining,
                                    torch.clamp(new_remaining, max=1))

        o = where(active, pos, o)
        d = where(active, l_dir, d)
        weight = where(active, new_weight, weight)
        remaining = torch.where(active, new_remaining, remaining)
        return o, d, weight, accum, remaining

    carry = (o, d, one, zero,
             torch.full((R,), params.num_bounces, dtype=torch.int32,
                        device=dev))
    carry = bounce(carry, 0, hit=primary_hit)
    for b in range(1, params.num_bounces):
        carry = bounce(carry, b)
    return carry[3]
