"""Fixed 2+3-vertex bidirectional path tracer.

Counterpart of ``cudapathtracer_tpu/integrators/bdpt.py`` (the reference's
live integrator ``radianceAlongSingleStep``, kernel.cu:217-415), formula for
formula and with every quirk kept:

* a 2-vertex light subpath and a 3-vertex camera subpath (vertex 4 is the
  camera itself, whose "normal" slot holds the ray direction,
  kernel.cu:301-305), joined by an UNWEIGHTED sum over the four (i, j)
  connection strategies in {0, 1} x {2, 3}: no MIS (kernel.cu:350-412);
* the camera's first-hit emission is added once per connection, four times
  in all (kernel.cu:410);
* a connection whose weight has no channel above the throughput cutoff is
  zeroed, not passed through (kernel.cu:394-398);
* the second camera bounce resets no miss and clamps the triangle id to 0
  where the reference reads out of bounds (kernel.cu:334-336), and its G
  term of 0 (or NaN) becomes 1 (kernel.cu:339-342).

The two subpath bounces trace as one (2R,) batch and the four connections'
shadow rays as one (4R,) batch, capped at the segment length + 2 eps, with
``vis_band`` = 3 eps marking them visibility-only: the decision
|t - len| <= eps is the closest-hit query's for every ray either way.
Where XLA forms fused multiply-adds for the JAX package's formulas, the port
forms the same ones (ops/vecmath.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.rng import SiteGroups, uniform_sites
from ..ops.sampling import (
    cosine_hemisphere,
    sample_triangle_point,
    triangle_areas,
    uniform_hemisphere,
)
from ..ops.shading import (
    light_lookup,
    make_light_table,
    make_shade_table,
    pick_light_slot,
    tri_shading,
)
from ..ops.vecmath import (
    Vec3,
    div,
    dot,
    fma3,
    max_component,
    normalized_safe,
    safe_div,
    safe_length,
)
from ..utils.constants import (
    EPS_HIT,
    EPS_VISIBILITY,
    MAX_FLOAT,
    PI_REF,
    THROUGHPUT_CUTOFF,
)


class BDPTParams(NamedTuple):
    orthonormal_frame: bool = False  # reference: unnormalized frame (quirk)


LIGHT_PATH_SIZE = 2   # kernel.cu:219
CAMERA_PATH_SIZE = 3  # kernel.cu:220
PATH_SIZE = LIGHT_PATH_SIZE + CAMERA_PATH_SIZE
CAM_IND = PATH_SIZE - 1


def _cat(vs) -> Vec3:
    return Vec3(*(torch.cat([getattr(v, c) for v in vs]) for c in "xyz"))


def radiance_bdpt(o: Vec3, d: Vec3, scene, trace_fn, keys,
                  params: BDPTParams = BDPTParams(),
                  primary_hit=None) -> Vec3:
    """Radiance of R camera rays. ``trace_fn(o, d, mask, t_cap=None,
    vis_band=0.0) -> Hit``; ``keys``: the (R, 2) per-pixel keys of this
    sample; ``primary_hit``: an optional precomputed Hit of the camera
    rays. Raises for a scene with spheres, as the JAX package does: its
    BDPT is triangles only."""
    if scene.num_spheres > 0:
        raise NotImplementedError(
            "the BDPT integrator is triangles-only (like the reference's: "
            "sphere.h predates its BDPT and was never wired in, "
            "kernel.cu:21); render spheres with integrator='pt_nee'")
    R = o.x.shape[0]
    dev = o.x.device
    areas = triangle_areas(scene, scene.lights)
    total_area = scene.total_light_area
    all_on = torch.ones((R,), dtype=torch.bool, device=dev)
    shade_tab = make_shade_table(scene)
    light_tab = make_light_table(scene)

    x = [None] * PATH_SIZE
    norm = [None] * PATH_SIZE
    albedo = [None] * PATH_SIZE
    inv_prob = [None] * PATH_SIZE

    # ---- light subpath vertex 0: a point on a light (kernel.cu:230-267) ---
    us = uniform_sites(keys, SiteGroups.BDPT, 7)
    slot = pick_light_slot(total_area * us[0], areas)
    lv0, la1, la2, lnorm, l_e = light_lookup(light_tab, slot,
                                             with_emission=True)
    p = sample_triangle_point(lv0, la1, la2, us[1], us[2])
    x[0] = fma3(lnorm, EPS_HIT, p)            # offset by n * 0.001
    norm[0] = lnorm
    inv_prob[0] = torch.broadcast_to(total_area, (R,))

    # ---- camera vertex 4: the camera itself (kernel.cu:301-305) ----------
    x[CAM_IND] = o
    norm[CAM_IND] = d                         # the direction (quirk)
    inv_prob[CAM_IND] = torch.ones((R,), device=dev)

    # ---- camera vertex 3: the first hit (kernel.cu:306-328) --------------
    hit = primary_hit if primary_hit is not None else trace_fn(o, d, all_on)
    t = hit.t - EPS_HIT
    missed = t > MAX_FLOAT - 1.0
    tri = torch.where(missed, 0, torch.clamp(hit.tri, min=0))
    t = torch.where(missed, 0.0, t)
    x[3] = fma3(d, t, o)
    norm[3], albedo[3], cam_hit_emission = tri_shading(shade_tab, tri)
    inv_prob[3] = torch.ones((R,), device=dev)

    # ---- both subpath bounces as one (2R,) trace --------------------------
    o_dir = uniform_hemisphere(norm[0], us[3], us[4],
                               params.orthonormal_frame)
    d2dir = cosine_hemisphere(norm[3], us[5], us[6],
                              params.orthonormal_frame)
    hit_b = trace_fn(_cat([x[0], x[3]]), _cat([o_dir, d2dir]),
                     torch.ones((2 * R,), dtype=torch.bool, device=dev))

    # ---- light subpath vertex 1: one uniform bounce (kernel.cu:268-298) --
    t = hit_b.t[:R] - EPS_HIT
    missed = t > MAX_FLOAT - 1.0
    tri = torch.where(missed, 0, torch.clamp(hit_b.tri[:R], min=0))
    t = torch.where(missed, 0.0, t)
    norm[1], albedo[1], _ = tri_shading(shade_tab, tri)
    g = torch.abs(dot(norm[1], o_dir)) / torch.clamp(t * t, min=EPS_HIT)
    x[1] = fma3(o_dir, t, x[0])
    inv_prob[1] = safe_div(2.0 * PI_REF, g)

    # ---- camera vertex 2: a cosine bounce (kernel.cu:329-348) ------------
    t2 = hit_b.t[R:] - EPS_HIT                # no miss reset (kernel.cu:334)
    tri2 = torch.clamp(hit_b.tri[R:], min=0)  # clamp (the reference reads OOB)
    norm[2], albedo[2], _ = tri_shading(shade_tab, tri2)
    g2 = safe_div(torch.abs(dot(norm[3], d2dir) * dot(norm[2], d2dir)),
                  t2 * t2)
    g2 = torch.where(g2 == 0.0, 1.0, g2)      # kernel.cu:339-342
    x[2] = fma3(d2dir, t2, x[3])
    inv_prob[2] = div(PI_REF, g2)

    # ---- connections (kernel.cu:350-412) ---------------------------------
    def seg_factor(k):
        """f_s * G * invProb of path segment (k-1, k) (kernel.cu:362-371)."""
        seg = x[k] - x[k - 1]
        ray = normalized_safe(seg)
        g = torch.abs(dot(ray, norm[k]) * dot(ray, norm[k - 1]))
        g = safe_div(g, dot(seg, seg))
        return albedo[k] * (1.0 / PI_REF) * (g * inv_prob[k])

    conns = []
    for i in range(LIGHT_PATH_SIZE):                      # i in {0, 1}
        for j in range(LIGHT_PATH_SIZE, PATH_SIZE - 1):   # j in {2, 3}
            weight = l_e * inv_prob[0]
            for k in range(1, i + 1):                     # light side
                weight = weight * seg_factor(k)
            for k in range(j + 1, PATH_SIZE - 1):         # camera side
                weight = weight * seg_factor(k)
            # the middle link (kernel.cu:384-407)
            seg = x[j] - x[i]
            seg_len = safe_length(seg)
            ray = normalized_safe(seg)
            g = torch.clamp(dot(ray, norm[j]) * dot(-ray, norm[i]), min=0.0)
            g = safe_div(g, dot(seg, seg))
            weight = weight * (albedo[j] * (1.0 / PI_REF) * (g * inv_prob[j]))
            bright = max_component(weight) > THROUGHPUT_CUTOFF
            conns.append((weight, x[i], ray, seg_len, bright))

    # the four connections' shadow rays as one (4R,) visibility query
    seg_cat = torch.cat([c[3] for c in conns])
    sh = trace_fn(_cat([c[1] for c in conns]), _cat([c[2] for c in conns]),
                  torch.cat([c[4] for c in conns]),
                  t_cap=seg_cat + 2.0 * EPS_VISIBILITY,
                  vis_band=3.0 * EPS_VISIBILITY)

    accum = Vec3.zeros((R,), dev)
    for ci, (weight, _, _, seg_len, bright) in enumerate(conns):
        visible = torch.abs(sh.t[ci * R:(ci + 1) * R] - seg_len) \
            <= EPS_VISIBILITY
        accum = accum + weight * (bright & visible).to(torch.float32)
        accum = accum + cam_hit_emission          # kernel.cu:410 (4x quirk)
    return accum
