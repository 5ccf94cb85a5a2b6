"""Plain pinhole camera, PT+NEE and BDPT radiance.

The estimators of CulDeVu/CUDAPathTracer ``kernel.cu``, with its quirks
(the renderer under test keeps them, so they are the semantics):

* PT+NEE (``radianceAlongSingleStep2``, kernel.cu:417-515): t -= 0.001 and
  t < 0.001 kills the path; emission (tested on red) is added and ends it;
  a 50/50 branch between a cosine bounce and a light sample without the 2x
  branch factor; the light sample traces no shadow ray, forces one more
  bounce and takes the light's normal as (0, -1, 0).
* BDPT (``radianceAlongSingleStep``, kernel.cu:217-415): a 2-vertex light
  and a 3-vertex camera subpath joined by the unweighted sum of four
  connections, the camera's first-hit emission added once per connection,
  a connection dimmer than 0.01 in every channel dropped, the second camera
  bounce keeping a miss's t and clamping its id to 0, a G of 0 set to 1.
* The tangent frame is not normalized; the uniform hemisphere takes y = u1;
  triangle points fold u + v > 1 by mirroring; pi is 3.14159.

Randoms come from ``rng`` keyed as the renderer keys them, so a sample here
is the same sample there. Vectors are (R, 3) tensors in one dtype.
"""

from __future__ import annotations

import torch

from . import rng
from .scene import (Geometry, closest_hits, cross, dot, normalize,
                    normalize_safe)

PI = 3.14159
EPS_HIT = 0.001
EPS_VIS = 0.01
CUTOFF = 0.01


def _compact1by1(v):
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    return (v | (v >> 8)) & 0x0000FFFF


def pinhole_rays(cam: dict, width: int, height: int, idx, dtype):
    """Rays of Morton pixels ``idx``: film x / W - 0.5 (no half-pixel
    offset), scaled by -focal / distance (camera.h:36-43, 77-97)."""
    x = _compact1by1(idx)
    y = _compact1by1(idx >> 1)
    fx = (x.to(torch.float32) / width - 0.5).to(dtype)
    fy = (y.to(torch.float32) / height - 0.5).to(dtype)
    dist = cam.get("dist_from_film", 1.0)
    scale = -cam["focal_length"] / dist
    film = torch.stack([fx * scale, fy * scale,
                        torch.full_like(fx, dist * scale)], -1)
    o = torch.tensor(cam["pos"], dtype=dtype,
                     device=idx.device).expand(idx.shape[0], 3)
    return o, normalize(film)


def _frame(n):
    """The unnormalized tangent and bitangent (kernel.cu:44-54, 70)."""
    z = torch.zeros_like(n)
    c1 = cross(n, z + torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype,
                                   device=n.device))
    c2 = cross(n, z + torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype,
                                   device=n.device))
    t = torch.where((dot(c1, c1) > dot(c2, c2))[:, None], c1, c2)
    return t, cross(n, t)


def _to_world(n, lx, ly, lz):
    t, b = _frame(n)
    return normalize(b * lz[:, None] + n * ly[:, None] + t * lx[:, None])


def cosine_dir(n, u1, u2):
    r = torch.sqrt(u1)
    th = 2.0 * PI * u2
    return _to_world(n, r * torch.cos(th),
                     torch.sqrt(torch.clamp(1.0 - u1, min=0.0)),
                     r * torch.sin(th))


def uniform_dir(n, u1, u2):
    r = torch.sqrt(1.0 - u1 * u1)
    ph = 2.0 * PI * u2
    return _to_world(n, r * torch.cos(ph), u1, r * torch.sin(ph))


def pick_light(g: Geometry, x):
    """The reference's scan (kernel.cu:231-244): light j iff
    cum[j] - area[j] < x < cum[j], the first match; none -> slot L, whose
    row is triangle 0. -> the triangle ids of the picked lights."""
    L = g.light_area.shape[0]
    if L == 0:
        return g.light_rows[torch.zeros_like(x, dtype=torch.int64)]
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    cums = []
    for j in range(L):
        acc = acc + g.light_area[j]
        cums.append(acc)
    cum = torch.stack(cums)
    rem = x[:, None] - (cum - g.light_area)[None]
    match = (rem > 0.0) & (rem < g.light_area[None])
    slot = torch.where(match.any(1), torch.argmax(match.to(torch.int8), 1),
                       L)
    return g.light_rows[slot]


def triangle_point(g: Geometry, tri, u, v):
    over = (u + v) > 1.0
    u = torch.where(over, 1.0 - u, u)
    v = torch.where(over, 1.0 - v, v)
    return g.v0[tri] + g.e1[tri] * u[:, None] + g.e2[tri] * v[:, None]


def _uniforms(keys, group, n, bounce, dtype):
    return rng.uniform_sites(keys, group, n, bounce).to(dtype)


def pt_nee(g: Geometry, o, d, keys, trace, primary=None, num_bounces=3):
    """PT+NEE radiance (R, 3) of rays ``o``, ``d``. ``trace(o, d, mask) ->
    (t, tri)``; ``primary``: the camera rays' (t, tri), traced once."""
    R = o.shape[0]
    dt = o.dtype
    weight = torch.ones((R, 3), dtype=dt, device=o.device)
    accum = torch.zeros((R, 3), dtype=dt, device=o.device)
    remaining = torch.full((R,), num_bounces, dtype=torch.int64,
                           device=o.device)
    down = torch.tensor([0.0, -1.0, 0.0], dtype=dt, device=o.device)
    for b in range(num_bounces):
        active = remaining > 0
        if b == 0 and primary is not None:
            t, tri = primary
        else:
            t, tri = trace(o, d, active & (weight != 0).any(1))
        missed = tri < 0
        t = t - EPS_HIT
        dead = missed | (t < EPS_HIT)
        weight = torch.where(dead[:, None], 0.0, weight)
        tri = torch.where(missed, 0, tri)
        t = torch.where(missed, 0.0, t)
        pos = o + d * t[:, None]
        n, alb, emi = g.normal[tri], g.albedo[tri], g.emission[tri]
        lit = emi[:, 0] != 0.0
        accum = accum + torch.where((active & lit)[:, None], weight * emi,
                                    0.0)
        weight = torch.where(lit[:, None], 0.0, weight)

        us = _uniforms(keys, rng.PT_BOUNCE, 6, b, dt)
        brdf = us[0] < 0.5
        l_brdf = cosine_dir(n, us[1], us[2])
        w_brdf = weight * alb
        light = pick_light(g, g.total_area * us[3])
        dvec = triangle_point(g, light, us[4], us[5]) - pos
        l_nee = normalize_safe(dvec)
        cos_l = torch.clamp(dot(l_nee, n), min=0.0)
        cos_o = torch.clamp(dot(down.expand_as(l_nee), -l_nee), min=0.0)
        d2 = dot(dvec, dvec)
        gterm = cos_l * cos_o / torch.where(d2 > 0.0, d2, 1.0)
        w_nee = weight * alb * ((1.0 / PI) * gterm * g.total_area)[:, None]

        left = torch.where(brdf, remaining - 1,
                           torch.clamp(remaining - 1, max=1))
        o = torch.where(active[:, None], pos, o)
        d = torch.where(active[:, None],
                        torch.where(brdf[:, None], l_brdf, l_nee), d)
        weight = torch.where(active[:, None],
                             torch.where(brdf[:, None], w_brdf, w_nee),
                             weight)
        remaining = torch.where(active, left, remaining)
    return accum


def _safe_div(num, den):
    ok = torch.abs(den) > 0.0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def bdpt(g: Geometry, o, d, keys, trace, primary=None):
    """BDPT radiance (R, 3). ``trace(o, d, mask, t_cap=None) -> (t, tri)``."""
    R = o.shape[0]
    dt = o.dtype
    dev = o.device
    every = torch.ones((R,), dtype=torch.bool, device=dev)
    us = _uniforms(keys, rng.BDPT, 7, 0, dt)

    # light vertex 0
    light = pick_light(g, g.total_area * us[0])
    lnorm = g.normal[light]
    l_e = g.emission[light]
    x0 = triangle_point(g, light, us[1], us[2]) + lnorm * EPS_HIT
    ip0 = g.total_area.expand(R)

    # camera vertex 3: the first hit
    t, tri = primary if primary is not None else trace(o, d, every)
    missed = tri < 0
    t = torch.where(missed, 0.0, t - EPS_HIT)
    tri = torch.where(missed, 0, tri)
    x3 = o + d * t[:, None]
    n3, a3, cam_e = g.normal[tri], g.albedo[tri], g.emission[tri]

    # both subpath bounces
    o_dir = uniform_dir(lnorm, us[3], us[4])
    d2dir = cosine_dir(n3, us[5], us[6])
    tb, trib = trace(torch.cat([x0, x3]), torch.cat([o_dir, d2dir]),
                     torch.cat([every, every]))

    # light vertex 1
    t = tb[:R]
    missed = trib[:R] < 0
    t = torch.where(missed, 0.0, t - EPS_HIT)
    tri = torch.where(missed, 0, trib[:R])
    n1, a1 = g.normal[tri], g.albedo[tri]
    gl = torch.abs(dot(n1, o_dir)) / torch.clamp(t * t, min=EPS_HIT)
    x1 = x0 + o_dir * t[:, None]
    ip1 = _safe_div(torch.full_like(gl, 2.0 * PI), gl)

    # camera vertex 2: a miss keeps its t, its id is clamped to 0
    t2 = tb[R:] - EPS_HIT
    tri2 = torch.clamp(trib[R:], min=0)
    n2, a2 = g.normal[tri2], g.albedo[tri2]
    g2 = _safe_div(torch.abs(dot(n3, d2dir) * dot(n2, d2dir)), t2 * t2)
    g2 = torch.where(g2 == 0.0, 1.0, g2)
    x2 = x3 + d2dir * t2[:, None]
    ip2 = PI / g2

    x = [x0, x1, x2, x3, o]
    nrm = [lnorm, n1, n2, n3, d]
    alb = [None, a1, a2, a3, None]
    ip = [ip0, ip1, ip2, torch.ones_like(ip0), torch.ones_like(ip0)]

    def seg_factor(k):
        seg = x[k] - x[k - 1]
        ray = normalize_safe(seg)
        gg = _safe_div(torch.abs(dot(ray, nrm[k]) * dot(ray, nrm[k - 1])),
                       dot(seg, seg))
        return alb[k] * ((1.0 / PI) * (gg * ip[k]))[:, None]

    conns = []
    for i in (0, 1):
        for j in (2, 3):
            w = l_e * ip0[:, None]
            for k in range(1, i + 1):
                w = w * seg_factor(k)
            for k in range(j + 1, 4):
                w = w * seg_factor(k)
            seg = x[j] - x[i]
            n2s = dot(seg, seg)
            seg_len = torch.where(n2s > 0.0,
                                  torch.sqrt(torch.where(n2s > 0.0, n2s,
                                                         1.0)), 0.0)
            ray = normalize_safe(seg)
            gg = torch.clamp(dot(ray, nrm[j]) * dot(-ray, nrm[i]), min=0.0)
            gg = _safe_div(gg, n2s)
            w = w * alb[j] * ((1.0 / PI) * (gg * ip[j]))[:, None]
            conns.append((w, x[i], ray, seg_len, w.max(1).values > CUTOFF))

    seg_all = torch.cat([c[3] for c in conns])
    ts, _ = trace(torch.cat([c[1] for c in conns]),
                  torch.cat([c[2] for c in conns]),
                  torch.cat([c[4] for c in conns]),
                  t_cap=seg_all + 2.0 * EPS_VIS)
    accum = torch.zeros((R, 3), dtype=dt, device=dev)
    for ci, (w, _, _, seg_len, bright) in enumerate(conns):
        seen = torch.abs(ts[ci * R:(ci + 1) * R] - seg_len) <= EPS_VIS
        accum = accum + w * (bright & seen).to(dt)[:, None] + cam_e
    return accum


def brute_trace(g: Geometry):
    """The integrators' ``trace`` over all of ``g``'s triangles."""
    def trace(o, d, mask, t_cap=None):
        return closest_hits(g, o, d, mask, t_cap)
    return trace


def render_samples(g: Geometry, cam: dict, width: int, height: int,
                   integrator: str, base_key, samples, idx, dtype,
                   num_bounces: int = 3, chunk_rays: int = 1 << 19):
    """The float64 mean over sample indices ``samples`` of the radiance at
    Morton pixels ``idx``, each sample keyed as the renderer keys it. The
    camera rays' first hit is traced once (a pinhole camera's rays are the
    same in every sample). -> (R, 3) float64."""
    trace = brute_trace(g)
    o1, d1 = pinhole_rays(cam, width, height, idx, dtype)
    p_t, p_tri = trace(o1, d1, None)
    R = idx.shape[0]
    total = torch.zeros((R, 3), dtype=torch.float64, device=idx.device)
    per = max(1, chunk_rays // max(R, 1))
    samples = list(samples)
    for a in range(0, len(samples), per):
        part = samples[a:a + per]
        S = len(part)
        keys = torch.cat([rng.pixel_keys(base_key, s, idx) for s in part])
        o, d = o1.repeat(S, 1), d1.repeat(S, 1)
        prim = (p_t.repeat(S), p_tri.repeat(S))
        if integrator == "pt_nee":
            rad = pt_nee(g, o, d, keys, trace, prim, num_bounces)
        else:
            rad = bdpt(g, o, d, keys, trace, prim)
        total += rad.double().reshape(S, R, 3).sum(0)
    return total / max(len(samples), 1)

