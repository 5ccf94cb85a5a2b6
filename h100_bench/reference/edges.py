"""Plain shape-fitting steps with edge-sampled boundary terms: the interior
gradient of ``inverse.py`` plus the primary (silhouette) and secondary
(NEE shadow) boundary terms of Li, Aittala, Durand and Lehtinen 2018,
"Differentiable Monte Carlo Ray Tracing through Edge Sampling".

Each term is an image whose value is exactly 0 and whose gradient in the
vertices is the boundary integral, estimated from sampled points on mesh
edges:

* primary: a point p on an edge that is a silhouette from the camera,
  projected to film coordinates x(p); the radiance just either side of the
  projected edge, L- and L+ (one-sample estimates, held fixed), weights the
  motion of x(p) along the edge's unit image normal n:
  (L- - L+) * (n . x(p) - [n . x(p)]) * w scattered into p's pixel, with
  w = E |dx/du| W H / M;
* shadow: a pixel's primary hit x and a point z on an edge that is a
  silhouette from x, projected along x -> z onto a light's plane at y*;
  where y* lies on the light, the NEE integrand f(y*) times the two-sided
  visibility difference V- - V+ (probes 2e-3 either side of the curve on
  the light) weights the motion of y* along the curve's in-plane normal,
  with w = E L |dy*/du| b R / M.

Departures from the paper, which the renderer under test makes and which
this file therefore makes too:

* edges and lights are chosen uniformly (the paper samples edges by their
  projected length and keeps a hierarchy over them);
* the one-sided radiances are taken at film offsets of 2e-4 either side of
  the projected edge, and the visibility probes at 2e-3 on the light plane
  with the reference's |t - len| <= 1e-2 test (kernel.cu:405), rather than
  at the limit;
* the shadow term covers the first bounce's NEE only, with the light held
  fixed and x detached, and its branch factor is the estimator's 0.5;
* every random number is drawn as the renderer draws it (``jax.random``'s
  ``split``, ``randint`` and ``uniform`` on threefry keys, the fold-in
  words below), so both estimate from the same samples.

Plain float32 torch (bfloat16 for the control); nothing of the program.
The camera is a pinhole; each pixel's camera ray passes through a uniform
point of the pixel (redner's pixel sampling, which the boundary term's
pixel integral assumes) or, without jitter, through its corner.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import rng
from .integrators import EPS_HIT, PI, _compact1by1, pt_nee
from .inverse import LEAVES, diff_trace, l2
from .scene import MAX_FLOAT, closest_hits, cross, dot, make_geometry

# the renderer's fold-in words: the primary and shadow terms' keys, the
# one-sided radiances' sample index and the sub-pixel offsets' draw sites
PRIMARY_KEY = 0xED6E
SHADOW_KEY = 0x5AD0
BOUNDARY_SAMPLE = 1 << 20
JITTER_X, JITTER_Y = 20, 21
OFFSET_FILM = 2e-4
OFFSET_AREA = 2e-3
VIS_EPS = 1e-2
BRANCH = 0.5


# ---- jax.random's split, randint and uniform of one key -------------------

def split(key, n: int):
    """(2,) key -> (n, 2): key i hashes the counters (0, i)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = rng.threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], -1)


def _bits(key, n: int):
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = rng.threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return y0 ^ y1


def randint(key, n: int, lo: int, hi: int):
    """n int64 in [lo, hi): two words of 32 bits, from the two halves of
    the key's split, combined modulo the span in wrapping uint32 math."""
    k1, k2 = split(key, 2)
    hi_bits, lo_bits = _bits(k1, n), _bits(k2, n)
    span = max(hi - lo, 1)
    mult = (((1 << 16) % span) ** 2 & rng.MASK) % span
    off = (((hi_bits % span) * mult & rng.MASK) + lo_bits % span) & rng.MASK
    return lo + off % span


def uniform_1(key, n: int):
    """n float32 uniforms in [0, 1) of one (2,) key."""
    return rng.uniform(key[None], n)[0]


# ---- the edge table ---------------------------------------------------------

class Edges(NamedTuple):
    """Unique undirected edges in (v0, v1) order, v0 < v1: the lower face
    and the next one (-1 for an open edge)."""

    v0: torch.Tensor
    v1: torch.Tensor
    fa: torch.Tensor
    fb: torch.Tensor


def edges_of(tris) -> Edges:
    tris = tris.long()
    a = tris.reshape(-1)
    b = tris[:, [1, 2, 0]].reshape(-1)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    n = int(tris.max()) + 1
    face = torch.arange(tris.shape[0], device=tris.device).repeat_interleave(3)
    key, order = torch.sort(lo * n + hi, stable=True)
    face = face[order]
    uniq, counts = torch.unique_consecutive(key, return_counts=True)
    first = torch.cumsum(counts, 0) - counts
    second = torch.clamp(first + 1, max=key.shape[0] - 1)
    fb = torch.where(counts > 1, face[second], -1)
    return Edges(uniq // n, uniq % n, face[first], fb)


# ---- shared pieces ----------------------------------------------------------

def _morton(x, y):
    def spread(v):
        v = v & 0x0000FFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        return (v | (v << 1)) & 0x55555555
    return spread(x) | (spread(y) << 1)


def _unmorton(j):
    def compact(v):
        v = v & 0x55555555
        v = (v | (v >> 1)) & 0x33333333
        v = (v | (v >> 2)) & 0x0F0F0F0F
        v = (v | (v >> 4)) & 0x00FF00FF
        return (v | (v >> 8)) & 0x0000FFFF
    return compact(j), compact(j >> 1)


def _film_rays(cam: dict, fx, fy):
    """Pinhole rays through film coordinates (fx, fy)."""
    dist = cam.get("dist_from_film", 1.0)
    scale = -cam["focal_length"] / dist
    film = torch.stack([fx * scale, fy * scale,
                        torch.full_like(fx, dist * scale)], -1)
    o = torch.tensor(cam["pos"], dtype=fx.dtype,
                     device=fx.device).expand(fx.shape[0], 3)
    return o, film / torch.sqrt(dot(film, film))[:, None]


def _safe(v, floor):
    return torch.where(torch.abs(v) < 1e-12, torch.full_like(v, floor), v)


def _edge_points(verts, edges: Edges, eidx, u):
    """The sampled edges' end points and the points at u along them."""
    va, vb = verts[edges.v0[eidx]], verts[edges.v1[eidx]]
    return va, vb, va + (vb - va) * u[:, None]


def _silhouette(g, edges: Edges, eidx, view):
    fa, fb = edges.fa[eidx], edges.fb[eidx]
    na, nb = g.normal[fa].detach(), g.normal[fb.clamp(min=0)].detach()
    view = view.detach()
    return (fb < 0) | (dot(na, view) * dot(nb, view) < 0.0)


# ---- the two terms ----------------------------------------------------------

def primary_term(g, verts, edges: Edges, cam: dict, size: int, key,
                 num_samples: int, radiance):
    """The primary boundary image (R, 3) of value 0. ``radiance(o, d,
    kidx)``: a held-fixed one-sample estimate of rays (o, d) on the
    boundary sample's pixel keys ``kidx``."""
    E, M, dt = edges.v0.shape[0], num_samples, verts.dtype
    ke, ku = split(key, 2)
    eidx = randint(ke, M, 0, E)
    va, vb, p = _edge_points(verts, edges, eidx, uniform_1(ku, M).to(dt))
    pos = torch.tensor(cam["pos"], dtype=dt, device=verts.device)
    view = p - pos
    sil = _silhouette(g, edges, eidx, view)

    D = cam.get("dist_from_film", 1.0)

    def film(q):
        dz = q[:, 2] - pos[2]
        z = _safe(dz, -1e-12)
        return D * (q[:, 0] - pos[0]) / z, D * (q[:, 1] - pos[1]) / z, dz < 0

    fx, fy, front = film(p)
    front = front & film(va)[2] & film(vb)[2]
    # the image-space tangent d x(p) / du and its unit normal, held fixed
    e, v = (vb - va).detach(), view.detach()
    z = _safe(v[:, 2], -1e-12)
    tx = D * (e[:, 0] * z - v[:, 0] * e[:, 2]) / (z * z)
    ty = D * (e[:, 1] * z - v[:, 1] * e[:, 2]) / (z * z)
    speed = torch.sqrt(tx * tx + ty * ty)
    inv = torch.where(speed > 1e-12, 1.0 / torch.clamp(speed, min=1e-12),
                      torch.zeros_like(speed))
    nx, ny = -ty * inv, tx * inv

    fxd, fyd = fx.detach(), fy.detach()
    px = torch.floor((fxd + 0.5) * size).long()
    py = torch.floor((fyd + 0.5) * size).long()
    inside = (px >= 0) & (px < size) & (py >= 0) & (py < size) & front
    valid = sil & inside & (speed > 1e-12)

    kidx = torch.arange(M, dtype=torch.int64, device=verts.device)
    with torch.no_grad():
        l_minus = radiance(*_film_rays(cam, fxd - OFFSET_FILM * nx,
                                       fyd - OFFSET_FILM * ny), kidx)
        l_plus = radiance(*_film_rays(cam, fxd + OFFSET_FILM * nx,
                                      fyd + OFFSET_FILM * ny), kidx + M)
    xn = nx * fx + ny * fy
    w = torch.where(valid, E * speed * (size * size) / M,
                    torch.zeros_like(speed)).detach()
    c = (l_minus - l_plus) * (w * (xn - xn.detach()))[:, None]
    j = _morton(px, py)
    out = torch.zeros((size * size, 3), dtype=dt, device=verts.device)
    return out.index_add(0, j[valid], c[valid])


def shadow_term(g, verts, tris, edges: Edges, cam: dict, size: int, key,
                num_samples: int):
    """The first bounce's NEE shadow boundary image (R, 3) of value 0."""
    E, M, dt = edges.v0.shape[0], num_samples, verts.dtype
    L = g.light_area.shape[0]
    R = size * size
    dev = verts.device
    kp, ke, ku, kl = split(key, 4)
    pix = randint(kp, M, 0, R) & rng.MASK
    eidx = randint(ke, M, 0, E)
    u = uniform_1(ku, M).to(dt)
    lidx = randint(kl, M, 0, L)

    # the primary hit x of each sampled pixel, held fixed
    xs, ys = _unmorton(pix)
    o, d = _film_rays(cam, (xs.to(torch.float32) / size - 0.5).to(dt),
                      (ys.to(torch.float32) / size - 0.5).to(dt))
    t, tri = closest_hits(g, o, d)
    t = t - EPS_HIT
    missed = t > MAX_FLOAT - 1.0
    x = (o + d * torch.where(missed, torch.zeros_like(t), t)[:, None])
    x = x.detach()
    tri = tri.clamp(min=0)
    n_x, alb_x = g.normal[tri].detach(), g.albedo[tri].detach()

    va, vb, zp = _edge_points(verts, edges, eidx, u)
    w_ = zp - x
    sil = _silhouette(g, edges, eidx, w_)

    # the light, held fixed
    lt = g.light_rows[lidx]
    lv = [verts[tris[lt, k].long()].detach() for k in range(3)]
    n_l = g.normal[lt].detach()
    emi = g.emission[lt].detach()

    nw = _safe(dot(n_l, w_), 1e-12)
    s = dot(n_l, lv[0] - x) / nw
    ystar = x + w_ * s[:, None]

    e1, e2, vp = lv[1] - lv[0], lv[2] - lv[0], ystar.detach() - lv[0]
    d11, d12, d22 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
    den = d11 * d22 - d12 * d12
    den = torch.where(torch.abs(den) < 1e-20, torch.full_like(den, 1e-20),
                      den)
    bu = (d22 * dot(vp, e1) - d12 * dot(vp, e2)) / den
    bv = (d11 * dot(vp, e2) - d12 * dot(vp, e1)) / den
    on_light = (bu >= 0) & (bv >= 0) & (bu + bv <= 1.0)

    # the curve on the light: its tangent d y* / du and in-plane normal
    wu = vb - va
    ds_du = -s * dot(n_l, wu) / nw
    tangent = (wu * s[:, None] + w_ * ds_du[:, None]).detach()
    nh = cross(n_l, tangent)
    nlen = torch.sqrt(dot(nh, nh))
    speed = torch.sqrt(dot(tangent, tangent))
    nh = nh * torch.where(nlen > 1e-12, 1.0 / torch.clamp(nlen, min=1e-12),
                          torch.zeros_like(nlen))[:, None]

    y_fixed = ystar.detach()

    def visible(side):
        dv = y_fixed + nh * (side * OFFSET_AREA) - x
        ln = torch.sqrt(dot(dv, dv))
        dirv = dv / torch.clamp(ln, min=1e-12)[:, None]
        th, _ = closest_hits(g, x + dirv * EPS_HIT, dirv)
        return (torch.abs(th - ln) <= VIS_EPS).to(dt), dirv, ln

    v_minus = visible(-1.0)[0]
    v_plus, dirp, dlen = visible(1.0)
    cos_x = torch.clamp(dot(dirp, n_x), min=0.0)
    cos_l = torch.clamp(dirp[:, 1], min=0.0)   # the light's normal (0, -1, 0)
    d2 = torch.clamp(dlen * dlen, min=1e-12)
    f = alb_x * ((1.0 / PI) * cos_x * cos_l / d2)[:, None] * emi

    mterm = dot(nh, ystar)
    valid = (sil & on_light & (s > 1.0 + 1e-6) & ~missed & (speed > 1e-12))
    w = torch.where(valid, E * L * speed * BRANCH * R / M,
                    torch.zeros_like(speed)).detach()
    c = f * ((v_minus - v_plus) * w * (mterm - mterm.detach()))[:, None]
    out = torch.zeros((R, 3), dtype=dt, device=dev)
    return out.index_add(0, pix[valid], c[valid])


def image(params: dict, scene: dict, cam: dict, size: int, base_key,
          jitter: bool, num_bounces: int = 3):
    """``inverse.image``, the interior one-sample image (R, 3) in Morton
    order, with each pixel's camera ray at a uniform point of the pixel
    (``jitter``) or at its corner."""
    g = make_geometry(params["verts"], scene["tris"], scene["tri_mats"],
                      params["albedo"], params["emission"])
    dt = params["verts"].dtype
    idx = torch.arange(size * size, dtype=torch.int64,
                       device=params["verts"].device)
    keys = rng.pixel_keys(base_key, 0, idx)
    fx = _compact1by1(idx).to(torch.float32) / size - 0.5
    fy = _compact1by1(idx >> 1).to(torch.float32) / size - 0.5
    if jitter:
        fx = fx + (1.0 - rng.uniform(rng.fold_in(keys, JITTER_X), 1)[:, 0]) \
            / size
        fy = fy + (1.0 - rng.uniform(rng.fold_in(keys, JITTER_Y), 1)[:, 0]) \
            / size
    o, d = _film_rays(cam, fx.to(dt), fy.to(dt))
    return pt_nee(g, o, d, keys, diff_trace(g), None, num_bounces)


def image_with_edges(params: dict, scene: dict, edges: Edges, cam: dict,
                     size: int, base_key, edge_samples: int,
                     shadow_samples: int, jitter: bool,
                     num_bounces: int = 3):
    """The interior image plus both boundary images."""
    img = image(params, scene, cam, size, base_key, jitter, num_bounces)
    verts = params["verts"]
    g = make_geometry(verts, scene["tris"], scene["tri_mats"],
                      params["albedo"], params["emission"])
    if edge_samples:
        gf = g._replace(**{k: getattr(g, k).detach() for k in g._fields})

        def radiance(o, d, kidx):
            keys = rng.pixel_keys(base_key, BOUNDARY_SAMPLE, kidx)
            return pt_nee(gf, o, d, keys, diff_trace(gf), None, num_bounces)

        img = img + primary_term(g, verts, edges, cam, size,
                                 rng.fold_in(base_key, PRIMARY_KEY),
                                 edge_samples, radiance)
    if shadow_samples:
        img = img + shadow_term(g, verts, scene["tris"], edges, cam, size,
                                rng.fold_in(base_key, SHADOW_KEY),
                                shadow_samples)
    return img


def follow_edges(scene: dict, target_verts, cam: dict, size: int, step_keys,
                 target_key, lr: float, dtype, edge_samples: int,
                 shadow_samples: int, jitter: bool,
                 num_bounces: int = 3) -> dict:
    """SGD from the scene's own parameters over one step per key of
    ``step_keys``, against the interior image of ``target_key`` of the
    scene with its vertices at ``target_verts`` (the same topology). ->
    losses, first_grad and change as ``inverse.follow`` gives them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    edges = edges_of(scene["tris"])
    p = {k: scene[k].to(dtype).clone().requires_grad_() for k in LEAVES}
    start = {k: v.detach().clone() for k, v in p.items()}
    with torch.no_grad():
        target = image(dict(p, verts=target_verts.to(dtype)), scene, cam,
                       size, target_key, jitter, num_bounces)
    losses, first = [], None
    for key in step_keys:
        img = image_with_edges(p, scene, edges, cam, size, key, edge_samples,
                               shadow_samples, jitter, num_bounces)
        loss = l2(img, target)
        grads = torch.autograd.grad(loss, [p[k] for k in LEAVES])
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(LEAVES, grads)}
        with torch.no_grad():
            for k, gk in zip(LEAVES, grads):
                p[k] -= lr * gk
    change = {k: (p[k].detach() - start[k]) for k in LEAVES}
    return dict(losses=losses, first_grad=first, change=change)
