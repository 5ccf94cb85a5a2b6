"""Visibility (silhouette) gradients by edge sampling.

Counterpart of ``cudapathtracer_tpu/diff/edge_sampling.py``, formula for
formula. The interior gradient (diff/render_grad.py) holds the hit ids
fixed, so it cannot see a vertex move sweep a silhouette edge across
pixels. Two boundary terms add that (Li et al. 2018, edge sampling):

* ``boundary_image``, primary visibility: sample points on mesh edges,
  keep the camera silhouettes, evaluate the radiance just either side of
  the projected edge (detached) and scatter
  (L- - L+) * [n.x_img(p) - detach(n.x_img(p))] * w into the pixel the
  point projects to;
* ``shadow_boundary_image``, the NEE shadow of the first bounce: project
  occluder edge points from the primary hit onto a light and scatter
  f(y*) (V- - V+) * [n.y* - detach(n.y*)] * w.

Both images are exactly zero in value and carry the boundary term only in
their gradients, so adding them leaves the render untouched. Every
``stop_gradient`` of the JAX package is a ``.detach()`` at the same place,
and its ``zero.at[j].add(..., mode="drop")`` an ``index_add`` over the
entries that land in the tile (the uint32 wrap of ``j - tile_offset`` keeps
the same ones). The samples are drawn with ``rng.split``/``randint``/
``uniform_1``, bit for bit ``jax.random``'s. Scope as in the JAX package:
pinhole camera, box pixel filter, triangle geometry.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.rng import randint, split, uniform_1
from ..ops.vecmath import (Vec3, dot, fma, fma3, gather, normalized,
                           sqrt, take_clip)
from ..utils import tracing
from ..utils.constants import EPS_HIT, MAX_FLOAT, PI_REF
from ..utils.morton import morton_decode, morton_encode

_U32 = 0xFFFFFFFF


class EdgeTable(NamedTuple):
    """Unique undirected mesh edges and their faces: ev0 < ev1 (E,) i32
    vertex ids, fa (E,) i32 the owning face, fb (E,) i32 the second face or
    -1 (an open edge, always a silhouette)."""

    ev0: torch.Tensor
    ev1: torch.Tensor
    fa: torch.Tensor
    fb: torch.Tensor

    @property
    def num_edges(self):
        return self.ev0.shape[0]


def build_edge_table(tris, *, device) -> EdgeTable:
    """Edge extraction on the host from (T, 3) int triangles, onto
    ``device``."""
    tris = np.asarray(tris, np.int64)
    T = tris.shape[0]
    ea = tris[:, [0, 1, 2]].reshape(-1)
    eb = tris[:, [1, 2, 0]].reshape(-1)
    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    face = np.repeat(np.arange(T, dtype=np.int64), 3)
    key = lo * (tris.max() + 1) + hi
    order = np.argsort(key, kind="stable")
    key_s, lo_s, hi_s, face_s = key[order], lo[order], hi[order], face[order]
    first = np.ones(key_s.shape[0], bool)
    first[1:] = key_s[1:] != key_s[:-1]
    idx_first = np.flatnonzero(first)
    # the second face: the next entry when it shares the key
    nxt = idx_first + 1
    has_b = np.zeros(idx_first.shape[0], bool)
    in_range = nxt < key_s.shape[0]
    has_b[in_range] = key_s[nxt[in_range]] == key_s[idx_first[in_range]]
    fb = np.full(idx_first.shape[0], -1, np.int64)
    fb[has_b] = face_s[nxt[has_b]]

    def t(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    return EdgeTable(ev0=t(lo_s[idx_first]), ev1=t(hi_s[idx_first]),
                     fa=t(face_s[idx_first]), fb=t(fb))


def _project_film(cam, p: Vec3):
    """World point -> film coords (fx, fy) in [-0.5, 0.5]^2 and whether it
    lies in front of the pinhole camera (dz < 0): the inverse of
    camera_rays' film mapping, fx = D * dx / dz."""
    dx = p.x - cam.pos.x
    dy = p.y - cam.pos.y
    dz = p.z - cam.pos.z
    safe_z = torch.where(torch.abs(dz) < 1e-12, -1e-12, dz)
    fx = cam.dist_from_film * dx / safe_z
    fy = cam.dist_from_film * dy / safe_z
    return fx, fy, dz < 0.0


def _rays_from_film(cam, fx, fy):
    """Pinhole primary rays through film coords (camera.h:90-94)."""
    scale = -cam.focal_length / cam.dist_from_film
    film = Vec3(fx * scale, fy * scale,
                torch.broadcast_to(cam.dist_from_film * scale, fx.shape))
    o = Vec3(*(torch.broadcast_to(c, fx.shape) for c in cam.pos))
    return o, normalized(film)


def _zero_image(n, device):
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    return Vec3(z, z, z)


def _scatter(j, cx, cy, cz, tile_offset, tile_pixels):
    """``zeros(tile_pixels).at[j - tile_offset].add(c, mode="drop")`` with
    uint32 indices: an entry whose index wraps out of the tile is dropped.
    The entries kept are counted (``edges.kept``) from the shape the
    ``nonzero`` already read."""
    jt = (j - int(tile_offset)) & _U32
    keep = torch.nonzero(jt < tile_pixels).flatten()
    tracing.count("edges.kept", keep.shape[0])
    jk = jt[keep]
    zero = torch.zeros((tile_pixels,), dtype=torch.float32, device=j.device)
    return Vec3(*(zero.index_add(0, jk, c[keep]) for c in (cx, cy, cz)))


def boundary_image(scene, cam, edges: EdgeTable, radiance_fn, key,
                   num_samples: int, num_pixels: int,
                   offset_film: float = 2e-4, tile_offset=0,
                   tile_pixels: int | None = None) -> Vec3:
    """The primary boundary term as an (R,) image whose value is exactly 0
    and whose vertex gradients carry the silhouette term.

    ``radiance_fn(o, d, kidx)`` -> Vec3: a one-sample radiance estimate of
    the rays (its gradient is discarded). ``tile_offset``/``tile_pixels``
    keep the scatter to the Morton range [offset, offset + tile_pixels):
    every tile draws the same samples, so the tiles' images add up to the
    whole image's. Traced as the span ``diff.edges.primary`` with counters
    ``edges.drawn`` and ``edges.kept`` (the samples that scatter)."""
    with tracing.span("diff.edges.primary", samples=int(num_samples)):
        return _boundary_image(scene, cam, edges, radiance_fn, key,
                               num_samples, num_pixels, offset_film,
                               tile_offset, tile_pixels)


def _boundary_image(scene, cam, edges, radiance_fn, key, num_samples,
                    num_pixels, offset_film, tile_offset, tile_pixels):
    E = edges.num_edges
    M = int(num_samples)
    dev = scene.verts.x.device
    if tile_pixels is None:
        tile_pixels = num_pixels
    if E == 0:
        # randint over the empty [0, 0): an edge-free mesh has no term
        return _zero_image(tile_pixels, dev)
    tracing.count("edges.drawn", M)
    ke, ku = split(key, 2)
    eidx = randint(ke, M, 0, E)
    u = uniform_1(ku, M)

    va = gather(scene.verts, take_clip(edges.ev0, eidx))
    vb = gather(scene.verts, take_clip(edges.ev1, eidx))
    p = fma3(vb - va, u, va)  # differentiable in verts

    # ---- silhouette test (detached) ---------------------------------------
    fa = take_clip(edges.fa, eidx)
    fb = take_clip(edges.fb, eidx)
    na = gather(scene.tri_norm, fa)
    nb = gather(scene.tri_norm, torch.clamp(fb, min=0))
    view = Vec3(p.x - cam.pos.x, p.y - cam.pos.y, p.z - cam.pos.z)
    silhouette = ((fb < 0) | (dot(na, view) * dot(nb, view) < 0.0)).detach()

    # ---- projection (fx, fy attached; everything else detached) -----------
    fx, fy, in_front = _project_film(cam, p)
    _, _, fra = _project_film(cam, va)
    _, _, frb = _project_film(cam, vb)
    # the image-space tangent at p, d(x_img)/du: the perspective jacobian
    D = cam.dist_from_film
    ex = vb.x - va.x
    ey = vb.y - va.y
    ez = vb.z - va.z
    dzs = torch.where(torch.abs(view.z) < 1e-12, -1e-12, view.z).detach()
    txu = (D * fma(ex, dzs, -(view.x.detach() * ez)) / (dzs * dzs)).detach()
    tyu = (D * fma(ey, dzs, -(view.y.detach() * ez)) / (dzs * dzs)).detach()
    speed = sqrt(fma(txu, txu, tyu * tyu))
    inv_speed = torch.where(speed > 1e-12,
                            1.0 / torch.clamp(speed, min=1e-12), 0.0)
    nhx = -tyu * inv_speed  # the unit image normal (detached)
    nhy = txu * inv_speed

    W, H = cam.width, cam.height
    fxd = fx.detach()
    fyd = fy.detach()
    px = torch.floor((fxd + 0.5) * W).to(torch.int32)
    py = torch.floor((fyd + 0.5) * H).to(torch.int32)
    inside = ((px >= 0) & (px < W) & (py >= 0) & (py < H)
              & in_front & fra & frb)
    valid = silhouette & inside & (speed > 1e-12)

    # ---- the one-sided radiances (detached) -------------------------------
    eps = offset_film
    o_m, d_m = _rays_from_film(cam, fxd - eps * nhx, fyd - eps * nhy)
    o_p, d_p = _rays_from_film(cam, fxd + eps * nhx, fyd + eps * nhy)
    kidx = torch.arange(M, dtype=torch.int64, device=dev)
    with torch.no_grad():
        l_m = radiance_fn(o_m, d_m, kidx)
        l_p = radiance_fn(o_p, d_p, kidx + M)
    dl = l_m - l_p  # (L-) - (L+)

    # ---- the value-zero, gradient-carrying contribution -------------------
    # n . x_img(p(theta)): only this factor keeps its gradient
    xn = fma(nhx, fx, nhy * fy)
    xn_motion = xn - xn.detach()
    # pdf: uniform over edges x u, so the weight is E * |dx/du|; the pixel
    # mean divides by the pixel's film area 1/(W H)
    w = torch.where(valid, float(E) * speed * (W * H) / M, 0.0).detach()

    j = morton_encode(px, py)
    j = torch.where(valid, j, num_pixels)  # dropped
    return _scatter(j, dl.x * w * xn_motion, dl.y * w * xn_motion,
                    dl.z * w * xn_motion, tile_offset, tile_pixels)


def shadow_boundary_image(scene, cam, edges: EdgeTable, trace_fn,
                          shade_normal_fn, key, num_samples: int,
                          num_pixels: int, branch_factor: float = 0.5,
                          light_normal_mode: str = "fixed",
                          vis_eps: float = 1e-2, offset_area: float = 2e-3,
                          tile_offset=0,
                          tile_pixels: int | None = None) -> Vec3:
    """The NEE shadow boundary term of the first bounce, as an (R,) image of
    value 0 whose vertex gradients carry it.

    Samples (pixel, edge, u, light) uniformly: an occluder edge point z,
    seen from the primary hit x, projects along x -> z onto the light plane
    at y*; where the edge is a silhouette from x and y* lies on the light,
    the NEE integrand f(y*) times the two-sided visibility difference
    (V- - V+, the reference's |t - len| <= vis_eps test, kernel.cu:405)
    weights the motion of y* along the curve's in-plane normal. The light
    is held fixed and x detached: the term targets the occluder.
    ``branch_factor`` is the estimator's NEE branch weight (0.5, or 1.0
    with ``branch_pdf_correction``).

    ``trace_fn(o, d, mask)`` -> Hit, the closest hit (detached);
    ``shade_normal_fn(tri)`` -> (normal, albedo) at the hit triangles.
    Traced as the span ``diff.edges.shadow`` with counters ``edges.drawn``
    and ``edges.kept``."""
    with tracing.span("diff.edges.shadow", samples=int(num_samples)):
        return _shadow_boundary_image(
            scene, cam, edges, trace_fn, shade_normal_fn, key, num_samples,
            num_pixels, branch_factor, light_normal_mode, vis_eps,
            offset_area, tile_offset, tile_pixels)


def _shadow_boundary_image(scene, cam, edges, trace_fn, shade_normal_fn, key,
                           num_samples, num_pixels, branch_factor,
                           light_normal_mode, vis_eps, offset_area,
                           tile_offset, tile_pixels):
    E = edges.num_edges
    M = int(num_samples)
    L = int(scene.lights.shape[0])
    dev = scene.verts.x.device
    if tile_pixels is None:
        tile_pixels = num_pixels
    if L == 0 or E == 0:
        # no lights, no NEE term; no edges, randint(0, 0) is undefined
        return _zero_image(tile_pixels, dev)
    tracing.count("edges.drawn", M)
    kp, ke, ku, kl = split(key, 4)
    pix = randint(kp, M, 0, num_pixels).to(torch.int64) & _U32
    eidx = randint(ke, M, 0, E)
    u = uniform_1(ku, M)
    lidx = randint(kl, M, 0, L)

    # ---- the primary hit x of the sampled pixels (all detached) -----------
    xpix, ypix = morton_decode(pix)
    fx = xpix.to(torch.float32) / cam.width - 0.5
    fy = ypix.to(torch.float32) / cam.height - 0.5
    o, d = _rays_from_film(cam, fx, fy)
    ones = torch.ones((M,), dtype=torch.bool, device=dev)
    hit = trace_fn(o, d, ones)
    t = hit.t - EPS_HIT
    missed = t > MAX_FLOAT - 1.0
    x = Vec3(*(c.detach() for c in fma3(
        d, torch.where(missed, 0.0, t).detach(), o)))
    tri0 = torch.clamp(hit.tri.detach(), min=0)
    n_x, alb_x = shade_normal_fn(tri0)

    # ---- the edge point z (attached to verts) -----------------------------
    va = gather(scene.verts, take_clip(edges.ev0, eidx))
    vb = gather(scene.verts, take_clip(edges.ev1, eidx))
    z = fma3(vb - va, u, va)

    # the silhouette as seen from x (detached)
    fa = take_clip(edges.fa, eidx)
    fb = take_clip(edges.fb, eidx)
    na = gather(scene.tri_norm, fa)
    nb = gather(scene.tri_norm, torch.clamp(fb, min=0))
    w_ = z - x  # x -> z
    silhouette = ((fb < 0) | (dot(na, w_) * dot(nb, w_) < 0.0)).detach()

    # ---- project along x -> z onto the light plane (light fixed) ----------
    lt = take_clip(scene.lights, lidx)

    def fixed(v: Vec3) -> Vec3:
        return Vec3(*(c.detach() for c in v))

    lv0 = fixed(gather(scene.verts, take_clip(scene.tri_v0, lt)))
    lv1 = fixed(gather(scene.verts, take_clip(scene.tri_v1, lt)))
    lv2 = fixed(gather(scene.verts, take_clip(scene.tri_v2, lt)))
    n_l = fixed(gather(scene.tri_norm, lt))
    emi = fixed(gather(scene.mat_emission, take_clip(scene.tri_mat, lt)))

    nw = dot(n_l, w_)
    nw_safe = torch.where(torch.abs(nw) < 1e-12, 1e-12, nw)
    s = dot(n_l, lv0 - x) / nw_safe
    ystar = fma3(w_, s, x)

    # the in-triangle test of y* (detached barycentrics)
    def on_light(p):
        e1 = lv1 - lv0
        e2 = lv2 - lv0
        vp = p - lv0
        d11 = dot(e1, e1)
        d12 = dot(e1, e2)
        d22 = dot(e2, e2)
        dp1 = dot(vp, e1)
        dp2 = dot(vp, e2)
        den = fma(d11, d22, -(d12 * d12))
        den = torch.where(torch.abs(den) < 1e-20, 1e-20, den)
        bu = fma(d22, dp1, -(d12 * dp2)) / den
        bv = fma(d11, dp2, -(d12 * dp1)) / den
        return (bu >= 0) & (bv >= 0) & (bu + bv <= 1.0)

    inside = on_light(fixed(ystar))

    # ---- the curve's tangent and in-plane normal (detached) ---------------
    wu = vb - va  # dz/du
    ds_du = -s * dot(n_l, wu) / nw_safe
    ta = fixed(Vec3(*(fma(s, a, b * ds_du) for a, b in zip(wu, w_))))
    # in-plane normal = normalize(cross(n_l, t_A))
    nh = Vec3(fma(n_l.y, ta.z, -(n_l.z * ta.y)),
              fma(n_l.z, ta.x, -(n_l.x * ta.z)),
              fma(n_l.x, ta.y, -(n_l.y * ta.x)))
    nlen = sqrt(dot(nh, nh))
    speed = sqrt(dot(ta, ta))
    inv = torch.where(nlen > 1e-12, 1.0 / torch.clamp(nlen, min=1e-12), 0.0)
    nh = nh * inv

    # ---- the two-sided visibility probes (kernel.cu:405) ------------------
    ysd = fixed(ystar)

    def vis(side):
        yy = fma3(nh, side * offset_area, ysd)
        dv = yy - x
        ln = sqrt(dot(dv, dv))
        dirv = dv / torch.clamp(ln, min=1e-12)
        h = trace_fn(fma3(dirv, EPS_HIT, x), dirv, ones)
        return (torch.abs(h.t - ln) <= vis_eps).to(torch.float32), dirv, ln

    v_m, _, _ = vis(-1.0)
    v_p, dir_p, dlen = vis(+1.0)
    dv_vis = (v_m - v_p).detach()

    # ---- the NEE integrand f(y*) (detached; the integrator's semantics) ---
    cos_x = torch.clamp(dot(dir_p, n_x), min=0.0)
    if light_normal_mode == "fixed":
        cos_l = torch.clamp(dir_p.y, min=0.0)  # dot((0,-1,0), -dir)
    else:
        cos_l = torch.clamp(-dot(n_l, dir_p), min=0.0)
    d2 = torch.clamp(dlen * dlen, min=1e-12)
    f = Vec3(*((a * (1.0 / PI_REF) * cos_x * cos_l / d2 * e).detach()
               for a, e in zip(alb_x, emi)))

    # ---- the value-zero, gradient-carrying assembly -----------------------
    mterm = dot(nh, ystar)
    motion = mterm - mterm.detach()

    valid = (silhouette & inside & (s > 1.0 + 1e-6) & ~missed
             & (speed > 1e-12))
    w = torch.where(valid, float(E) * float(L) * speed * float(branch_factor)
                    * float(num_pixels) / M, 0.0).detach()
    j = torch.where(valid, pix, num_pixels)
    return _scatter(j, f.x * dv_vis * w * motion, f.y * dv_vis * w * motion,
                    f.z * dv_vis * w * motion, tile_offset, tile_pixels)
