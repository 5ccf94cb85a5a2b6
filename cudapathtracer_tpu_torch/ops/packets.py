"""Packet (ray-tile) traversal: the closest-hit engine of the render path.

Counterpart of ``cudapathtracer_tpu/ops/packets.py`` on its flat-cull,
one-round path:

1. optionally sort the rays by direction octant and origin Morton code so
   each tile of P consecutive rays is coherent (``ray_sort_keys``);
2. bound each tile's origins and directions and cull the scene's clusters
   (or, on the super route, its superclusters of F preorder-consecutive
   clusters) against that frustum (``tile_cull``);
3. keep the M nearest candidates per tile, ascending by entry distance
   (``torch.topk``), and the smallest entry among dropped candidates, U;
4. fold each tile's shortlist densely with the kernel that ``route``
   picks: K1 (ops/kernels/dense_resident.py), K2 (dense.py) or K3
   (dense_super.py), each a CUDA kernel on CUDA tensors and its plain
   version on CPU tensors;
5. ``_finish``: rays whose best hit is not below U (``>=``: an equal-t hit
   with a lower id may sit in a dropped cluster) are traced again through
   the fine BVH.

The hit equals the brute-force oracle's for any grouping of rays into tiles,
so sort order among equal keys changes nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.constants import MAX_FLOAT
from .kernels.dense import dense_intersect
from .kernels.dense_resident import (
    dense_intersect_resident,
    pack_clusters,
    resident_fits,
)
from .kernels.dense_super import dense_intersect_super
from .traversal import Hit, TraceData, trace, tri_blocks
from .vecmath import Vec3

# the JAX package's auto cull stays flat up to this many clusters
# (packets.py:550-556) and picks a two-level cull past it
FLAT_CULL_MAX_CLUSTERS = 2048


def route(K: int, C: int, two_level: bool | str | None = None,
          F: int = 8) -> str:
    """The fold kernel for K clusters of C triangles: "resident" (K1),
    "stream" (K2) or "super" (K3, super shortlists of F clusters). The JAX
    package's choice, line for line (packets.py:526-557, :754-780):
    ``two_level`` None is the auto cull, False the flat one, "super" asks
    for super shortlists where the resident layout allows them. Raises
    NotImplementedError where the JAX package would take its capped
    two-level cull, which is not ported."""
    can_resident = C % 128 == 0 and resident_fits(K, C)
    can_super = can_resident and K > 2 * F
    if two_level == "super":
        if can_super:
            return "super"
        two_level = None          # the JAX package falls back to auto
    if two_level is None:
        if K <= FLAT_CULL_MAX_CLUSTERS:
            two_level = False
        elif can_super:
            return "super"
        else:
            two_level = True
    if two_level and K > F:
        raise NotImplementedError(
            f"two_level_cull: K={K} clusters of C={C} take the JAX package's "
            "capped two-level cull (two_level=True), which is not ported")
    return "resident" if can_resident else "stream"


class PacketData(NamedTuple):
    """Cluster-level scene layout.

    cl_lo / cl_hi: (K,) cluster AABBs (SoA).
    v0 / e1 / e2:  (K+1, C) triangle blocks; row K is an all-degenerate
                   sentinel, so shortlist padding never hits.
    tri:           (K+1, C) i32 scene triangle ids; pad slots hold T.
    """

    cl_lo: Vec3
    cl_hi: Vec3
    v0: Vec3
    e1: Vec3
    e2: Vec3
    tri: torch.Tensor
    num_tris: int

    @property
    def num_clusters(self):
        return self.cl_lo.x.shape[0]

    @property
    def cluster_size(self):
        return self.tri.shape[1]


def make_packet_data(scene, cl_lo: Vec3, cl_hi: Vec3, cl_tri) -> PacketData:
    """Pack the cluster triangle blocks from the scene's vertices
    (``cl_tri``: (K, C) ids padded with T)."""
    T = scene.num_tris
    C = cl_tri.shape[1]
    tri = torch.cat([cl_tri.to(torch.int32),
                     torch.full((1, C), T, dtype=torch.int32,
                                device=cl_tri.device)])
    v0, e1, e2 = tri_blocks(scene, tri)
    return PacketData(cl_lo=cl_lo, cl_hi=cl_hi, v0=v0, e1=e1, e2=e2,
                      tri=tri, num_tris=T)


def _axis_interval(ol, oh, dl, dh, bl, bh):
    """Conservative per-axis [tmin, tmax] hull over the tile's origin
    interval [ol, oh] and direction interval [dl, dh] against slab [bl, bh];
    a mixed-sign direction interval gets (-inf, +inf)."""
    mixed = (dl <= 0.0) & (dh >= 0.0)
    tiny = 1e-30
    dls = torch.where(torch.abs(dl) < tiny,
                      torch.where(dl < 0, -tiny, tiny), dl)
    dhs = torch.where(torch.abs(dh) < tiny,
                      torch.where(dh < 0, -tiny, tiny), dh)
    n0 = bl - ol
    n1 = bl - oh
    n2 = bh - ol
    n3 = bh - oh
    qs = [n / s for n in (n0, n1, n2, n3) for s in (dls, dhs)]
    tmin = qs[0]
    tmax = qs[0]
    for q in qs[1:]:
        tmin = torch.minimum(tmin, q)
        tmax = torch.maximum(tmax, q)
    tmin = torch.where(mixed, -torch.inf, tmin)
    tmax = torch.where(mixed, torch.inf, tmax)
    return tmin, tmax


def tile_cull(olo: Vec3, ohi: Vec3, dlo: Vec3, dhi: Vec3,
              cl_lo: Vec3, cl_hi: Vec3):
    """Frustum-vs-AABB candidates: tile bounds (Tl, 1), clusters (1, K) ->
    (hit (Tl, K) bool, entry (Tl, K) f32 >= 0)."""
    tx0, tx1 = _axis_interval(olo.x, ohi.x, dlo.x, dhi.x, cl_lo.x, cl_hi.x)
    ty0, ty1 = _axis_interval(olo.y, ohi.y, dlo.y, dhi.y, cl_lo.y, cl_hi.y)
    tz0, tz1 = _axis_interval(olo.z, ohi.z, dlo.z, dhi.z, cl_lo.z, cl_hi.z)
    tmin = torch.maximum(torch.maximum(tx0, ty0), tz0)
    tmax = torch.minimum(torch.minimum(tx1, ty1), tz1)
    hit = (tmin <= tmax) & (tmax >= 0.0)
    entry = torch.clamp(tmin, min=0.0)
    return hit, entry


def _part1by2(x):
    """Spread the low 7 bits of x so consecutive bits are 3 apart."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_sort_keys(o: Vec3, d: Vec3, mask, lo: Vec3, hi: Vec3):
    """Coherence keys: direction octant, then the dominant axis, then the
    21-bit Morton code of the origin in the scene bounds. Masked lanes get
    the max key, so they gather into all-masked tiles at the end."""
    oct_ = ((d.x < 0).to(torch.int32) * 4 + (d.y < 0).to(torch.int32) * 2
            + (d.z < 0).to(torch.int32))
    ax, ay, az = torch.abs(d.x), torch.abs(d.y), torch.abs(d.z)
    major = torch.where((ax >= ay) & (ax >= az), 0,
                        torch.where(ay >= az, 1, 2)).to(torch.int32)

    def q(v, lo_, hi_):
        ext = torch.clamp(hi_ - lo_, min=1e-20)
        return torch.clamp((v - lo_) / ext * 127.0, 0.0, 127.0).to(
            torch.int32)

    morton = ((_part1by2(q(o.x, lo.x, hi.x)) << 2)
              | (_part1by2(q(o.y, lo.y, hi.y)) << 1)
              | _part1by2(q(o.z, lo.z, hi.z)))
    key = (oct_ << 23) | (major << 21) | morton
    return torch.where(mask, key, 0x7FFFFFFF)


def _scene_bounds(pd: PacketData):
    """The scene's box: the hull of the cluster boxes."""
    return (Vec3(pd.cl_lo.x.min(), pd.cl_lo.y.min(), pd.cl_lo.z.min()),
            Vec3(pd.cl_hi.x.max(), pd.cl_hi.y.max(), pd.cl_hi.z.max()))


def sort_rays(o: Vec3, d: Vec3, mask, pd: PacketData):
    """Permutation that groups coherent rays into tiles (ray_sort_keys over
    the scene's bounds); the order among equal keys is immaterial."""
    return torch.sort(ray_sort_keys(o, d, mask, *_scene_bounds(pd))).indices


class Shortlists(NamedTuple):
    """Per-tile kernel inputs (ops/kernels/dense_resident.py; in super
    units on the super route) and the dropped-candidate bound U (Tl,)."""

    ids: torch.Tensor
    counts: torch.Tensor
    entries: torch.Tensor
    rays: torch.Tensor
    U: torch.Tensor


def _super_boxes(pd: PacketData, F: int):
    """Boxes of the S = ceil(K / F) superclusters: min / max over F
    preorder-consecutive cluster boxes, the last super padded with
    inverted (+inf, -inf) boxes."""
    K = pd.num_clusters
    S = -(-K // F)

    def merge(c, fill, red):
        c = torch.cat([c, c.new_full((S * F - K,), fill)])
        return red(c.reshape(S, F), dim=1)

    return (Vec3(*(merge(c, torch.inf, torch.amin) for c in pd.cl_lo)),
            Vec3(*(merge(c, -torch.inf, torch.amax) for c in pd.cl_hi)))


def build_shortlists(o: Vec3, d: Vec3, mask, pd: PacketData,
                     tile_size: int, max_clusters: int,
                     super_factor: int | None = None,
                     super_list: int = 255) -> Shortlists:
    """Tile the R rays in order (P per tile, padded), cull the clusters
    against each tile's frustum and keep the M nearest, ascending. With
    ``super_factor`` F, cull the superclusters of F clusters instead and
    keep M = min(S, super_list, max_clusters // F) of them, the sentinel S
    past each count (the JAX package's super shortlist,
    packets.py:558-596)."""
    R = o.x.shape[0]
    dev = o.x.device
    K = pd.num_clusters
    P = int(tile_size)
    Rp = -(-R // P) * P
    Tl = Rp // P

    def padv(a, fill):
        if Rp == R:
            return a
        return torch.cat([a, torch.full((Rp - R,), fill, dtype=a.dtype,
                                        device=dev)])

    ox = padv(o.x, 0.0).reshape(Tl, P)
    oy = padv(o.y, 0.0).reshape(Tl, P)
    oz = padv(o.z, 0.0).reshape(Tl, P)
    dx = padv(d.x, 1.0).reshape(Tl, P)
    dy = padv(d.y, 1.0).reshape(Tl, P)
    dz = padv(d.z, 1.0).reshape(Tl, P)
    m = padv(mask, False).reshape(Tl, P)

    # ---- tile bounds (masked lanes excluded) ------------------------------
    arr = torch.stack([ox, oy, oz, dx, dy, dz], dim=1)  # (Tl, 6, P)
    m3 = m[:, None, :]
    mins = torch.amin(torch.where(m3, arr, torch.inf), dim=2, keepdim=True)
    maxs = torch.amax(torch.where(m3, arr, -torch.inf), dim=2, keepdim=True)
    olo = Vec3(mins[:, 0], mins[:, 1], mins[:, 2])
    ohi = Vec3(maxs[:, 0], maxs[:, 1], maxs[:, 2])
    dlo = Vec3(mins[:, 3], mins[:, 4], mins[:, 5])
    dhi = Vec3(maxs[:, 3], maxs[:, 4], maxs[:, 5])
    any_lane = torch.any(m, dim=1, keepdim=True)

    # ---- cull, shortlist and dropped-candidate bound U --------------------
    if super_factor is None:
        N, lo, hi = K, pd.cl_lo, pd.cl_hi
        M = min(int(max_clusters), K)
    else:
        F = int(super_factor)
        lo, hi = _super_boxes(pd, F)
        N = lo.x.shape[0]
        # a dropped super's entry lower-bounds its members' entries
        M = min(N, max(1, int(super_list)),
                max(1, int(max_clusters) // F) if max_clusters < 4095
                else N)
    hit, entry = tile_cull(olo, ohi, dlo, dhi,
                           Vec3(*(c[None, :] for c in lo)),
                           Vec3(*(c[None, :] for c in hi)))
    entry = torch.where(hit & any_lane, entry, torch.inf)
    if N > M:
        negv, idxs = torch.topk(-entry, M + 1, dim=1)
        U = -negv[:, M]
        negv = negv[:, :M]
        idxs = idxs[:, :M]
    else:
        negv, idxs = torch.topk(-entry, M, dim=1)
        U = torch.full((Tl,), torch.inf, device=dev)
    entries = (-negv).contiguous()
    slot_ok = entries < torch.inf
    ids = torch.where(slot_ok, idxs, N).to(torch.int32).contiguous()
    counts = slot_ok.sum(dim=1).to(torch.int32)

    # ---- per-ray search cap: scene-box exit distance (+ margin) -----------
    # The fold starts from it, so a ray that misses everything stops holding
    # its tile's early exit open; every real hit lies inside the scene box.
    def axis_exit(o_, d_, l_, h_):
        ds = torch.where(torch.abs(d_) < 1e-30,
                         torch.where(d_ < 0, -1e-30, 1e-30), d_)
        return torch.maximum((l_ - o_) / ds, (h_ - o_) / ds)

    slo, shi = _scene_bounds(pd)
    cap_row = torch.clamp(torch.minimum(
        torch.minimum(axis_exit(ox, dx, slo.x, shi.x),
                      axis_exit(oy, dy, slo.y, shi.y)),
        axis_exit(oz, dz, slo.z, shi.z)), min=0.0) * 1.0001 + 1e-4
    rays = torch.stack([ox, oy, oz, dx, dy, dz, m.to(torch.float32),
                        cap_row], dim=1).contiguous()     # (Tl, 8, P)
    return Shortlists(ids, counts, entries, rays, U)


def trace_packets(o: Vec3, d: Vec3, pd: PacketData,
                  fine_td: TraceData | None = None, mask=None,
                  tile_size: int = 128, max_clusters: int = 32,
                  sort: bool = False, two_level: bool | str | None = None,
                  super_factor: int = 8, super_list: int = 255,
                  resident_pack=None) -> Hit:
    """Closest hit for R rays through tile packets; the semantics of
    ``traversal.trace``: closest triangle with 0 < t, MAX_FLOAT/-1 on miss,
    exact-t ties to the lower id. ``fine_td`` enables the overflow
    fallback; without it, hits are exact only when no tile drops a
    candidate. ``two_level``, ``super_factor`` and ``super_list`` choose
    the cull and kernel as in the JAX package (``route``).
    ``resident_pack``: ``pack_clusters(pd)``, precomputed once per scene by
    the renderer; all three kernels read it."""
    R = o.x.shape[0]
    dev = o.x.device
    if mask is None:
        mask = torch.ones(R, dtype=torch.bool, device=dev)
    F = int(super_factor)
    kernel = route(pd.num_clusters, pd.cluster_size, two_level, F)

    if sort:
        perm = sort_rays(o, d, mask, pd)
        h = trace_packets(
            Vec3(o.x[perm], o.y[perm], o.z[perm]),
            Vec3(d.x[perm], d.y[perm], d.z[perm]), pd, fine_td=fine_td,
            mask=mask[perm], tile_size=tile_size, max_clusters=max_clusters,
            sort=False, two_level=two_level, super_factor=F,
            super_list=super_list, resident_pack=resident_pack)
        t = torch.empty_like(h.t)
        tri = torch.empty_like(h.tri)
        t[perm] = h.t
        tri[perm] = h.tri
        return Hit(tri=tri, t=t)

    sl = build_shortlists(o, d, mask, pd, tile_size, max_clusters,
                          super_factor=F if kernel == "super" else None,
                          super_list=super_list)
    pack = resident_pack if resident_pack is not None else pack_clusters(pd)
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    if kernel == "super":
        t_best, tri_best = dense_intersect_super(*args, F)
    elif kernel == "stream":
        t_best, tri_best = dense_intersect(*args)
    else:
        t_best, tri_best = dense_intersect_resident(*args)
    return _finish(o, d, t_best, tri_best, mask, sl.U, fine_td, R)


def _finish(o, d, t_best, tri_best, mask, U, fine_td, R):
    """Trim padding, apply the lane mask and the fallback."""
    Tl, P = t_best.shape
    t_flat = t_best.reshape(-1)[:R]
    tri_flat = tri_best.reshape(-1)[:R]
    t_flat = torch.where(mask, t_flat, MAX_FLOAT)
    tri_flat = torch.where(mask, tri_flat, -1)
    # rays whose fold never beat the search-cap init carry t == cap with
    # tri == -1: restore the canonical miss sentinel
    t_flat = torch.where(tri_flat < 0, MAX_FLOAT, t_flat)
    u_ray = torch.broadcast_to(U[:, None], (Tl, P)).reshape(-1)[:R]
    # >= (not >): a hit whose t EQUALS a dropped cluster's entry may tie a
    # lower-id triangle in that cluster
    need_fb = mask & (t_flat >= u_ray)
    if fine_td is not None and bool(need_fb.any()):
        fb = trace(o, d, fine_td, mask=need_fb)
        t_flat = torch.where(need_fb, fb.t, t_flat)
        tri_flat = torch.where(need_fb, fb.tri, tri_flat)
    return Hit(tri=tri_flat, t=t_flat)
