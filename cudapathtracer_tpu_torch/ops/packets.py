"""Packet (ray-tile) traversal: the closest-hit engine of the render path.

Counterpart of ``cudapathtracer_tpu/ops/packets.py``:

1. optionally sort the rays by direction octant and origin Morton code so
   each tile of P consecutive rays is coherent (``ray_sort_keys``), over
   the whole batch or within windows of ``sort_window`` rays;
2. bound each tile's origins and directions and cull against that frustum
   (``tile_cull``) the scene's clusters (the flat cull), its superclusters
   of F preorder-consecutive clusters (the super shortlists) or, in the
   capped two-level cull, the superclusters and then the members of the
   nearest ``super_slots`` of them;
3. keep the M nearest candidates per tile, ascending by entry distance
   (``torch.topk``), and the smallest entry among dropped candidates, U;
4. fold each tile's shortlist densely with the kernel that ``route``
   picks: K1 (ops/kernels/dense_resident.py), K2 (dense.py) or K3
   (dense_super.py), each a CUDA kernel on CUDA tensors and its plain
   version on CPU tensors;
5. ``_finish``: rays whose best hit is not below U (``>=``: an equal-t hit
   with a lower id may sit in a dropped cluster) are traced again through
   the fine BVH. With straggler ``rounds``, every round but the last caps
   the shortlist and hands those rays on to the next round instead.

The hit equals the brute-force oracle's for any grouping of rays into tiles,
so sort order among equal keys, windows and rounds change nothing. A
caller's per-ray cap (``t_cap``) reports hits at or beyond it as misses,
and ``vis_band`` turns on the kernels' visibility instance (BDPT's
connection rays): the JAX package's capped and visibility-only queries
(packets.py:278-298). The triangle test is the caller's intersector,
Baldwin-Weber or Moller-Trumbore, in the kernels and in the fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import tracing
from ..utils.constants import MAX_FLOAT
from .kernels.dense import dense_intersect
from .kernels.dense_resident import (
    dense_intersect_resident,
    pack_clusters,
    resident_fits,
)
from .kernels.dense_super import dense_intersect_super
from .traversal import Hit, TraceData, apply_t_cap, trace, tri_blocks
from .vecmath import Vec3, stop_gradient

# the JAX package's auto cull stays flat up to this many clusters
# (packets.py:550-556) and picks a two-level cull past it
FLAT_CULL_MAX_CLUSTERS = 2048


class Route(NamedTuple):
    """The cull and the fold kernel of a trace. cull: "flat" (clusters),
    "super" (super shortlists of F clusters) or "two_level" (the capped
    two-level cull, in cluster units); kernel: "resident" (K1), "stream"
    (K2) or "super" (K3)."""

    cull: str
    kernel: str


def route(K: int, C: int, two_level: bool | str | None = None,
          F: int = 8) -> Route:
    """The cull and kernel for K clusters of C triangles, the JAX package's
    choice line for line (packets.py:526-557, :754-780): ``two_level``
    None is the auto cull (flat up to FLAT_CULL_MAX_CLUSTERS, then super
    shortlists where the resident layout allows them, else the capped
    two-level cull), False the flat one, True the capped two-level one
    (flat when K <= F), "super" super shortlists where the resident layout
    allows them (else auto). The two-level shortlist is in cluster units,
    so it folds with K1 when the scene is resident and K2 otherwise."""
    can_resident = C % 128 == 0 and resident_fits(K, C)
    can_super = can_resident and K > 2 * F
    if two_level == "super":
        if can_super:
            return Route("super", "super")
        two_level = None          # the JAX package falls back to auto
    if two_level is None:
        if K <= FLAT_CULL_MAX_CLUSTERS:
            two_level = False
        elif can_super:
            return Route("super", "super")
        else:
            two_level = True
    return Route("two_level" if two_level and K > F else "flat",
                 "resident" if can_resident else "stream")


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


def sort_rays(o: Vec3, d: Vec3, mask, pd: PacketData, window: int = 0):
    """Permutation that groups coherent rays into tiles (ray_sort_keys over
    the scene's bounds), within windows of ``window`` rays (``window_perm``;
    0 sorts the whole batch); the order among equal keys is immaterial."""
    key = ray_sort_keys(o, d, mask, *_scene_bounds(pd))
    return window_perm(key, window or key.shape[0])


def window_perm(key, W: int):
    """The permutation that sorts ``key`` (R,) within consecutive windows
    of W (the last one padded with the max key, which lands at its end):
    positions into the padded batch of ceil(R / W) W lanes, each window's
    own. W >= R is the global sort."""
    R = key.shape[0]
    if W >= R:
        return torch.sort(key).indices
    Rw = -(-R // W) * W
    if Rw != R:
        key = torch.cat([key, key.new_full((Rw - R,), 0x7FFFFFFF)])
    perm = torch.sort(key.reshape(Rw // W, W), dim=1).indices
    return (perm + torch.arange(0, Rw, W, device=key.device)[:, None]
            ).reshape(Rw)


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


def _nearest(entry, M: int):
    """The M smallest entries of each row, ascending, their columns, and
    the (M+1)-th entry U (the smallest dropped one; +inf when nothing can
    drop)."""
    N = entry.shape[1]
    if N > M:
        negv, idxs = torch.topk(-entry, M + 1, dim=1)
        return -negv[:, :M], idxs[:, :M], -negv[:, M]
    negv, idxs = torch.topk(-entry, M, dim=1)
    return -negv, idxs, torch.full((entry.shape[0],), torch.inf,
                                   device=entry.device)


def build_shortlists(o: Vec3, d: Vec3, mask, pd: PacketData,
                     tile_size: int, max_clusters: int,
                     super_factor: int | None = None,
                     super_list: int = 255, t_cap=None,
                     super_slots: int | None = None) -> Shortlists:
    """Tile the R rays in order (P per tile, padded), cull the clusters
    against each tile's frustum and keep the M nearest, ascending. With
    ``super_factor`` F, cull the superclusters of F clusters instead and
    keep M = min(S, super_list, max_clusters // F) of them, the sentinel S
    past each count (the JAX package's super shortlist,
    packets.py:558-596). With ``super_factor`` F and ``super_slots``, the
    capped two-level cull (packets.py:597-676): keep the Ms =
    min(super_slots, S) nearest superclusters, cull their members and keep
    the M = min(max_clusters, Ms F) nearest, in cluster units with the
    sentinel K; U is the smaller of the two levels' dropped entries (a
    super's box holds its members'). A caller's cap ``t_cap`` (R,)
    tightens each ray's search cap (row 7), padded with +inf
    (packets.py:736-741)."""
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

    def cull(lo, hi):
        """Entries (Tl, N) of boxes lo / hi ((1, N) or (Tl, N)); +inf for a
        box the tile misses and for a tile without a live lane."""
        hit, entry = tile_cull(olo, ohi, dlo, dhi, lo, hi)
        return torch.where(hit & any_lane, entry, torch.inf)

    # ---- cull, shortlist and dropped-candidate bound U --------------------
    if super_factor is None:
        entries, ids, U = _nearest(
            cull(Vec3(*(c[None, :] for c in pd.cl_lo)),
                 Vec3(*(c[None, :] for c in pd.cl_hi))),
            min(int(max_clusters), K))
        sentinel = K
    elif super_slots is None:
        F = int(super_factor)
        lo, hi = _super_boxes(pd, F)
        S = lo.x.shape[0]
        # a dropped super's entry lower-bounds its members' entries
        M = min(S, max(1, int(super_list)),
                max(1, int(max_clusters) // F) if max_clusters < 4095
                else S)
        entries, ids, U = _nearest(cull(Vec3(*(c[None, :] for c in lo)),
                                        Vec3(*(c[None, :] for c in hi))), M)
        sentinel = S
    else:
        # level 1: the superclusters, boxes merged on the fly
        F = int(super_factor)
        lo, hi = _super_boxes(pd, F)
        S = lo.x.shape[0]
        Ms = min(int(super_slots), S)
        ent_s, sup_ids, U_s = _nearest(
            cull(Vec3(*(c[None, :] for c in lo)),
                 Vec3(*(c[None, :] for c in hi))), Ms)
        # level 2: the kept supers' members, their boxes gathered as
        # (S, 6, F) row blocks; padded member slots carry inverted boxes
        rows = torch.stack([torch.cat([c, c.new_full((S * F - K,), fill)])
                            for c, fill in ((pd.cl_lo.x, torch.inf),
                                            (pd.cl_lo.y, torch.inf),
                                            (pd.cl_lo.z, torch.inf),
                                            (pd.cl_hi.x, -torch.inf),
                                            (pd.cl_hi.y, -torch.inf),
                                            (pd.cl_hi.z, -torch.inf))])
        cand = rows.reshape(6, S, F).transpose(0, 1)[sup_ids]  # Tl,Ms,6,F
        blk = [cand[:, :, i].reshape(Tl, Ms * F) for i in range(6)]
        cl_ids = (sup_ids[:, :, None] * F + torch.arange(
            F, device=dev)).reshape(Tl, Ms * F)
        entry = cull(Vec3(*blk[:3]), Vec3(*blk[3:]))
        valid = (cl_ids < K) & torch.repeat_interleave(ent_s < torch.inf,
                                                       F, dim=1)
        entries, idxs, U2 = _nearest(torch.where(valid, entry, torch.inf),
                                     min(int(max_clusters), Ms * F))
        U = torch.minimum(U_s, U2)
        ids = torch.gather(cl_ids, 1, idxs)
        sentinel = K
    entries = entries.contiguous()
    slot_ok = entries < torch.inf
    ids = torch.where(slot_ok, ids, sentinel).to(torch.int32).contiguous()
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
    if t_cap is not None:
        # the caller's cap: the fold never finds t >= its init, so hits at
        # or beyond the cap come back as misses
        cap_row = torch.minimum(cap_row,
                                padv(t_cap, torch.inf).reshape(Tl, P))
    rays = torch.stack([ox, oy, oz, dx, dy, dz, m.to(torch.float32),
                        cap_row], dim=1).contiguous()     # (Tl, 8, P)
    return Shortlists(ids, counts, entries, rays, U)


@torch.no_grad()
def trace_packets(o: Vec3, d: Vec3, pd: PacketData,
                  fine_td: TraceData | None = None, mask=None,
                  tile_size: int = 128, max_clusters: int = 32,
                  sort: bool = False, rounds: int = 1,
                  first_round_slots: int = 3, sort_window: int = 0,
                  two_level: bool | str | None = None,
                  super_factor: int = 8, super_slots: int = 16,
                  super_list: int = 255, resident_pack=None, t_cap=None,
                  vis_band: float = 0.0, intersector: str = "bw") -> Hit:
    """Closest hit for R rays through tile packets; the semantics of
    ``traversal.trace``: closest triangle with 0 < t, MAX_FLOAT/-1 on miss,
    exact-t ties to the lower id. ``fine_td`` enables the overflow
    fallback; without it, hits are exact only when no tile drops a
    candidate. ``two_level``, ``super_factor``, ``super_slots`` and
    ``super_list`` choose the cull and kernel as in the JAX package
    (``route``).
    ``resident_pack``: ``pack_clusters(pd, intersector)``, precomputed once
    per scene by the renderer; all three kernels read it, and raise if it is
    not ``intersector``'s layout. ``intersector``: the triangle test of the
    kernels and of the fallback walk, 'bw' (Baldwin-Weber) or 'mt'
    (Moller-Trumbore).

    ``rounds`` > 1 splits stragglers (packets.py:325-373): each round but
    the last caps every tile's shortlist at a budget of
    ``first_round_slots`` candidates (4x more each round, at most
    ``max_clusters``) and hands the rays that a dropped candidate could
    still beat to the next round, which sorts them again among themselves;
    the last round runs the full shortlist and the fallback.
    ``sort_window`` W sorts within windows of W rays instead of the whole
    batch where W > 0, W % tile_size == 0 and R > W (packets.py:418-488).

    ``t_cap``: an optional (R,) float32 per-ray cap; hits at or beyond it
    report as the miss (MAX_FLOAT, -1), hits below it are exact.
    ``vis_band`` > 0 (which needs ``t_cap``) marks a visibility-only query:
    a ray whose closest hit lies below ``t_cap - vis_band`` is occluded and
    reports t = -1.0 with an occluder's id (not necessarily the closest);
    every other ray reports the capped closest hit. BDPT's decision
    |t - len| <= eps is then the closest-hit query's for every ray
    (packets.py:286-298).

    The search is detached (packets.py:321-323): rays, caps and scene data
    are detached and nothing is recorded, so the kernels' wrappers never
    see a tensor that requires grad."""
    with tracing.span("packets.trace", rays=o.x.shape[0]):
        return _trace_packets(o, d, pd, fine_td, mask, tile_size,
                              max_clusters, sort, rounds, first_round_slots,
                              sort_window, two_level, super_factor,
                              super_slots, super_list, resident_pack, t_cap,
                              vis_band, intersector)


def _trace_packets(o, d, pd, fine_td, mask, tile_size, max_clusters, sort,
                   rounds, first_round_slots, sort_window, two_level,
                   super_factor, super_slots, super_list, resident_pack,
                   t_cap, vis_band, intersector):
    o, d, pd, fine_td, resident_pack, t_cap = stop_gradient(
        (o, d, pd, fine_td, resident_pack, t_cap))
    R = o.x.shape[0]
    dev = o.x.device
    if vis_band > 0.0 and t_cap is None:
        raise ValueError("vis_band derives the occlusion floor from the "
                         "per-ray cap: pass t_cap")
    if mask is None:
        mask = torch.ones(R, dtype=torch.bool, device=dev)
    if t_cap is not None:
        t_cap = torch.broadcast_to(torch.as_tensor(
            t_cap, dtype=torch.float32, device=dev), (R,))
    rt = route(pd.num_clusters, pd.cluster_size, two_level, super_factor)
    pack = (resident_pack if resident_pack is not None
            else pack_clusters(pd, intersector))
    tile = dict(pd=pd, rt=rt, tile_size=int(tile_size),
                super_factor=int(super_factor), super_slots=super_slots,
                super_list=super_list, pack=pack, vis_band=vis_band,
                intersector=intersector)
    W = int(sort_window)
    window = W if sort and W > 0 and W % int(tile_size) == 0 and R > W \
        else (R if sort else 0)

    def one_round(m, budget, fb_td, need_out):
        return _sorted_round(o, d, m, t_cap, window, budget, fb_td,
                             need_out, tile)

    if rounds <= 1:
        return one_round(mask, max_clusters, fine_td, False)
    acc_t = torch.full((R,), MAX_FLOAT, device=dev)
    acc_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    budget = int(first_round_slots)
    for _ in range(rounds - 1):
        hit, need = one_round(mask, min(budget, int(max_clusters)), None,
                              True)
        done = mask & ~need
        acc_t = torch.where(done, hit.t, acc_t)
        acc_tri = torch.where(done, hit.tri, acc_tri)
        mask = need
        budget *= 4
    hit = one_round(mask, max_clusters, fine_td, False)
    return Hit(tri=torch.where(mask, hit.tri, acc_tri),
               t=torch.where(mask, hit.t, acc_t))


def _sorted_round(o, d, mask, t_cap, window, max_clusters, fine_td,
                  need_out, tile):
    """One round of ``trace_packets`` over the rays of ``mask``: sorted
    within windows of ``window`` rays (0: unsorted), traced, and put back
    in ray order. -> Hit, and with ``need_out`` the rays a dropped
    candidate could still beat."""
    if not window:
        return _trace_tiles(o, d, mask, t_cap, max_clusters, fine_td,
                            need_out, **tile)
    R = o.x.shape[0]
    with tracing.span("packets.sort"):
        perm = sort_rays(o, d, mask, tile["pd"], window)
        Rw = perm.shape[0]

        def take(a, fill):
            # pad lanes: masked, unit direction, never past R after the sort
            if Rw != R:
                a = torch.cat([a, a.new_full((Rw - R,), fill)])
            return a[perm]

        sorted_rays = (Vec3(*(take(c, 0.0) for c in o)),
                       Vec3(*(take(c, 1.0) for c in d)), take(mask, False),
                       None if t_cap is None else take(t_cap, 0.0))
    out = _trace_tiles(*sorted_rays, max_clusters, fine_td, need_out, **tile)

    def unsort(a):
        b = torch.empty_like(a)
        b[perm] = a
        return b[:R]

    h, need = out if need_out else (out, None)
    hit = Hit(tri=unsort(h.tri), t=unsort(h.t))
    return (hit, unsort(need)) if need_out else hit


def _trace_tiles(o, d, mask, t_cap, max_clusters, fine_td, need_out, pd,
                 rt, tile_size, super_factor, super_slots, super_list, pack,
                 vis_band, intersector):
    """Shortlists of the rays in their order, the kernel ``rt`` names and
    ``_finish``."""
    with tracing.span("packets.cull"):
        sl = build_shortlists(
            o, d, mask, pd, tile_size, max_clusters,
            super_factor=None if rt.cull == "flat" else super_factor,
            super_list=super_list, t_cap=t_cap,
            super_slots=super_slots if rt.cull == "two_level" else None)
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    kw = dict(vis_band=vis_band, intersector=intersector)
    if rt.kernel == "super":
        t_best, tri_best = dense_intersect_super(*args, super_factor, **kw)
    elif rt.kernel == "stream":
        t_best, tri_best = dense_intersect(*args, **kw)
    else:
        t_best, tri_best = dense_intersect_resident(*args, **kw)
    return _finish(o, d, t_best, tri_best, mask, sl.U, fine_td,
                   o.x.shape[0], t_cap, vis_band > 0.0, intersector,
                   need_out)


def _finish(o, d, t_best, tri_best, mask, U, fine_td, R, t_cap=None,
            vis=False, intersector="bw", need_out=False):
    """Trim padding, apply the lane mask, the fallback (a walk of the fine
    BVH with the caller's intersector) and the caller's cap, in the JAX
    package's order (packets.py:839-885). ``need_out``: skip the fallback
    and return the capped hit and the rays a dropped candidate could still
    beat (the straggler rounds re-trace those)."""
    Tl, P = t_best.shape
    t_flat = t_best.reshape(-1)[:R]
    tri_flat = tri_best.reshape(-1)[:R]
    t_flat = torch.where(mask, t_flat, MAX_FLOAT)
    tri_flat = torch.where(mask, tri_flat, -1)
    # rays whose fold never beat the search-cap init carry t == cap with
    # tri == -1: restore the canonical miss sentinel
    t_flat = torch.where(tri_flat < 0, MAX_FLOAT, t_flat)
    if vis:
        # rays the kernel retired as occluded carry -3e38: report t = -1.0
        # (|-1 - len| > eps for any len >= 0). Before the fallback test: a
        # retired ray's decision is final, it never needs the fallback
        t_flat = torch.where(mask & (t_flat < -1.0e38), -1.0, t_flat)
    u_ray = torch.broadcast_to(U[:, None], (Tl, P)).reshape(-1)[:R]
    # >= (not >): a hit whose t EQUALS a dropped cluster's entry may tie a
    # lower-id triangle in that cluster. With a cap, min(t, cap): a dropped
    # cluster at or beyond the cap holds only hits reported as misses
    t_eff = t_flat if t_cap is None else torch.minimum(t_flat, t_cap)
    need_fb = mask & (t_eff >= u_ray)
    if not need_out and fine_td is not None and _any_fallback(need_fb, mask):
        fb = trace(o, d, fine_td, mask=need_fb, intersector=intersector)
        t_flat = torch.where(need_fb, fb.t, t_flat)
        tri_flat = torch.where(need_fb, fb.tri, tri_flat)
    hit = Hit(tri=tri_flat, t=t_flat)
    if t_cap is not None:
        # after the fallback, whose hits are uncapped
        hit = apply_t_cap(hit, t_cap)
    return (hit, need_fb) if need_out else hit


def _any_fallback(need_fb, mask) -> bool:
    """``need_fb.any()`` on the host: the call's one synchronize. With
    tracing on, the round's masked-in rays ride the same read and count as
    ``packets.live_rays``."""
    if not tracing.enabled():
        return bool(need_fb.any())
    live, fallback = torch.stack([mask, need_fb]).sum(1).tolist()
    tracing.count("packets.live_rays", live)
    return fallback > 0
