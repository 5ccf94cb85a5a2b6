"""Stackless per-ray BVH traversal, the brute-force oracle and hit helpers.

Counterpart of ``cudapathtracer_tpu/ops/traversal.py``. ``trace`` walks the
threaded (skip-link) flat BVH of accel/bvh.py with one int cursor per ray:
an interior node hit goes to i+1, a miss or a finished leaf to its skip. The
JAX package runs it as an XLA ``while_loop`` over all lanes; here it is a
Python loop over the lanes the mask selects, gathered into a compact batch,
that ends when no lane's cursor is live. Results are per ray, so running the
selected lanes alone changes nothing.

Hits keep the closest triangle with ``0 < t`` (kernel.cu:127); exact-t ties
go to the lower triangle id, so every engine gives the same hit. Hits are
plain tensors and carry no autograd history (ops/packets.py:321-323).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.constants import MAX_FLOAT
from .intersect import (
    bw_precompute,
    ray_aabb,
    ray_sphere,
    ray_triangle_bw,
)
from .vecmath import Vec3, gather, take_clip

_TRI_SENTINEL = 0x7FFFFFFF


class Hit(NamedTuple):
    tri: torch.Tensor  # (R,) i32, -1 = miss
    t: torch.Tensor    # (R,) f32, MAX_FLOAT = miss (reference sentinel)


class TraceData(NamedTuple):
    """Flat BVH plus leaf triangle blocks, (NL, L) per component. Padding
    slots hold an all-zero triangle that never hits."""

    node_lo: Vec3
    node_hi: Vec3
    node_skip: torch.Tensor  # (N,) i32
    node_leaf: torch.Tensor  # (N,) i32, -1 = interior
    leaf_v0: Vec3
    leaf_e1: Vec3
    leaf_e2: Vec3
    leaf_tri: torch.Tensor   # (NL, L) i32, pad = num_tris
    num_tris: int

    @property
    def num_nodes(self):
        return self.node_skip.shape[0]


def tri_blocks(scene, ids):
    """(v0, e1, e2) of the triangles at ``ids``. The sentinel id T (the
    padding) gathers vertex 0 for all three corners and is then zeroed, so
    it never hits."""
    T = scene.num_tris
    pad = torch.zeros(1, dtype=scene.tri_v0.dtype, device=ids.device)
    v0, v1, v2 = (gather(scene.verts, take_clip(torch.cat([c, pad]), ids))
                  for c in (scene.tri_v0, scene.tri_v1, scene.tri_v2))
    z = torch.where(ids >= T, 0.0, 1.0)
    v0 = v0 * z
    v1 = v1 * z
    v2 = v2 * z
    return v0, v1 - v0, v2 - v0


def make_trace_data(scene, bvh) -> TraceData:
    """Pack (scene, FlatBVH) into TraceData."""
    v0, e1, e2 = tri_blocks(scene, bvh.leaf_tri)
    return TraceData(
        node_lo=Vec3(bvh.node_lo_x, bvh.node_lo_y, bvh.node_lo_z),
        node_hi=Vec3(bvh.node_hi_x, bvh.node_hi_y, bvh.node_hi_z),
        node_skip=bvh.node_skip,
        node_leaf=bvh.node_leaf,
        leaf_v0=v0,
        leaf_e1=e1,
        leaf_e2=e2,
        leaf_tri=bvh.leaf_tri,
        num_tris=scene.num_tris,
    )


def _closest_update(ts, tri_ids, t_best, tri_best):
    """Fold an (R, L) candidate block into the running closest hit; exact-t
    ties go to the LOWER triangle id. Candidates must already be MAX_FLOAT
    where invalid."""
    t_new = torch.amin(ts, dim=1)
    is_min = ts == t_new[:, None]
    tri_new = torch.amin(
        torch.where(is_min & (ts < MAX_FLOAT), tri_ids, _TRI_SENTINEL),
        dim=1).to(torch.int32)
    better = (t_new < t_best) | (
        (t_new == t_best) & (tri_new < tri_best)
        & (tri_new < _TRI_SENTINEL) & (tri_best >= 0)
    )
    return torch.where(better, t_new, t_best), \
        torch.where(better, tri_new, tri_best)


def _rows(v: Vec3, i) -> Vec3:
    return Vec3(v.x[i], v.y[i], v.z[i])


def _col(v: Vec3) -> Vec3:
    return Vec3(v.x[:, None], v.y[:, None], v.z[:, None])


def trace(o: Vec3, d: Vec3, td: TraceData, mask=None) -> Hit:
    """Closest hit of R rays by the skip-link walk (Baldwin-Weber test);
    lanes with mask False report a miss and cost nothing."""
    R = o.x.shape[0]
    dev = o.x.device
    t_out = torch.full((R,), MAX_FLOAT, dtype=torch.float32, device=dev)
    tri_out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    sel = (torch.arange(R, device=dev) if mask is None
           else torch.nonzero(mask).flatten())
    if sel.numel() == 0:
        return Hit(tri=tri_out, t=t_out)
    o = _rows(o, sel)
    d = _rows(d, sel)
    N = td.num_nodes
    inv_d = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    o_b, d_b = _col(o), _col(d)
    attrs = bw_precompute(td.leaf_e1, td.leaf_e2)

    n = sel.numel()
    cursor = torch.zeros(n, dtype=torch.int64, device=dev)
    t_best = torch.full((n,), MAX_FLOAT, dtype=torch.float32, device=dev)
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    while bool((cursor < N).any()):
        active = cursor < N
        curc = torch.clamp(cursor, max=N - 1)
        box_hit = ray_aabb(o, inv_d, gather(td.node_lo, curc),
                           gather(td.node_hi, curc), t_best=t_best) & active
        leaf = td.node_leaf[curc]
        is_leaf = leaf >= 0
        do_leaf = is_leaf & box_hit
        lid = torch.clamp(leaf, min=0).long()
        tri_ids = td.leaf_tri[lid]
        ts = ray_triangle_bw(o_b, d_b, _rows(td.leaf_v0, lid),
                             *(_rows(a, lid) for a in attrs))
        valid = (do_leaf[:, None] & (tri_ids < td.num_tris) & (ts > 0.0)
                 & (ts <= t_best[:, None]))
        ts = torch.where(valid, ts, MAX_FLOAT)
        t_best, tri_best = _closest_update(ts, tri_ids, t_best, tri_best)
        skip = td.node_skip[curc].long()
        nxt = torch.where(is_leaf | ~box_hit, skip, curc + 1)
        cursor = torch.where(active, nxt, cursor)
    t_out[sel] = t_best
    tri_out[sel] = tri_best
    return Hit(tri=tri_out, t=t_out)


def trace_bruteforce(o: Vec3, d: Vec3, scene, mask=None,
                     chunk: int = 512) -> Hit:
    """All-pairs closest hit (Baldwin-Weber test), every ray against every
    triangle in chunks of ``chunk`` triangles: the oracle the other engines
    are held to."""
    T = scene.num_tris
    dev = o.x.device
    v0 = gather(scene.verts, scene.tri_v0)
    v1 = gather(scene.verts, scene.tri_v1)
    v2 = gather(scene.verts, scene.tri_v2)
    attrs = bw_precompute(v1 - v0, v2 - v0)
    o_b, d_b = _col(o), _col(d)
    R = o.x.shape[0]
    t_best = torch.full((R,), MAX_FLOAT, dtype=torch.float32, device=dev)
    tri_best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, T, chunk):
        sl = slice(c0, min(T, c0 + chunk))

        def b(v):
            return Vec3(v.x[None, sl], v.y[None, sl], v.z[None, sl])

        ts = ray_triangle_bw(o_b, d_b, b(v0), *(b(a) for a in attrs))
        ids = torch.arange(sl.start, sl.stop, dtype=torch.int32,
                           device=dev)[None, :].expand(R, -1)
        valid = (ts > 0.0) & (ts <= t_best[:, None])
        ts = torch.where(valid, ts, MAX_FLOAT)
        t_best, tri_best = _closest_update(ts, ids, t_best, tri_best)
    if mask is not None:
        t_best = torch.where(mask, t_best, MAX_FLOAT)
        tri_best = torch.where(mask, tri_best, -1)
    return Hit(tri=tri_best, t=t_best)


def apply_t_cap(hit: Hit, t_cap) -> Hit:
    """Hits with t >= cap report as the canonical miss (MAX_FLOAT, -1)."""
    beyond = hit.t >= t_cap
    return Hit(tri=torch.where(beyond, -1, hit.tri),
               t=torch.where(beyond, MAX_FLOAT, hit.t))


def trace_spheres(o: Vec3, d: Vec3, scene, t_best, id_best,
                  mask=None) -> Hit:
    """Fold the analytic spheres into a hit: sphere s reports id T + s and
    wins only on a strictly smaller t."""
    S = scene.num_spheres
    if S == 0:
        return Hit(tri=id_best, t=t_best)
    c = Vec3(scene.sph_center.x[None, :], scene.sph_center.y[None, :],
             scene.sph_center.z[None, :])
    ts = ray_sphere(_col(o), _col(d), c, scene.sph_radius[None, :])
    t_new, j = torch.min(ts, dim=1)
    upd = t_new < t_best
    if mask is not None:
        upd = upd & mask
    return Hit(tri=torch.where(upd, (scene.num_tris + j).to(torch.int32),
                               id_best),
               t=torch.where(upd, t_new, t_best))
