"""Plain scene tables and brute-force closest hits.

The reference renderer's semantics (CulDeVu/CUDAPathTracer: modelLoader.h,
limits.h) in plain torch, independent of the program under test: per
triangle its vertices, face normal from the winding, albedo and emission;
the emissive triangles (emission.r != 0) with their areas; and the closest
hit of each ray over every triangle (Moller-Trumbore with the reference's
epsilon, 0 < t, ties to the lower id, MAX_FLOAT on a miss). No acceleration
structure: nothing the program derives (BVH, clusters, packs) is used.

Every float is of the ``dtype`` the tables are made in, so the same code is
the float32 reference and its lower-precision control.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_FLOAT = 100000.0   # the reference's miss sentinel (limits.h:3)
EPS_PARALLEL = 1e-5    # modelLoader.h:64


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    return a / length(a)[..., None]


def normalize_safe(a):
    n2 = dot(a, a)
    ok = n2 > 1e-20
    return a * torch.where(ok, torch.rsqrt(torch.where(ok, n2, 1.0)),
                           0.0)[..., None]


class Geometry(NamedTuple):
    v0: torch.Tensor        # (T, 3)
    e1: torch.Tensor        # (T, 3) v1 - v0
    e2: torch.Tensor        # (T, 3) v2 - v0
    normal: torch.Tensor    # (T, 3)
    albedo: torch.Tensor    # (T, 3)
    emission: torch.Tensor  # (T, 3)
    light_rows: torch.Tensor  # (L + 1,) triangle ids, the last triangle 0
    light_area: torch.Tensor  # (L,)
    total_area: torch.Tensor  # ()


def make_geometry(verts, tris, tri_mats, albedo, emission) -> Geometry:
    """Tables from (V, 3) vertices, (T, 3) vertex ids, (T,) material ids
    and (M, 3) albedo and emission, all tensors on one device; the floats
    keep their dtype, and their gradients where they carry any."""
    tris = tris.long()
    tri_mats = tri_mats.long()
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    n = cross(e1, e2)
    nl = length(n)
    n = n / torch.where(nl == 0, torch.ones_like(nl), nl)[:, None]
    emi = emission[tri_mats]
    lights = torch.nonzero(emission.detach()[tri_mats, 0] != 0).flatten()
    area = 0.5 * length(cross(e1[lights], e2[lights]))
    rows = torch.cat([lights, lights.new_zeros(1)])
    return Geometry(v0, e1, e2, n, albedo[tri_mats], emi, rows, area,
                    area.sum())


def mt_t(o, d, v0, e1, e2):
    """Moller-Trumbore t, broadcast; MAX_FLOAT where the test rejects."""
    q = cross(d, e2)
    a = dot(e1, q)
    parallel = torch.abs(a) < EPS_PARALLEL
    inv_a = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = (o - v0) * inv_a[..., None]
    r = cross(s, e1)
    b0 = dot(s, q)
    b1 = dot(r, d)
    b2 = 1.0 - b0 - b1
    reject = parallel | (b0 < 0.0) | (b1 < 0.0) | (b2 < 0.0)
    return torch.where(reject, torch.full_like(a, MAX_FLOAT), dot(e2, r))


@torch.no_grad()
def closest_hits(g: Geometry, o, d, mask=None, t_cap=None,
                 block_elems: int = 1 << 25):
    """-> (t (R,), tri (R,) int64) of rays ``o``, ``d`` (R, 3): the closest
    triangle with 0 < t, ties to the lower id; MAX_FLOAT and -1 for a miss,
    a masked ray and a hit at or beyond ``t_cap``. Rays are tested against
    all triangles in blocks of about ``block_elems`` pairs."""
    R = o.shape[0]
    T = g.v0.shape[0]
    t_out = torch.full((R,), MAX_FLOAT, dtype=o.dtype, device=o.device)
    tri_out = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    live = (torch.arange(R, device=o.device) if mask is None
            else torch.nonzero(mask).flatten())
    v0, e1, e2 = (x.detach()[None] for x in (g.v0, g.e1, g.e2))
    step = max(1, block_elems // max(T, 1))
    for a in range(0, live.shape[0], step):
        rows = live[a:a + step]
        t = mt_t(o.detach()[rows, None], d.detach()[rows, None], v0, e1, e2)
        t = torch.where(t > 0.0, t, torch.full_like(t, MAX_FLOAT))
        tmin, arg = torch.min(t, dim=1)
        hit = tmin < MAX_FLOAT
        t_out[rows] = tmin
        tri_out[rows] = torch.where(hit, arg, -1)
    if t_cap is not None:
        beyond = t_out >= t_cap
        t_out = torch.where(beyond, torch.full_like(t_out, MAX_FLOAT), t_out)
        tri_out = torch.where(beyond, -1, tri_out)
    return t_out, tri_out
