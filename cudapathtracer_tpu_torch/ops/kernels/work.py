"""What the dense fold kernels' inputs need of them, as a lower bound: the
yardstick for their times (the bound that ``tools/time_kernels.py``
prints) and for their counting instances (lane tests issued against tests
needed).

A ray needs a test of every real triangle (an id below the triangle count,
and a normal e1 x e2 that is not zero: a degenerate triangle never hits) of
every
listed cluster (or member of a listed super) whose box it enters at or
before its final t; the box test is the kernels' gate
(``csrc/bw_fold.cuh:box_gate``). The bytes are
the rays, counts, listed ids and entries, the rows, ids and box of each
cluster a needed test touches, and the outputs. A test's float32
operations, ``OPS_PER_TEST``, are the intersector's.
"""

from __future__ import annotations

import torch

from ..vecmath import Vec3, cross
from .dense_resident import box_gate, guarded_inv, intersector_of

# float32 operations of one ray-triangle test, counted alike from
# csrc/bw_fold.cuh (an FMA as 2, the reciprocal as 1): bw_test's arithmetic
# is 33 and mt_test's 47, and each count adds 2 for the rejection's
# compares, as the Baldwin-Weber count of 35 always has
OPS_PER_TEST = {"bw": 35, "mt": 49}


def needed_work(sl, t_final, pack, num_tris, F=None):
    """-> (tests, touched clusters, bytes) for shortlists ``sl``
    (``packets.Shortlists``; in super units with ``F``), the kernel's final
    t (Tl, P) and ``pack_clusters``'s (packed, tri, boxes)."""
    packed, tri, boxes = pack
    K1, rows, C = packed.shape
    K = K1 - 1
    if intersector_of(packed) == "mt":   # rows v0, e1, e2
        normal = cross(Vec3(*packed[:, 3:6].unbind(1)),
                       Vec3(*packed[:, 6:9].unbind(1)))
        normal = torch.stack(normal, dim=1)
    else:                                # rows n, v0, m1, m2
        normal = packed[:, 0:3]
    real = ((tri < num_tris) & (normal != 0).any(dim=1)).sum(dim=1)
    Tl, M = sl.ids.shape
    P = sl.rays.shape[2]
    live = sl.rays[:, 6] > 0.5
    o = sl.rays[:, 0:3]
    inv = guarded_inv(sl.rays[:, 3:6])
    n_max = int(sl.counts.max()) if Tl else 0
    width = n_max * (F or 1)
    tests = 0
    touched = torch.zeros(K1, dtype=torch.bool, device=packed.device)
    step = max(1, (1 << 24) // max(1, width * P))
    for a in range(0, Tl if n_max else 0, step):
        b = min(Tl, a + step)
        ids = sl.ids[a:b, :n_max].long()
        ok = (torch.arange(n_max, device=ids.device)[None, :]
              < sl.counts[a:b, None])
        if F is not None:
            j = torch.arange(F, device=ids.device)
            ids = torch.clamp(ids[:, :, None] * F + j, max=K).flatten(1)
            ok = ok.repeat_interleave(F, dim=1)
        need = (box_gate(boxes[ids], [o[a:b, None, k] for k in range(3)],
                         [inv[a:b, None, k] for k in range(3)],
                         t_final[a:b, None])
                & live[a:b, None] & ok[:, :, None])     # (n, width, P)
        per_cluster = need.sum(dim=2)
        tests += int((per_cluster * real[ids]).sum())
        touched[ids[per_cluster > 0]] = True
        del need
    n_touched = int(touched[:K].sum())
    nbytes = (sl.rays.numel() * 4 + Tl * 4 + int(sl.counts.sum()) * 8
              + n_touched * ((rows + 1) * C * 4 + 6 * 4) + Tl * P * 8)
    return tests, n_touched, nbytes
