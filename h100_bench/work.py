"""The yardstick: the rays a render counts, the work a fold call needs, and
the card's peaks. Frozen copies, so that a change to the program cannot
move the bounds it is measured against.

* Rays (the reference's accounting, CulDeVu/CUDAPathTracer kernel.cu:757,
  as the project's bench.py:118 counts them): pixels x samples x
  (bounces + 1).
* ``needed_work``: the tests, touched clusters and bytes that a fold
  kernel's inputs need of it, as a lower bound (a copy of the program's
  ``ops/kernels/work.py`` at the time this benchmark was written, with the
  box gate of ``csrc/bw_fold.cuh:box_gate``). A ray needs a test of every
  real triangle (an id below the triangle count with a nonzero normal) of
  every listed cluster, or member of a listed super, whose box it enters at
  or before its final t. The bytes are the rays, counts, listed ids and
  entries, the rows, ids and box of each cluster a needed test touches, and
  the outputs.
* Peaks of one NVIDIA H100 SXM (the data sheet, at the 700 W limit):
  67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations of one ray-triangle test (an FMA as 2, the reciprocal
# as 1, with the rejection's two compares): Baldwin-Weber 35,
# Moller-Trumbore 49
OPS_PER_TEST = {"bw": 35, "mt": 49}
ROWS_MT = 9   # a Moller-Trumbore pack holds v0, e1, e2; Baldwin-Weber 12


def rays(pixels: int, samples: int, bounces: int) -> int:
    return pixels * samples * (bounces + 1)


def _guarded_inv(d):
    return 1.0 / torch.where(d.abs() < 1e-30,
                             torch.where(d < 0, -1e-30, 1e-30), d)


def _box_gate(bx, o, inv, t):
    lo = [(bx[..., k, None] - o[k]) * inv[k] for k in range(3)]
    hi = [(bx[..., 3 + k, None] - o[k]) * inv[k] for k in range(3)]
    tmin = torch.maximum(torch.maximum(torch.minimum(lo[0], hi[0]),
                                       torch.minimum(lo[1], hi[1])),
                         torch.minimum(lo[2], hi[2]))
    tmax = torch.minimum(torch.minimum(torch.maximum(lo[0], hi[0]),
                                       torch.maximum(lo[1], hi[1])),
                         torch.maximum(lo[2], hi[2]))
    return (tmin <= tmax) & (tmax >= 0) & (tmin <= t)


def intersector_of(packed) -> str:
    return "mt" if packed.shape[1] == ROWS_MT else "bw"


def needed_work(ids, counts, rays_, t_final, pack, num_tris, F=None):
    """-> (tests, touched clusters, bytes) of one fold call: shortlists
    ``ids`` (Tl, M) with ``counts`` (Tl,) (in super units with ``F``), the
    rays (Tl, 8, P) [o, d, live, cap], the kernel's final t (Tl, P) and
    the pack (packed (K+1, rows, C), tri (K+1, C), boxes (K+1, 6))."""
    packed, tri, boxes = pack
    K1, rows, C = packed.shape
    K = K1 - 1
    if intersector_of(packed) == "mt":   # rows v0, e1, e2
        e1, e2 = packed[:, 3:6], packed[:, 6:9]
        normal = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                              e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                              e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], 1)
    else:                                # rows n, v0, m1, m2
        normal = packed[:, 0:3]
    real = ((tri < num_tris) & (normal != 0).any(dim=1)).sum(dim=1)
    Tl, M = ids.shape
    P = rays_.shape[2]
    live = rays_[:, 6] > 0.5
    o = rays_[:, 0:3]
    inv = _guarded_inv(rays_[:, 3:6])
    n_max = int(counts.max()) if Tl else 0
    width = n_max * (F or 1)
    tests = 0
    touched = torch.zeros(K1, dtype=torch.bool, device=packed.device)
    step = max(1, (1 << 24) // max(1, width * P))
    for a in range(0, Tl if n_max else 0, step):
        b = min(Tl, a + step)
        sel = ids[a:b, :n_max].long()
        ok = (torch.arange(n_max, device=sel.device)[None, :]
              < counts[a:b, None])
        if F is not None:
            j = torch.arange(F, device=sel.device)
            sel = torch.clamp(sel[:, :, None] * F + j, max=K).flatten(1)
            ok = ok.repeat_interleave(F, dim=1)
        need = (_box_gate(boxes[sel], [o[a:b, None, k] for k in range(3)],
                          [inv[a:b, None, k] for k in range(3)],
                          t_final[a:b, None])
                & live[a:b, None] & ok[:, :, None])
        per_cluster = need.sum(dim=2)
        tests += int((per_cluster * real[sel]).sum())
        touched[sel[per_cluster > 0]] = True
        del need
    n_touched = int(touched[:K].sum())
    nbytes = (rays_.numel() * 4 + Tl * 4 + int(counts.sum()) * 8
              + n_touched * ((rows + 1) * C * 4 + 6 * 4) + Tl * P * 8)
    return tests, n_touched, nbytes


def bound_seconds(tests: int, nbytes: int, intersector: str) -> float:
    """The least time the card could take: operations or bytes at peak."""
    return max(nbytes / PEAK_BYTES,
               tests * OPS_PER_TEST[intersector] / PEAK_FLOPS)
