"""K3: dense closest-hit over supercluster shortlists.

The CUDA kernel (``csrc/dense_super.cu``) replaces the Pallas TPU kernel
``cudapathtracer_tpu/ops/pallas/dense_resident.py:
dense_intersect_resident_super``; the note at the top of the CUDA source
says what bounds it on the card and what its design does about that.

Its shortlist is in supercluster units: ids (Tl, M) are super indices, whose
members are the clusters sup * F + j (j < F) clamped to the sentinel K, and
entries are the supers' entry distances, ascending. Rays, scene layout
(``pack_clusters``) and output are K1's (``dense_resident.py``).

* ``expand_supers`` turns a super shortlist into K1's member shortlist
  (Tl, M * F): members of slot s at columns s * F .. s * F + F - 1, counts
  times F, the sentinel K past them.
* ``dense_intersect_super_plain``: the plain fold over the expanded
  shortlist. The fold is a lexicographic minimum, so member order does not
  matter.
* ``dense_intersect_super``, the wrapper: K3 on CUDA tensors (raising if the
  build or the launch fails), the plain version only for tensors on the
  CPU. ``launches`` counts kernel launches. ``counts_out`` selects the
  counting instance, as for K1, and its first column counts members folded;
  ``vis_band`` selects the visibility instance, as for K1.
  The kernel keeps a super's member gates in a 32-bit mask: F <= 32.
"""

from __future__ import annotations

import functools
import os

import torch

from ...utils.build import PACKAGE_DIR
from .dense_resident import (
    GATED_FOLD_FLAGS,
    check_inputs,
    is_cpu,
    launch_fold,
    load_fold_kernel,
    plain_fold,
)

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "dense_super.cu")


def expand_supers(ids, counts, entries, F: int, K: int):
    """Super shortlist -> (member ids (Tl, M*F) i32, counts*F, entries
    repeated F times)."""
    Tl, M = ids.shape
    j = torch.arange(F, dtype=torch.int64, device=ids.device)
    members = torch.clamp(ids.long()[:, :, None] * F + j, max=K)
    real = (torch.arange(M, device=ids.device)[None, :]
            < counts.long()[:, None])
    members = torch.where(real[:, :, None], members, K)
    return (members.reshape(Tl, M * F).to(torch.int32).contiguous(),
            (counts * F).to(torch.int32),
            entries.repeat_interleave(F, dim=1).contiguous())


def dense_intersect_super_plain(ids, counts, entries, rays, packed, tri,
                                boxes, F: int, vis_band: float = 0.0):
    """K3's plain PyTorch version: K1's plain fold over every member of
    every listed super."""
    dense_intersect_super_plain.calls += 1
    m_ids, m_counts, m_entries = expand_supers(ids, counts, entries, F,
                                               packed.shape[0] - 1)
    return plain_fold(m_ids, m_counts, m_entries, rays, packed, tri, boxes,
                      vis_band)


dense_intersect_super_plain.calls = 0


@functools.cache
def _load_kernel():
    return load_fold_kernel("libdense_super.so", SOURCE,
                            "dense_super_launch", 7, flags=GATED_FOLD_FLAGS)


def build():
    """Build and load the kernel library (it is otherwise built at the
    first launch)."""
    _load_kernel()


def dense_intersect_super(ids, counts, entries, rays, packed, tri, boxes,
                          F: int, counts_out=None, vis_band: float = 0.0,
                          intersector: str = "bw"):
    """K3 on CUDA tensors (its counting instance given ``counts_out``, its
    visibility instance given ``vis_band`` > 0, its triangle test the
    ``intersector``'s, whose pack it needs); the plain version for tensors
    on the CPU."""
    if F < 1:
        raise ValueError(f"super_factor {F} must be at least 1")
    if is_cpu(rays, counts_out):
        check_inputs(ids, counts, entries, rays, packed, tri, boxes,
                     intersector)
        return dense_intersect_super_plain(ids, counts, entries, rays,
                                           packed, tri, boxes, F, vis_band)
    if F > 32:
        raise ValueError(f"super_factor {F}: the kernel takes at most 32")
    out = launch_fold(_load_kernel, "dense_super", ids, counts, entries,
                      rays, packed, tri, boxes,
                      extra=(int(F), packed.shape[0] - 1),
                      counts_out=counts_out, vis_band=vis_band,
                      intersector=intersector)
    dense_intersect_super.launches += 1
    return out


dense_intersect_super.launches = 0
