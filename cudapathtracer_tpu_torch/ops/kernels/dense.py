"""K2: dense closest-hit for scenes past the resident kernel's budget.

The CUDA kernel (``csrc/dense.cu``) replaces the Pallas TPU kernel
``cudapathtracer_tpu/ops/pallas/dense.py:dense_intersect``; the note at the
top of the CUDA source says what bounds it on the card and what its design
does about that. It computes K1's function (``dense_resident.py``) on K1's
inputs and scene layout (``pack_clusters``) through the gated fold
(``csrc/gated_fold.cuh``): per slot, only the rays that pass the cluster's
gate are folded, each thread testing one triangle against them.

* ``dense_intersect_plain``: K1's plain fold, under its own name and with
  its own call count, as the JAX module imports its fold from the resident
  one (dense.py:47-71).
* ``dense_intersect``, the wrapper: K2 on CUDA tensors (raising if the build
  or the launch fails), the plain version only for tensors on the CPU.
  ``launches`` counts kernel launches. ``counts_out`` selects the counting
  instance and ``vis_band`` the visibility instance, as for K1.
"""

from __future__ import annotations

import functools
import os

from ...utils.build import PACKAGE_DIR
from .dense_resident import (
    GATED_FOLD_FLAGS,
    check_inputs,
    is_cpu,
    launch_fold,
    load_fold_kernel,
    plain_fold,
)

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "dense.cu")


def dense_intersect_plain(ids, counts, entries, rays, packed, tri, boxes,
                          vis_band: float = 0.0):
    """K2's plain PyTorch version: K1's plain fold, counted."""
    dense_intersect_plain.calls += 1
    return plain_fold(ids, counts, entries, rays, packed, tri, boxes,
                      vis_band)


dense_intersect_plain.calls = 0


@functools.cache
def _load_kernel():
    return load_fold_kernel("libdense_stream.so", SOURCE,
                            "dense_stream_launch", 6, flags=GATED_FOLD_FLAGS)


def build():
    """Build and load the kernel library (it is otherwise built at the
    first launch)."""
    _load_kernel()


def dense_intersect(ids, counts, entries, rays, packed, tri, boxes,
                    counts_out=None, vis_band: float = 0.0,
                    intersector: str = "bw"):
    """K2 on CUDA tensors (its counting instance given ``counts_out``, its
    visibility instance given ``vis_band`` > 0, its triangle test the
    ``intersector``'s, whose pack it needs); the plain version for tensors
    on the CPU."""
    if is_cpu(rays, counts_out):
        check_inputs(ids, counts, entries, rays, packed, tri, boxes,
                     intersector)
        return dense_intersect_plain(ids, counts, entries, rays, packed, tri,
                                     boxes, vis_band)
    out = launch_fold(_load_kernel, "dense", ids, counts, entries, rays,
                      packed, tri, boxes, extra=(packed.shape[0] - 1,),
                      counts_out=counts_out, vis_band=vis_band,
                      intersector=intersector)
    dense_intersect.launches += 1
    return out


dense_intersect.launches = 0
