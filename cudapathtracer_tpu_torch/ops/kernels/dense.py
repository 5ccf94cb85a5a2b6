"""K2: dense closest-hit for scenes past the resident kernel's budget.

The CUDA kernel (``csrc/dense.cu``) replaces the Pallas TPU kernel
``cudapathtracer_tpu/ops/pallas/dense.py:dense_intersect``; the note at the
top of the CUDA source says what bounds it on the card and what its design
does about that. It computes K1's function (``dense_resident.py``) on K1's
inputs and scene layout (``pack_clusters``), and streams cluster chunks into
shared memory with ``cp.async`` ahead of the fold.

* ``dense_intersect_plain``: K1's plain fold, under its own name and with
  its own call count, as the JAX module imports its fold from the resident
  one (dense.py:47-71).
* ``dense_intersect``, the wrapper: K2 on CUDA tensors (raising if the build
  or the launch fails), the plain version only for tensors on the CPU.
  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import functools
import os

from ...utils.build import PACKAGE_DIR
from .dense_resident import (
    is_cpu,
    launch_fold,
    load_fold_kernel,
    plain_fold,
)

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "dense.cu")


def dense_intersect_plain(ids, counts, entries, rays, packed, tri, boxes):
    """K2's plain PyTorch version: K1's plain fold, counted."""
    dense_intersect_plain.calls += 1
    return plain_fold(ids, counts, entries, rays, packed, tri, boxes)


dense_intersect_plain.calls = 0


@functools.cache
def _load_kernel():
    return load_fold_kernel("libdense_stream.so", SOURCE,
                            "dense_stream_launch", 5)


def build():
    """Build and load the kernel library (it is otherwise built at the
    first launch)."""
    _load_kernel()


def dense_intersect(ids, counts, entries, rays, packed, tri, boxes):
    """K2 on CUDA tensors; the plain version for tensors on the CPU."""
    if is_cpu(rays):
        return dense_intersect_plain(ids, counts, entries, rays, packed, tri,
                                     boxes)
    # 16-byte copies need C a multiple of 4 and 16-byte aligned arrays
    vec = int(packed.shape[-1] % 4 == 0 and packed.data_ptr() % 16 == 0
              and tri.data_ptr() % 16 == 0)
    out = launch_fold(_load_kernel, "dense", ids, counts, entries, rays,
                      packed, tri, boxes, extra=(vec,))
    dense_intersect.launches += 1
    return out


dense_intersect.launches = 0
