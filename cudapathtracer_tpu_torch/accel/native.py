"""ctypes binding of the native binned-SAH BVH builder.

The port builds the JAX package's own C++ source,
``cudapathtracer_tpu/native/bvh_builder.cpp``, with ``g++`` into ``build/``
(reading a source file imports nothing from that package) with the flags of
that package's Makefile, so both packages build identical trees. The
``-ffp-contract=off`` flag is what keeps the SAH scores rounding alike.
A failed build raises; there is no slower fallback builder.
"""

from __future__ import annotations

import ctypes as C
import functools
import os

import numpy as np

from ..utils.build import REPO_DIR, build_and_load

SOURCE = os.path.join(REPO_DIR, "cudapathtracer_tpu", "native",
                      "bvh_builder.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fPIC",
             "-shared", "-std=c++17"]


class _BVHOut(C.Structure):
    _fields_ = [
        ("n_nodes", C.c_int64),
        ("n_leaves", C.c_int64),
        ("leaf_size", C.c_int32),
        ("depth", C.c_int32),
        ("node_lo", C.POINTER(C.c_float)),
        ("node_hi", C.POINTER(C.c_float)),
        ("node_skip", C.POINTER(C.c_int32)),
        ("node_leaf", C.POINTER(C.c_int32)),
        ("leaf_tri", C.POINTER(C.c_int32)),
    ]


@functools.cache
def load():
    """Build (when stale) and load the builder library."""
    lib = build_and_load("libcptbvh.so", [SOURCE],
                         [os.environ.get("CXX", "g++")] + CXX_FLAGS)
    lib.cpt_build_bvh.restype = C.c_int
    lib.cpt_build_bvh.argtypes = [
        C.POINTER(C.c_float), C.c_int64,
        C.POINTER(C.c_int32), C.c_int64,
        C.c_int32, C.POINTER(_BVHOut),
    ]
    lib.cpt_free_bvh.restype = None
    lib.cpt_free_bvh.argtypes = [C.POINTER(_BVHOut)]
    return lib


def build_bvh_native(verts, tri_indices, leaf_size: int = 4):
    """C++ binned-SAH build -> (dict of host arrays, depth): node_lo/node_hi
    (N, 3), node_skip/node_leaf (N,), leaf_tri (NL, leaf_size)."""
    lib = load()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tri_indices, np.int32)
    out = _BVHOut()
    rc = lib.cpt_build_bvh(
        verts.ctypes.data_as(C.POINTER(C.c_float)), verts.shape[0],
        tris.ctypes.data_as(C.POINTER(C.c_int32)), tris.shape[0],
        leaf_size, C.byref(out),
    )
    if rc != 0:
        raise RuntimeError(f"cpt_build_bvh failed with code {rc}")
    try:
        n, nl = out.n_nodes, out.n_leaves
        arrays = dict(
            node_lo=np.ctypeslib.as_array(out.node_lo, (n, 3)).copy(),
            node_hi=np.ctypeslib.as_array(out.node_hi, (n, 3)).copy(),
            node_skip=np.ctypeslib.as_array(out.node_skip, (n,)).copy(),
            node_leaf=np.ctypeslib.as_array(out.node_leaf, (n,)).copy(),
            leaf_tri=np.ctypeslib.as_array(out.leaf_tri,
                                           (nl, leaf_size)).copy(),
        )
        depth = int(out.depth)
    finally:
        lib.cpt_free_bvh(C.byref(out))
    return arrays, depth
