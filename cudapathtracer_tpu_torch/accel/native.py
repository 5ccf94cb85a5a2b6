"""ctypes bindings of the native host code: the binned-SAH BVH build and
the OBJ/MTL parser.

The port keeps its own byte-for-byte copies of the JAX package's C++
sources, ``csrc/bvh_builder.cpp`` and ``csrc/obj_loader.cpp`` (the
originals are in ``cudapathtracer_tpu/native/``), and builds each with
``g++`` into a library of its own under ``build/``, with the flags of that
package's Makefile, so both packages build identical trees and parse alike.
The ``-ffp-contract=off`` flag is what keeps the SAH scores rounding alike.
A failed build raises; there is no slower fallback, and the loader takes
the Python parser only when its caller asks for it.
"""

from __future__ import annotations

import ctypes as C
import functools
import os

import numpy as np

from ..utils.build import PACKAGE_DIR, build_and_load

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "bvh_builder.cpp")
OBJ_SOURCE = os.path.join(PACKAGE_DIR, "csrc", "obj_loader.cpp")
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


@functools.cache
def load_obj_parser():
    """Build (when stale) and load the OBJ/MTL parser library."""
    lib = build_and_load("libcptobj.so", [OBJ_SOURCE],
                         [os.environ.get("CXX", "g++")] + CXX_FLAGS)
    lib.cpt_parse_obj.restype = C.c_void_p
    lib.cpt_parse_obj.argtypes = [C.c_char_p, C.c_char_p]
    lib.cpt_obj_error.restype = C.c_char_p
    lib.cpt_obj_error.argtypes = [C.c_void_p]
    for name in ("cpt_obj_num_shapes", "cpt_obj_num_materials"):
        fn = getattr(lib, name)
        fn.restype = C.c_int64
        fn.argtypes = [C.c_void_p]
    for name in ("cpt_obj_shape_num_verts", "cpt_obj_shape_num_faces",
                 "cpt_obj_shape_num_normals", "cpt_obj_shape_num_texcoords"):
        fn = getattr(lib, name)
        fn.restype = C.c_int64
        fn.argtypes = [C.c_void_p, C.c_int64]
    lib.cpt_obj_material.restype = None
    lib.cpt_obj_material.argtypes = [C.c_void_p, C.c_int64,
                                     C.POINTER(C.c_float)]
    lib.cpt_obj_material_extra.restype = None
    lib.cpt_obj_material_extra.argtypes = [C.c_void_p, C.c_int64,
                                           C.POINTER(C.c_float)]
    lib.cpt_obj_material_name.restype = C.c_char_p
    lib.cpt_obj_material_name.argtypes = [C.c_void_p, C.c_int64]
    lib.cpt_obj_shape_data.restype = None
    lib.cpt_obj_shape_data.argtypes = [
        C.c_void_p, C.c_int64, C.POINTER(C.c_float),
        C.POINTER(C.c_int32), C.POINTER(C.c_int32),
        C.POINTER(C.c_float), C.POINTER(C.c_float),
    ]
    lib.cpt_obj_free.restype = None
    lib.cpt_obj_free.argtypes = [C.c_void_p]
    return lib


def parse_obj_native(path, mtl_base_dir=None):
    """C++ OBJ parse -> (shapes, materials) as ``models.objio.parse_obj``
    gives them (``ObjShape``, ``ObjMaterial``); the counterpart of the JAX
    package's ``accel/native.py:parse_obj_native``. A parse error raises."""
    from ..models.objio import ObjMaterial, ObjShape

    lib = load_obj_parser()
    h = lib.cpt_parse_obj(os.fspath(path).encode(),
                          os.fspath(mtl_base_dir or "").encode())
    if not h:
        raise RuntimeError("cpt_parse_obj returned NULL")
    try:
        err = lib.cpt_obj_error(h)
        if err:
            raise RuntimeError(err.decode())

        materials = []
        buf13 = (C.c_float * 13)()
        buf3 = (C.c_float * 3)()
        for i in range(lib.cpt_obj_num_materials(h)):
            lib.cpt_obj_material(h, i, buf13)
            lib.cpt_obj_material_extra(h, i, buf3)
            v = list(buf13)
            materials.append(ObjMaterial(
                name=lib.cpt_obj_material_name(h, i).decode(),
                ambient=tuple(v[0:3]), diffuse=tuple(v[3:6]),
                specular=tuple(v[6:9]), emission=tuple(v[9:12]),
                shininess=v[12], ior=buf3[0], dissolve=buf3[1],
                illum=int(buf3[2]),
            ))

        shapes = []
        for s in range(lib.cpt_obj_num_shapes(h)):
            nv = lib.cpt_obj_shape_num_verts(h, s)
            nf = lib.cpt_obj_shape_num_faces(h, s)
            nn = lib.cpt_obj_shape_num_normals(h, s)
            nt = lib.cpt_obj_shape_num_texcoords(h, s)
            pos = np.empty(nv * 3, np.float32)
            idx = np.empty(nf * 3, np.int32)
            mid = np.empty(nf, np.int32)
            nrm = np.empty(nn * 3, np.float32)
            tex = np.empty(nt * 2, np.float32)
            lib.cpt_obj_shape_data(
                h, s,
                pos.ctypes.data_as(C.POINTER(C.c_float)),
                idx.ctypes.data_as(C.POINTER(C.c_int32)),
                mid.ctypes.data_as(C.POINTER(C.c_int32)),
                nrm.ctypes.data_as(C.POINTER(C.c_float)),
                tex.ctypes.data_as(C.POINTER(C.c_float)),
            )
            shapes.append(ObjShape(
                name="", positions=pos.tolist(), normals=nrm.tolist(),
                texcoords=tex.tolist(), indices=idx.tolist(),
                material_ids=mid.tolist(),
            ))
        return shapes, materials
    finally:
        lib.cpt_obj_free(h)
