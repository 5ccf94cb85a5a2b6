"""Scene loading: the ``loadOBJ`` equivalent.

Counterpart of ``cudapathtracer_tpu/models/loader.py`` (reference:
modelLoader.h:125-210): parse OBJ+MTL, apply a per-call transform
``v*scale + origin``, convert MTL diffuse -> albedo and emission ->
emission, face normals from the winding (optionally flipped), emissive
triangles by ``emission.r != 0`` into the light list, and the total light
area, all on the host; ``make_scene`` then uploads the scene to ``device``.
The two loader quirks stay fixed as in the JAX package: no duplicate
material push (modelLoader.h:137-159) and per-face material ids
(modelLoader.h:189).

``use_native=True`` parses with the native C++ parser
(``csrc/obj_loader.cpp`` through ``accel/native.parse_obj_native``): a failed
build or parse raises. Unlike the JAX package, nothing falls back to the
Python parser; ``use_native=False`` asks for it. Both give identical
arrays (tests/test_torch_scene_io.py).
"""

from __future__ import annotations

import numpy as np

from .objio import parse_obj
from .scene import Scene, make_scene, merge_scenes


def obj_arrays(path, origin=(0.0, 0.0, 0.0), scale: float = 1.0,
               mtl_base_dir=None, use_native: bool = True):
    """Parse one OBJ into host arrays -> (verts (V, 3) f32, tris (T, 3) i32,
    tri_mats (T,) i32, albedo (M, 3) f32, emission (M, 3) f32), the
    transform applied."""
    if use_native:
        from ..accel.native import parse_obj_native

        shapes, materials = parse_obj_native(path, mtl_base_dir)
    else:
        shapes, materials = parse_obj(path, mtl_base_dir)

    albedo = np.array([m.diffuse for m in materials],
                      np.float32).reshape(-1, 3)
    emission = np.array([m.emission for m in materials],
                        np.float32).reshape(-1, 3)
    if albedo.shape[0] == 0:
        # default material for an OBJ with no MTL (black, like an untouched
        # materialDesc in the reference)
        albedo = np.zeros((1, 3), np.float32)
        emission = np.zeros((1, 3), np.float32)

    all_verts, all_tris, all_mats = [], [], []
    voffset = 0
    for sh in shapes:
        pos = np.asarray(sh.positions, np.float32).reshape(-1, 3)
        pos = pos * np.float32(scale) + np.asarray(origin, np.float32)
        idx = np.asarray(sh.indices, np.int64).reshape(-1, 3) + voffset
        mids = np.asarray(sh.material_ids, np.int64)
        mids = np.where(mids < 0, 0, mids)  # faces with no usemtl -> mat 0
        all_verts.append(pos)
        all_tris.append(idx)
        all_mats.append(mids)
        voffset += pos.shape[0]

    verts = (np.concatenate(all_verts) if all_verts
             else np.zeros((0, 3), np.float32))
    tris = (np.concatenate(all_tris).astype(np.int32) if all_tris
            else np.zeros((0, 3), np.int32))
    mats = (np.concatenate(all_mats).astype(np.int32) if all_mats
            else np.zeros((0,), np.int32))
    return verts, tris, mats, albedo, emission


def load_obj(path, origin=(0.0, 0.0, 0.0), scale: float = 1.0,
             flip_normals: bool = False, mtl_base_dir=None,
             use_native: bool = True, *, device="cuda") -> Scene:
    """Load one OBJ into a Scene on ``device`` (reference: loadOBJ,
    modelLoader.h:125)."""
    return make_scene(*obj_arrays(path, origin, scale, mtl_base_dir,
                                  use_native),
                      flip_normals=flip_normals, device=device)


def load_objs(specs, *, device="cuda") -> Scene:
    """Load several OBJs into one merged scene on ``device``, like the
    reference's successive loadOBJ calls appending to globals
    (kernel.cu:591-592).

    specs: iterable of (path, origin, scale) or (path, origin, scale, flip).
    """
    scene = None
    for spec in specs:
        path, origin, scale = spec[0], spec[1], spec[2]
        flip = spec[3] if len(spec) > 3 else False
        s = load_obj(path, origin, scale, flip, device=device)
        scene = s if scene is None else merge_scenes(scene, s)
    return scene
