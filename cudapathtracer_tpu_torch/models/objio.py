"""Wavefront OBJ/MTL parser (pure-Python twin of csrc/obj_loader.cpp).

A copy of ``cudapathtracer_tpu/models/objio.py``; the port imports nothing
of the JAX package.

Re-implements the subset of tinyobjloader the reference exercises
(tiny_obj_loader.cc:661-884): ``v/vn/vt/f/usemtl/mtllib/g/o`` lines,
polygon-to-triangle-fan conversion (tiny_obj_loader.cc:382-402), vertex
dedup per (v, vt, vn) triple (tiny_obj_loader.cc:304-339), negative-index
fixup (tiny_obj_loader.cc:77-81), and the MTL keys Ka/Kd/Ks/Ke/Ns/Ni/d/illum
(tiny_obj_loader.cc:413-615). Faces are split into shapes on material
change / group markers like tinyobj's exportFaceGroupToShape.

Unlike the reference's loader wrapper we record a material id PER FACE
(tinyobj does too — the reference then throws that away and uses
material_ids[0] for the whole shape, modelLoader.h:189; that quirk is fixed
per SURVEY.md §7).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class ObjMaterial:
    name: str
    ambient: tuple = (0.0, 0.0, 0.0)
    diffuse: tuple = (0.0, 0.0, 0.0)
    specular: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)
    shininess: float = 1.0
    ior: float = 1.0
    dissolve: float = 1.0
    illum: int = 0
    # texture map names (tiny_obj_loader.cc:552-575 parses map_Ka/map_Kd/
    # map_Ks/map_Ns): parsed for parity completeness, UNUSED by the renderer
    # (no reference scene carries textures; the reference ignores them too)
    ambient_texname: str = ""
    diffuse_texname: str = ""
    specular_texname: str = ""
    normal_texname: str = ""


@dataclass
class ObjShape:
    name: str
    positions: List[float] = field(default_factory=list)   # flat xyz
    normals: List[float] = field(default_factory=list)
    texcoords: List[float] = field(default_factory=list)
    indices: List[int] = field(default_factory=list)        # flat v0v1v2
    material_ids: List[int] = field(default_factory=list)   # per face


def _fix_index(idx: int, n: int) -> int:
    """OBJ 1-based; negative = relative to current count
    (tiny_obj_loader.cc:77-81)."""
    if idx > 0:
        return idx - 1
    if idx < 0:
        return n + idx
    raise ValueError("OBJ index 0 is invalid")


def parse_mtl(path) -> Dict[str, ObjMaterial]:
    mats: Dict[str, ObjMaterial] = {}
    cur = None
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            tok = line.split()
            key = tok[0]
            if key == "newmtl":
                cur = ObjMaterial(name=tok[1] if len(tok) > 1 else "")
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Ka":
                cur.ambient = tuple(float(x) for x in tok[1:4])
            elif key == "Kd":
                cur.diffuse = tuple(float(x) for x in tok[1:4])
            elif key == "Ks":
                cur.specular = tuple(float(x) for x in tok[1:4])
            elif key == "Ke":
                cur.emission = tuple(float(x) for x in tok[1:4])
            elif key == "Ns":
                cur.shininess = float(tok[1])
            elif key == "Ni":
                cur.ior = float(tok[1])
            elif key == "d":
                cur.dissolve = float(tok[1])
            elif key == "Tr":
                cur.dissolve = 1.0 - float(tok[1])
            elif key == "illum":
                cur.illum = int(tok[1])
            elif key == "map_Ka":
                cur.ambient_texname = tok[1] if len(tok) > 1 else ""
            elif key == "map_Kd":
                cur.diffuse_texname = tok[1] if len(tok) > 1 else ""
            elif key == "map_Ks":
                cur.specular_texname = tok[1] if len(tok) > 1 else ""
            elif key == "map_Ns":
                cur.normal_texname = tok[1] if len(tok) > 1 else ""
    return mats


def parse_obj(path, mtl_base_dir=None):
    """Returns (shapes: List[ObjShape], materials: List[ObjMaterial]).

    Shape splitting follows tinyobj: a new shape is emitted at group/object
    markers when faces have accumulated. Vertices are deduped per
    (v, vt, vn) triple within a shape.
    """
    if mtl_base_dir is None:
        mtl_base_dir = os.path.dirname(os.path.abspath(path))

    positions: List[float] = []
    normals: List[float] = []
    texcoords: List[float] = []

    materials: List[ObjMaterial] = []
    mat_index: Dict[str, int] = {}

    shapes: List[ObjShape] = []
    faces: List[List[tuple]] = []   # pending faces: list of corner triples
    face_mats: List[int] = []
    cur_mat = -1
    cur_name = ""

    def flush(name):
        nonlocal faces, face_mats
        if not faces:
            return
        shape = ObjShape(name=name)
        cache: Dict[tuple, int] = {}
        for corners, m in zip(faces, face_mats):
            # fan-triangulate (tiny_obj_loader.cc:382-402)
            for k in range(2, len(corners)):
                tri = (corners[0], corners[k - 1], corners[k])
                for c in tri:
                    if c not in cache:
                        cache[c] = len(shape.positions) // 3
                        vi, ti, ni = c
                        shape.positions.extend(positions[3 * vi : 3 * vi + 3])
                        if ti is not None and texcoords:
                            shape.texcoords.extend(
                                texcoords[2 * ti : 2 * ti + 2]
                            )
                        if ni is not None and normals:
                            shape.normals.extend(normals[3 * ni : 3 * ni + 3])
                    shape.indices.append(cache[c])
                shape.material_ids.append(m)
        shapes.append(shape)
        faces = []
        face_mats = []

    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            tok = line.split()
            key = tok[0]
            if key == "v":
                positions.extend(float(x) for x in tok[1:4])
            elif key == "vn":
                normals.extend(float(x) for x in tok[1:4])
            elif key == "vt":
                texcoords.extend(float(x) for x in tok[1:3])
            elif key == "f":
                corners = []
                for c in tok[1:]:
                    parts = c.split("/")
                    vi = _fix_index(int(parts[0]), len(positions) // 3)
                    ti = (
                        _fix_index(int(parts[1]), len(texcoords) // 2)
                        if len(parts) > 1 and parts[1]
                        else None
                    )
                    ni = (
                        _fix_index(int(parts[2]), len(normals) // 3)
                        if len(parts) > 2 and parts[2]
                        else None
                    )
                    corners.append((vi, ti, ni))
                faces.append(corners)
                face_mats.append(cur_mat)
            elif key == "usemtl":
                name = tok[1] if len(tok) > 1 else ""
                cur_mat = mat_index.get(name, -1)
            elif key == "mtllib":
                for mtl_name in tok[1:]:
                    mpath = os.path.join(mtl_base_dir, mtl_name)
                    if os.path.exists(mpath):
                        for name, m in parse_mtl(mpath).items():
                            if name not in mat_index:
                                mat_index[name] = len(materials)
                                materials.append(m)
            elif key in ("g", "o"):
                flush(cur_name)
                cur_name = " ".join(tok[1:])
    flush(cur_name)
    return shapes, materials
