"""Frozen copies of the project's mesh helpers (boxes, icospheres, the
Cornell box), shared by the scene generators in ``scenes/``. Each returns
host arrays: verts (V, 3) float32, tris (T, 3) int32."""

from __future__ import annotations

import numpy as np


def _quad(a, b, c, d):
    """Two CCW triangles for quad a-b-c-d."""
    return [(a, b, c), (a, c, d)]


def box_mesh(lo, hi, inward: bool = False):
    """12-triangle axis-aligned box. ``inward=True`` flips winding so face
    normals (computed from winding, modelLoader.h:201) point inside."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )
    faces = []
    faces += _quad(4, 5, 6, 7)  # +z
    faces += _quad(1, 0, 3, 2)  # -z
    faces += _quad(5, 1, 2, 6)  # +x
    faces += _quad(0, 4, 7, 3)  # -x
    faces += _quad(7, 6, 2, 3)  # +y
    faces += _quad(0, 1, 5, 4)  # -y
    f = np.array(faces, np.int32)
    if inward:
        f = f[:, ::-1]
    return v, f


def transformed(verts, origin=(0.0, 0.0, 0.0), scale=1.0):
    """Per-instance transform: v*scale + origin (modelLoader.h:171-173)."""
    return np.asarray(verts, np.float32) * np.float32(scale) + np.asarray(
        origin, np.float32
    )


CORNELL_MATERIALS = {
    "white": dict(albedo=(0.725, 0.71, 0.68), emission=(0.0, 0.0, 0.0)),
    "red": dict(albedo=(0.63, 0.065, 0.05), emission=(0.0, 0.0, 0.0)),
    "green": dict(albedo=(0.14, 0.45, 0.091), emission=(0.0, 0.0, 0.0)),
    "light": dict(albedo=(0.78, 0.78, 0.78), emission=(17.0, 12.0, 4.0)),
}


def cornell_box(light_scale: float = 1.0, with_boxes: bool = True):
    """CornellBox-Original: interior of [-1,1] x [0,2] x [-1,1].

    The ceiling light is a downward-facing quad at y just below the ceiling
    — its face normal is (0,-1,0), which the reference's PT integrator
    hard-codes (kernel.cu:503), so this scene satisfies that assumption
    exactly. Camera convention matches kernel.cu:643-646: pos (0,1,3),
    open side toward +z.
    """
    mat_names = ["white", "red", "green", "light"]
    albedo = np.array([CORNELL_MATERIALS[m]["albedo"] for m in mat_names], np.float32)
    emission = np.array(
        [CORNELL_MATERIALS[m]["emission"] for m in mat_names], np.float32
    )
    emission[3] *= light_scale
    WHITE, RED, GREEN, LIGHT = 0, 1, 2, 3

    verts = []
    tris = []
    mats = []

    def add_quad(a, b, c, d, m):
        base = len(verts)
        verts.extend([a, b, c, d])
        tris.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
        mats.extend([m, m])

    # floor (normal +y): CCW seen from above
    add_quad((-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1), WHITE)
    # ceiling (normal -y)
    add_quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1), WHITE)
    # back wall z=-1 (normal +z)
    add_quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1), WHITE)
    # left wall x=-1 (normal +x)
    add_quad((-1, 0, -1), (-1, 2, -1), (-1, 2, 1), (-1, 0, 1), RED)
    # right wall x=+1 (normal -x)
    add_quad((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1), GREEN)
    # ceiling light: quad at y=1.98, facing down (normal (0,-1,0))
    s = 0.47
    y = 1.98
    add_quad((-s, y, s), (s, y, s), (s, y, -s), (-s, y, -s), LIGHT)

    if with_boxes:
        # short box (right-front), rotated ~ -17 deg about y
        sv, sf = box_mesh((-0.3, 0.0, -0.3), (0.3, 0.6, 0.3))
        sv = _rot_y(sv, -17.0)
        sv = transformed(sv, origin=(0.33, 0.0, 0.37))
        base = len(verts)
        verts.extend(sv.tolist())
        tris.extend((sf + base).tolist())
        mats.extend([WHITE] * len(sf))
        # tall box (left-back), rotated ~ +17 deg
        tv, tf = box_mesh((-0.3, 0.0, -0.3), (0.3, 1.2, 0.3))
        tv = _rot_y(tv, 17.0)
        tv = transformed(tv, origin=(-0.33, 0.0, -0.28))
        base = len(verts)
        verts.extend(tv.tolist())
        tris.extend((tf + base).tolist())
        mats.extend([WHITE] * len(tf))

    return dict(
        verts=np.array(verts, np.float32),
        tris=np.array(tris, np.int32),
        tri_mats=np.array(mats, np.int32),
        albedo=albedo,
        emission=emission,
        mat_names=mat_names,
    )


def _rot_y(v, deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return np.asarray(v, np.float32) @ r.T


def icosphere(subdiv: int = 2, radius: float = 1.0):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        edge_mid = {}
        verts = list(map(tuple, v))
        newf = []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (np.array(verts[a]) + np.array(verts[b])) / 2.0
                m /= np.linalg.norm(m)
                verts.append(tuple(m))
                edge_mid[key] = len(verts) - 1
            return edge_mid[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            newf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.array(verts, np.float64)
        f = np.array(newf, np.int64)
    return (v * radius).astype(np.float32), f.astype(np.int32)
