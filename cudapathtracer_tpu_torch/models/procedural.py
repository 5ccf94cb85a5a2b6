"""Procedural scene generators.

The reference loads everything from OBJ files in a ``models/`` directory
that is .gitignored and not shipped (kernel.cu:590-599 hard-codes the
paths). We therefore generate equivalent scenes procedurally:

* ``cornell_box``   — the CornellBox-Original geometry (floor/ceiling/back
  white, red left wall, green right wall, two boxes, ceiling area light)
  with the standard albedos, sized to match the reference's hard-coded
  camera at (0, 1, 3) looking down -z (kernel.cu:643-646).
* ``icosphere``     — subdivided icosahedron (stand-in for the teapot-class
  second object the reference drops into the box, kernel.cu:592).
* ``colonnade``     — a sponza-scale stress scene: floor, pillars with
  capitals, clerestory light strips; triangle count is parameterized, used
  for throughput benchmarking (BASELINE.md targets sponza 1024^2).

Generators return host-side dicts; ``to_scene`` assembles a Scene on a
device (the card unless the caller names another) via models/scene.py
(which replicates the reference loader semantics), and ``write_obj`` writes
one as OBJ+MTL for the loader.

The numpy generators are copies of ``cudapathtracer_tpu/models/procedural.py``
(the port cannot import that package: importing it imports JAX), and the
tests hold each copy against its original.
"""

from __future__ import annotations

import numpy as np

from .scene import Scene, make_scene


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


# ---------------------------------------------------------------------------
# Cornell box
# ---------------------------------------------------------------------------

# Standard CornellBox-Original material set (white / red / green / light).
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


# ---------------------------------------------------------------------------
# icosphere (curved "hero object")
# ---------------------------------------------------------------------------

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


def cornell_with_sphere_mesh(subdiv: int = 3):
    """Cornell box + an icosphere mesh where the reference drops its teapot
    (kernel.cu:592: origin (0.35, 0.6, 0.3), scale 0.75)."""
    cb = cornell_box(with_boxes=True)
    sv, sf = icosphere(subdiv, radius=0.35)
    sv = transformed(sv, origin=(0.35, 0.6, 0.3), scale=0.75)
    base = len(cb["verts"])
    cb["verts"] = np.concatenate([cb["verts"], sv])
    cb["tris"] = np.concatenate([cb["tris"], sf + base])
    cb["tri_mats"] = np.concatenate(
        [cb["tri_mats"], np.zeros(len(sf), np.int32)]  # white
    )
    return cb


def cornell_with_analytic_sphere(radius: float = 0.26,
                                 center=(0.35, 0.45, 0.3), *,
                                 device="cuda"):
    """Cornell box + one ANALYTIC sphere primitive (the reference's
    dormant sphere.h capability, revived): returns a Scene directly,
    since analytic spheres live outside the OBJ/triangle pipeline."""
    cb = cornell_box(with_boxes=False)
    return make_scene(
        cb["verts"], cb["tris"], cb["tri_mats"], cb["albedo"],
        cb["emission"], device=device,
        spheres=(
            np.array([center], np.float32),
            np.array([radius], np.float32),
            np.array([0], np.int32),  # white
        ),
    )


# ---------------------------------------------------------------------------
# sponza-scale stress scene
# ---------------------------------------------------------------------------

def colonnade(n_cols: int = 8, n_rows: int = 2, subdiv: int = 3, seed: int = 0):
    """An atrium: floor + walls, two rows of pillars with capitals, spheres
    on pedestals, and ceiling light strips. ``subdiv`` scales triangle count
    (subdiv=3 -> ~40k tris; 4 -> ~160k) to emulate sponza-class BVH load."""
    rng = np.random.default_rng(seed)
    verts, tris, mats = [], [], []
    albedo = np.array(
        [
            [0.73, 0.70, 0.65],  # stone
            [0.45, 0.30, 0.20],  # wood
            [0.60, 0.10, 0.10],  # banner red
            [0.80, 0.80, 0.80],  # light (albedo)
        ],
        np.float32,
    )
    emission = np.zeros((4, 3), np.float32)
    emission[3] = (14.0, 13.0, 11.0)
    STONE, WOOD, RED, LIGHT = 0, 1, 2, 3

    W, H, D = 10.0, 6.0, 4.0 + 2.0 * n_rows

    def add_mesh(v, f, m):
        base = len(verts)
        verts.extend(np.asarray(v, np.float32).tolist())
        tris.extend((np.asarray(f, np.int64) + base).tolist())
        mats.extend([m] * len(f))

    # shell (inward-facing box)
    v, f = box_mesh((-W / 2, 0, -D / 2), (W / 2, H, D / 2), inward=True)
    add_mesh(v, f, STONE)

    # pillars
    xs = np.linspace(-W / 2 + 1.5, W / 2 - 1.5, n_cols)
    zs = np.linspace(-D / 2 + 1.5, D / 2 - 1.5, n_rows + 2)[1:-1]
    sphere_v, sphere_f = icosphere(subdiv, 1.0)
    for x in xs:
        for z in zs:
            # shaft
            v, f = box_mesh((x - 0.25, 0, z - 0.25), (x + 0.25, H - 1.2, z + 0.25))
            add_mesh(v, f, STONE)
            # capital
            v, f = box_mesh(
                (x - 0.4, H - 1.2, z - 0.4), (x + 0.4, H - 0.9, z + 0.4)
            )
            add_mesh(v, f, WOOD)
            # sphere ornament (the subdiv knob lives here)
            sv = sphere_v * 0.35 + np.array([x, H - 0.45, z], np.float32)
            add_mesh(sv, sphere_f, RED if rng.random() < 0.3 else STONE)

    # hanging light strips, downward-facing (normal (0,-1,0) — the pt_nee
    # 'fixed' light-normal quirk assumes it, kernel.cu:503). They hang BELOW
    # the capital/ornament canopy (y = H-1.5 < capitals at H-1.2) so the
    # floor actually receives light — at ceiling height the canopy occludes
    # nearly every shadow ray and the render is black.
    n_strips = max(2, n_cols // 2)
    for i in range(n_strips):
        x0 = -W / 2 + (i + 0.5) * W / n_strips - 0.6
        base = len(verts)
        y = H - 1.5
        verts.extend(
            [
                (x0, y, -D / 4), (x0 + 1.2, y, -D / 4),
                (x0 + 1.2, y, D / 4), (x0, y, D / 4),
            ]
        )
        # winding (0,1,2)/(0,2,3) gives cross(v1-v0, v2-v0) ~ -y
        tris.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
        mats.extend([LIGHT, LIGHT])

    return dict(
        verts=np.array(verts, np.float32),
        tris=np.array(tris, np.int32),
        tri_mats=np.array(mats, np.int32),
        albedo=albedo,
        emission=emission,
        mat_names=["stone", "wood", "red", "light"],
    )


def to_scene(desc, device="cuda") -> Scene:
    return make_scene(
        desc["verts"], desc["tris"], desc["tri_mats"], desc["albedo"],
        desc["emission"], device=device,
    )


# ---------------------------------------------------------------------------
# OBJ/MTL writer (round-trip fixture for the loaders)
# ---------------------------------------------------------------------------

def write_obj(path_obj, path_mtl, desc):
    """Write a scene dict as OBJ+MTL, grouping faces by material (one
    usemtl block per material, the layout the reference's tinyobj pipeline
    consumes; JAX ``procedural.py:write_obj``). The faces are written in a
    stable sort by material."""
    import os

    mat_names = desc["mat_names"]
    with open(path_mtl, "w") as f:
        for i, name in enumerate(mat_names):
            f.write(f"newmtl {name}\n")
            a = desc["albedo"][i]
            e = desc["emission"][i]
            f.write(f"Kd {a[0]} {a[1]} {a[2]}\n")
            f.write(f"Ke {e[0]} {e[1]} {e[2]}\n\n")
    with open(path_obj, "w") as f:
        f.write(f"mtllib {os.path.basename(path_mtl)}\n")
        for v in desc["verts"]:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        order = np.argsort(desc["tri_mats"], kind="stable")
        cur = -1
        for ti in order:
            m = int(desc["tri_mats"][ti])
            if m != cur:
                f.write(f"usemtl {mat_names[m]}\n")
                cur = m
            a, b, c = (int(x) + 1 for x in desc["tris"][ti])
            f.write(f"f {a} {b} {c}\n")
