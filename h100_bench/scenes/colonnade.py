"""The colonnade stress scene: a frozen copy of the project's
``procedural.colonnade``."""

from __future__ import annotations

import numpy as np

from h100_bench.meshes import box_mesh, icosphere


def generate(n_cols: int = 8, n_rows: int = 2, subdiv: int = 3, seed: int = 0):
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
