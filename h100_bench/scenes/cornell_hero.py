"""The Cornell box with its hero object as an icosphere mesh that can be
moved and scaled: the shape-fitting scene. At subdiv 3, origin (0.35, 0.6,
0.3) and scale 0.75 it is ``cornell_with_sphere_mesh``'s scene, array for
array."""

from __future__ import annotations

import numpy as np

from h100_bench.meshes import cornell_box, icosphere, transformed

RADIUS = 0.35


def generate(subdiv: int = 3, origin=(0.35, 0.6, 0.3), scale: float = 0.75):
    """Cornell box + an icosphere mesh (radius 0.35, white) at ``origin``
    and ``scale`` (the reference drops its teapot at kernel.cu:592's origin
    and scale). The hero's vertices are the last ones, its faces the last
    20 * 4^subdiv."""
    cb = cornell_box(with_boxes=True)
    sv, sf = icosphere(subdiv, radius=RADIUS)
    sv = transformed(sv, origin=tuple(origin), scale=scale)
    base = len(cb["verts"])
    cb["verts"] = np.concatenate([cb["verts"], sv])
    cb["tris"] = np.concatenate([cb["tris"], sf + base])
    cb["tri_mats"] = np.concatenate(
        [cb["tri_mats"], np.zeros(len(sf), np.int32)])
    return cb
