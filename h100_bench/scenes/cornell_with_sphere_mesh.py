"""The Cornell box with the reference's hero object as an icosphere mesh: a
frozen copy of the project's ``procedural.cornell_with_sphere_mesh``."""

from __future__ import annotations

import numpy as np

from h100_bench.meshes import cornell_box, icosphere, transformed


def generate(subdiv: int = 3):
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
