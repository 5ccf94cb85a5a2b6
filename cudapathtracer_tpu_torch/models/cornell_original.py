"""Reconstruction of the reference's live scene: CornellBox-Original.

The reference renders ``models/CornellBox-Original.obj`` (kernel.cu:591) but
.gitignores the models directory, so the OBJ itself is not shipped. The
file is, however, standard published data: the Cornell box scene from the
Williams College graphics archive (Guedis Cardenas & Morgan McGuire, 2011,
public domain; derived from the original Cornell program of Computer
Graphics measurements at graphics.cornell.edu/online/box/data.html). The
geometry and materials below are that published data set, reproduced so
renders can be compared against the reference's blessed artifacts
(cornell-original.ppm, BDPT-FirstAttempt.ppm).

The port's copy of ``cudapathtracer_tpu/models/cornell_original.py``: the
same OBJ and MTL text (tests/test_torch_scene_io.py holds it byte for
byte), with the scene and camera made on a ``device``.

The scene is materialized as OBJ/MTL text and loaded through the real
loader (models/loader.load_obj), so every reference loader semantic — fan
triangulation, winding-order face normals, emissive detection via
``emission.r != 0``, light-area accumulation (modelLoader.h:162-206) — is
exercised, not bypassed.

Live camera (kernel.cu:643-648): pos (0,1,3), distFromFilm 1,
focalLength 3, radius 0 (pinhole), 512x512.
"""

from __future__ import annotations

import os
import tempfile

CORNELL_ORIGINAL_OBJ = """\
# The original Cornell Box in OBJ format.
# Standard published data (Cardenas & McGuire, Williams College, 2011,
# public domain), after graphics.cornell.edu/online/box/data.html.
mtllib CornellBox-Original.mtl

## Object floor
v  -1.01  0.00   0.99
v   1.00  0.00   0.99
v   1.00  0.00  -1.04
v  -0.99  0.00  -1.04
g floor
usemtl floor
f -4 -3 -2 -1

## Object ceiling
v  -1.02  1.99   0.99
v  -1.02  1.99  -1.04
v   1.00  1.99  -1.04
v   1.00  1.99   0.99
g ceiling
usemtl ceiling
f -4 -3 -2 -1

## Object backwall
v  -0.99  0.00  -1.04
v   1.00  0.00  -1.04
v   1.00  1.99  -1.04
v  -1.02  1.99  -1.04
g backWall
usemtl backWall
f -4 -3 -2 -1

## Object rightwall
v   1.00  0.00  -1.04
v   1.00  0.00   0.99
v   1.00  1.99   0.99
v   1.00  1.99  -1.04
g rightWall
usemtl rightWall
f -4 -3 -2 -1

## Object leftwall
v  -1.01  0.00   0.99
v  -0.99  0.00  -1.04
v  -1.02  1.99  -1.04
v  -1.02  1.99   0.99
g leftWall
usemtl leftWall
f -4 -3 -2 -1

## Object shortBox
v   0.53  0.60   0.75
v   0.70  0.60   0.17
v   0.13  0.60   0.00
v  -0.05  0.60   0.57
v  -0.05  0.00   0.57
v  -0.05  0.60   0.57
v   0.13  0.60   0.00
v   0.13  0.00   0.00
v   0.53  0.00   0.75
v   0.53  0.60   0.75
v  -0.05  0.60   0.57
v  -0.05  0.00   0.57
v   0.70  0.00   0.17
v   0.70  0.60   0.17
v   0.53  0.60   0.75
v   0.53  0.00   0.75
v   0.13  0.00   0.00
v   0.13  0.60   0.00
v   0.70  0.60   0.17
v   0.70  0.00   0.17
g shortBox
usemtl shortBox
f -20 -19 -18 -17
f -16 -15 -14 -13
f -12 -11 -10 -9
f -8 -7 -6 -5
f -4 -3 -2 -1

## Object tallBox
v  -0.53  1.20   0.09
v   0.04  1.20   0.18
v   0.14  1.20  -0.39
v  -0.44  1.20  -0.48
v  -0.53  0.00   0.09
v  -0.53  1.20   0.09
v  -0.44  1.20  -0.48
v  -0.44  0.00  -0.48
v  -0.53  0.00   0.09
v   0.04  0.00   0.18
v   0.04  1.20   0.18
v  -0.53  1.20   0.09
v   0.04  0.00   0.18
v   0.14  0.00  -0.39
v   0.14  1.20  -0.39
v   0.04  1.20   0.18
v   0.14  0.00  -0.39
v  -0.44  0.00  -0.48
v  -0.44  1.20  -0.48
v   0.14  1.20  -0.39
g tallBox
usemtl tallBox
f -20 -19 -18 -17
f -16 -15 -14 -13
f -12 -11 -10 -9
f -8 -7 -6 -5
f -4 -3 -2 -1

## Object light
v  -0.24  1.98   0.16
v  -0.24  1.98  -0.22
v   0.23  1.98  -0.22
v   0.23  1.98   0.16
g light
usemtl light
f -4 -3 -2 -1
"""

CORNELL_ORIGINAL_MTL = """\
# Standard CornellBox-Original materials (measured Cornell box albedos).
newmtl leftWall
Ns 10.0000
Ni 1.5000
illum 2
Ka 0.63 0.065 0.05
Kd 0.63 0.065 0.05
Ks 0 0 0
Ke 0 0 0

newmtl rightWall
Ns 10.0000
Ni 1.5000
illum 2
Ka 0.14 0.45 0.091
Kd 0.14 0.45 0.091
Ks 0 0 0
Ke 0 0 0

newmtl floor
Ns 10.0000
Ni 1.0000
illum 2
Ka 0.725 0.71 0.68
Kd 0.725 0.71 0.68
Ks 0 0 0
Ke 0 0 0

newmtl ceiling
Ns 10.0000
Ni 1.0000
illum 2
Ka 0.725 0.71 0.68
Kd 0.725 0.71 0.68
Ks 0 0 0
Ke 0 0 0

newmtl backWall
Ns 10.0000
Ni 1.0000
illum 2
Ka 0.725 0.71 0.68
Kd 0.725 0.71 0.68
Ks 0 0 0
Ke 0 0 0

newmtl shortBox
Ns 10.0000
Ni 1.0000
illum 2
Ka 0.725 0.71 0.68
Kd 0.725 0.71 0.68
Ks 0 0 0
Ke 0 0 0

newmtl tallBox
Ns 10.0000
Ni 1.0000
illum 2
Ka 0.725 0.71 0.68
Kd 0.725 0.71 0.68
Ks 0 0 0
Ke 0 0 0

newmtl light
Ns 10.0000
Ni 1.0000
illum 2
Ka 0.78 0.78 0.78
Kd 0.78 0.78 0.78
Ks 0 0 0
Ke 17 12 4
"""


def write_cornell_original(dirpath) -> str:
    """Write the OBJ/MTL pair into ``dirpath``; returns the OBJ path."""
    obj_path = os.path.join(dirpath, "CornellBox-Original.obj")
    with open(obj_path, "w") as f:
        f.write(CORNELL_ORIGINAL_OBJ)
    with open(os.path.join(dirpath, "CornellBox-Original.mtl"), "w") as f:
        f.write(CORNELL_ORIGINAL_MTL)
    return obj_path


def cornell_original_scene(use_native: bool = True, *, device="cuda"):
    """The reference's live scene, loaded through the real OBJ pipeline
    onto ``device``."""
    from .loader import load_obj

    with tempfile.TemporaryDirectory() as d:
        return load_obj(write_cornell_original(d), use_native=use_native,
                        device=device)


def reference_camera(width: int = 512, height: int = 512, *,
                     device="cuda"):
    """The hard-coded live camera (kernel.cu:643-648) on ``device``."""
    from ..render.camera import make_camera

    return make_camera(pos=(0.0, 1.0, 3.0), dist_from_film=1.0,
                       focal_length=3.0, radius=0.0,
                       width=width, height=height, device=device)
