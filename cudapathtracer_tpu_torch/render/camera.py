"""Thin-lens camera with Morton pixel ordering (reference: camera.h).

Counterpart of ``cudapathtracer_tpu/render/camera.py``: film mapping
x/W - 0.5 with no half-pixel centering, lens sample r = radius*sqrt(u1),
theta = 2*pi*u2, direction normalize(film*(-focal/dist) - lens_o), origin
pos + lens_o (camera.h:36-43, 77-97). The camera's scalars are 0-d float32
tensors on the camera's device, so the arithmetic rounds as in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.rng import Sites, uniform_site
from ..ops.vecmath import Vec3, cos, normalized, sin, sqrt
from ..utils.constants import PI_REF
from ..utils.morton import morton_decode


class Camera(NamedTuple):
    pos: Vec3                    # 0-d components
    dist_from_film: torch.Tensor
    focal_length: torch.Tensor
    radius: torch.Tensor         # aperture; 0 = pinhole (kernel.cu:646)
    width: int
    height: int


def make_camera(pos=(0.0, 1.0, 3.0), dist_from_film=1.0, focal_length=3.0,
                radius=0.0, width=512, height=512, *,
                device="cuda") -> Camera:
    """Defaults = the reference's hard-coded camera (kernel.cu:643-648)."""
    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return Camera(pos=Vec3(*(f(p) for p in pos)),
                  dist_from_film=f(dist_from_film),
                  focal_length=f(focal_length), radius=f(radius),
                  width=width, height=height)


def camera_rays(cam: Camera, idx, keys, jitter: bool = False,
                lens: bool = True):
    """Primary rays for Morton indices ``idx`` (R,), with per-pixel keys
    (R, 2). ``lens=False`` is the pinhole path (valid only for radius 0)."""
    x, y = morton_decode(idx)
    fx = x.to(torch.float32) / cam.width - 0.5
    fy = y.to(torch.float32) / cam.height - 0.5
    if jitter:
        jx = uniform_site(keys, Sites.PIXEL_JITTER_X)
        jy = uniform_site(keys, Sites.PIXEL_JITTER_Y)
        fx = fx + jx / cam.width
        fy = fy + jy / cam.height

    if lens:
        u1 = uniform_site(keys, Sites.LENS_U1)
        u2 = uniform_site(keys, Sites.LENS_U2)
        r = cam.radius * sqrt(u1)
        theta = 2.0 * PI_REF * u2
        lens_o = Vec3(r * cos(theta), r * sin(theta),
                      torch.zeros_like(r))
    else:
        z = torch.zeros_like(fx)
        lens_o = Vec3(z, z, z)

    scale = -cam.focal_length / cam.dist_from_film
    film = Vec3(fx * scale, fy * scale, cam.dist_from_film * scale)

    o = lens_o + cam.pos
    d = normalized(film - lens_o)
    return o, d
