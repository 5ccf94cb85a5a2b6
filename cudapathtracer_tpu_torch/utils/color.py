"""Color pipeline: Reinhard tonemap, gamma, truncating 8-bit quantize.

Counterpart of ``cudapathtracer_tpu/utils/color.py`` (reference:
color.h:59-71, kernel.cu:774-775): ``c -> (c / (c + 1)) ** (1/2.2)``, then
``(int)(c * 255)``, which truncates.
"""

from __future__ import annotations

import torch

from ..ops.vecmath import Vec3


def tonemap_reinhard(c: Vec3) -> Vec3:
    """color.h:59-62 ``normalized``: c / (c + 1)."""
    return Vec3(c.x / (c.x + 1.0), c.y / (c.y + 1.0), c.z / (c.z + 1.0))


def tonemap_reinhard_inverse(c: Vec3) -> Vec3:
    """color.h:63-66 ``denormalized``: c / (1 - c)."""
    return Vec3(c.x / (1.0 - c.x), c.y / (1.0 - c.y), c.z / (1.0 - c.z))


def gamma_correct(c: Vec3, a: float) -> Vec3:
    """color.h:68-71 ``gammaCorrect``: c ** a (a = 1/2.2 at the call site)."""
    return Vec3(torch.pow(c.x, a), torch.pow(c.y, a), torch.pow(c.z, a))


def finalize(c: Vec3, gamma: float = 1.0 / 2.2) -> Vec3:
    """Full output transform: Reinhard then gamma (kernel.cu:774)."""
    return gamma_correct(tonemap_reinhard(c), gamma)


def quantize_u8(c: Vec3):
    """Truncating 8-bit quantization (kernel.cu:775) -> (..., 3) uint8."""
    def q(ch):
        return torch.clamp(ch * 255.0, 0.0, 255.0).to(torch.uint8)

    return torch.stack([q(c.x), q(c.y), q(c.z)], dim=-1)
