"""Structure-of-arrays 3-vector math over torch tensors.

Counterpart of ``cudapathtracer_tpu/ops/vecmath.py``: each component is its
own tensor, so every operation is one elementwise op over the batch. The
formulas and their operation order are the JAX package's, so both packages
round alike.

``gather`` clamps its indices, as ``jnp.take(mode="clip")`` does; torch
indexing would raise or read out of bounds instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    """SoA 3-vector: three same-shaped tensors (or scalars)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):  # component-wise (reference color mul)
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    @staticmethod
    def full(shape, vx, vy, vz, device, dtype=torch.float32):
        return Vec3(torch.full(shape, vx, dtype=dtype, device=device),
                    torch.full(shape, vy, dtype=dtype, device=device),
                    torch.full(shape, vz, dtype=dtype, device=device))

    @staticmethod
    def zeros(shape, device, dtype=torch.float32):
        return Vec3(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))

    @property
    def shape(self):
        return self.x.shape

    def map(self, fn):
        """Apply ``fn`` to each component."""
        return Vec3(fn(self.x), fn(self.y), fn(self.z))


def fma(a, b, c):
    """Fused multiply-add a*b + c of float32 tensors, rounded once.

    The product is exact in float64; the sum is formed in float64 rounded to
    odd (a TwoSum error term moves an inexact even result to its odd
    neighbour), which makes the final rounding to float32 the correct one."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    fix = ((err != 0) & ((s.view(torch.int64) & 1) == 0)
           & torch.isfinite(s))
    toward = torch.where(err > 0, torch.inf, -torch.inf).double()
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def fma3(a: Vec3, b, c: Vec3) -> Vec3:
    """Component-wise ``a * b + c`` fused (b: a Vec3 or a tensor)."""
    if isinstance(b, Vec3):
        return Vec3(fma(a.x, b.x, c.x), fma(a.y, b.y, c.y),
                    fma(a.z, b.z, c.z))
    return Vec3(fma(a.x, b, c.x), fma(a.y, b, c.y), fma(a.z, b, c.z))


def dot(a: Vec3, b: Vec3):
    return fma(a.z, b.z, fma(a.x, b.x, a.y * b.y))


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        fma(a.y, b.z, -(a.z * b.y)),
        fma(a.z, b.x, -(a.x * b.z)),
        fma(a.x, b.y, -(a.y * b.x)),
    )


def rsqrt(x):
    """1/sqrt(x) of a float32 tensor, correctly rounded (through float64).

    XLA rewrites the JAX package's ``1 / sqrt(x)`` into its own rsqrt,
    which on the CPU is within one ulp of the correctly rounded value and
    equal to it on most inputs (88% of uniform samples); ``torch.rsqrt`` and
    ``1 / torch.sqrt`` round twice and agree with it less often."""
    return (1.0 / torch.sqrt(x.double())).float()


def length(a: Vec3):
    return torch.sqrt(dot(a, a))


def normalized(a: Vec3) -> Vec3:
    """Plain normalize (vec3.h:71-76): no guard, a zero vector gives inf/nan
    as the reference does."""
    return a * rsqrt(dot(a, a))


def normalized_safe(a: Vec3, eps: float = 1e-20) -> Vec3:
    """Normalize with a zero-length guard (0 for the zero vector)."""
    n2 = dot(a, a)
    ok = n2 > eps
    inv = torch.where(ok, rsqrt(torch.where(ok, n2, 1.0)), 0.0)
    return a * inv


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def take_clip(table, idx):
    """``jnp.take(table, idx, axis=0, mode="clip")``: rows of ``table`` at
    ``idx`` clamped into [0, len - 1]."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


def gather(table: Vec3, idx) -> Vec3:
    """Rows of an SoA table at ``idx``, clamped like ``mode='clip'``."""
    i = idx.clamp(0, table.x.shape[0] - 1).long()
    return Vec3(table.x[i], table.y[i], table.z[i])
