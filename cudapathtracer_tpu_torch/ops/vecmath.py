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

from .kernels import fma as fma_kernel


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


def _fma_rounded(a, b, c):
    """a*b + c of float32 tensors, rounded once (see ``fma``): the CUDA
    kernel for ``a`` on a card, its plain version (the float64 emulation)
    elsewhere."""
    if a.dtype == torch.float64:
        # float64 operands (``gradcheck``): no float32 rounding to emulate
        return a * b + c
    if a.is_cuda:
        return fma_kernel.fma(a, b, c)
    return fma_kernel.fma_plain(a, b, c)


def _cotangent(g, other, shape):
    """``g * other`` (``g`` alone for ``other`` None) summed down to an
    operand's broadcast ``shape``. A float32 sum is formed in float64 and
    rounded once, as autograd through the float64 emulation formed it."""
    prod = g if other is None else g * other
    if prod.shape == shape:
        return prod
    if g.dtype != torch.float32:
        return prod.sum_to_size(shape)
    wide = g.double() if other is None else g.double() * other.double()
    return wide.sum_to_size(shape).float()


class _FMA(torch.autograd.Function):
    """``_fma_rounded`` with the product rule as its backward: (g*b, g*a, g)
    in float32, each reduced to its operand's shape. It saves only a and b,
    where autograd through the emulation saves its float64 intermediates
    and builds about ten backward nodes."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.c_shape = c.shape
        return _fma_rounded(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need_a, need_b, need_c = ctx.needs_input_grad
        return (_cotangent(g, b, a.shape) if need_a else None,
                _cotangent(g, a, b.shape) if need_b else None,
                _cotangent(g, None, ctx.c_shape) if need_c else None)


def fma(a, b, c):
    """Fused multiply-add a*b + c of float32 tensors, rounded once: one
    ``__fmaf_rn`` kernel on a card, on the CPU its plain version, which
    forms the sum in float64 rounded to odd (``kernels/fma.py``). A Python
    number ``b`` is taken as float32, as JAX takes it; the kernel takes it
    by value. Under autograd it is one ``torch.autograd.Function``
    (``_FMA``)."""
    if torch.is_grad_enabled() and (
            a.requires_grad or c.requires_grad
            or (torch.is_tensor(b) and b.requires_grad)):
        if not torch.is_tensor(b):
            b = torch.tensor(b, dtype=a.dtype, device=a.device)
        return _FMA.apply(a, b, c)
    return _fma_rounded(a, b, c)


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


def sqrt(x):
    """sqrt of a float32 tensor, correctly rounded (through float64), as
    XLA's and CUDA's are: torch's float32 sqrt on the CPU is not (on an
    AVX-512 CPU it differs in the last bit on about 20% of inputs)."""
    return torch.sqrt(x.double()).float()


def cos(x):
    """cos of a float32 tensor, correctly rounded (through float64), on
    every device alike. XLA's float32 cos on the CPU agrees with it on about
    99% of inputs, torch's float32 cos on the CPU on about 95%."""
    return torch.cos(x.double()).float()


def sin(x):
    """sin of a float32 tensor, correctly rounded (through float64), as
    ``cos``."""
    return torch.sin(x.double()).float()


def length_sq(a: Vec3):
    return dot(a, a)


def length(a: Vec3):
    return sqrt(dot(a, a))


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


def div(num, den):
    """``num / den`` rounded once, also for a Python number ``num``: torch
    computes ``number / tensor`` as a reciprocal times the number, which
    rounds twice."""
    if not torch.is_tensor(num):
        num = torch.tensor(num, dtype=den.dtype, device=den.device)
    return num / den


def safe_div(num, den, eps: float = 0.0):
    """``num / den``, and 0 where ``|den| <= eps``."""
    ok = torch.abs(den) > eps
    return torch.where(ok, div(num, torch.where(ok, den, 1.0)), 0.0)


def safe_length(a: Vec3, eps: float = 0.0):
    """sqrt(|a|^2), and 0 where |a|^2 <= eps."""
    n2 = dot(a, a)
    ok = n2 > eps
    return torch.where(ok, sqrt(torch.where(ok, n2, 1.0)), 0.0)


def max_component(a: Vec3):
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.minimum(a.x, b.x), torch.minimum(a.y, b.y),
                torch.minimum(a.z, b.z))


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.maximum(a.x, b.x), torch.maximum(a.y, b.y),
                torch.maximum(a.z, b.z))


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


def stop_gradient(x):
    """``jax.lax.stop_gradient`` over a tensor or a (named) tuple of them,
    nested: every tensor detached, every other leaf (ints, numpy arrays,
    None) as it is."""
    if torch.is_tensor(x):
        return x.detach()
    if isinstance(x, tuple):
        parts = [stop_gradient(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x
