"""Minimal SI dimensional analysis — the SIUnits.h port (SURVEY.md §2.1 #6).

The reference carries a compile-time unit system (`siUnits<len,mass,time,sr>`
with unit-propagating operators, SIUnits.h:27-67, aliases SIUnits.h:69-90)
whose single live use is typing the light-sampling area:
``siArea totalLightArea`` (kernel.cu:422; raw value read at kernel.cu:468).

Python has no compile-time templates, so the equivalent boundary is HOST
scene assembly: quantities that cross into device arrays are checked there
and stripped to raw floats (device arrays stay untyped f32 — wrapping every
jnp array would break pytree flattening and buy nothing, since XLA erases
types anyway; ledgered in SURVEY.md §7).

``Quantity`` propagates dimensions through * / + - exactly like the
reference's operator templates: multiplication adds exponent vectors,
division subtracts, addition/subtraction require equal dimensions
(SIUnits.h:37-58 semantics).
"""

from __future__ import annotations

from dataclasses import dataclass

# dimension exponent order: (length, mass, time, steradian) — SIUnits.h:27
DIMLESS = (0, 0, 0, 0)
LENGTH = (1, 0, 0, 0)
AREA = (2, 0, 0, 0)          # siArea (SIUnits.h:69-72)
SOLID_ANGLE = (0, 0, 0, 1)
# siRadiance = power / (area * sr); power = mass * len^2 / time^3
RADIANCE = (0, 1, -3, -1)    # SIUnits.h:83-90


@dataclass(frozen=True)
class Quantity:
    """A float with SI dimension exponents (len, mass, time, sr)."""

    raw: float
    dim: tuple = DIMLESS

    def _require(self, other: "Quantity", op: str):
        if self.dim != other.dim:
            raise TypeError(
                f"SI dimension mismatch in {op}: {self.dim} vs {other.dim}"
            )

    def __add__(self, other: "Quantity") -> "Quantity":
        self._require(other, "+")
        return Quantity(self.raw + other.raw, self.dim)

    def __sub__(self, other: "Quantity") -> "Quantity":
        self._require(other, "-")
        return Quantity(self.raw - other.raw, self.dim)

    def __mul__(self, other):
        if isinstance(other, Quantity):
            dim = tuple(a + b for a, b in zip(self.dim, other.dim))
            return Quantity(self.raw * other.raw, dim)
        return Quantity(self.raw * other, self.dim)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            dim = tuple(a - b for a, b in zip(self.dim, other.dim))
            return Quantity(self.raw / other.raw, dim)
        return Quantity(self.raw / other, self.dim)


def si_area(value: float) -> Quantity:
    """``siArea`` (SIUnits.h:69-72; the kernel.cu:422 type)."""
    return Quantity(float(value), AREA)


def check_area(q: Quantity) -> float:
    """Assert area dimension and strip to raw f32 — the device boundary
    (the reference reads ``.raw`` at kernel.cu:468)."""
    if q.dim != AREA:
        raise TypeError(f"expected siArea {AREA}, got dimensions {q.dim}")
    return q.raw
