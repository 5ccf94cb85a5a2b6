"""The port's fused multiply-add under autograd (ops/vecmath.py:fma).

``fma`` is one ``torch.autograd.Function``: its forward is the float64
emulation that rounds once, its backward the product rule in float32. These
tests hold it to the emulation it replaced under autograd: the same values
bit for bit, and the same gradients bit for bit (b, a and 1 times the
cotangent, and their sums in float64 rounded once where an operand
broadcasts). ``gradcheck`` checks the backward in float64, where the
forward is a plain a * b + c."""

import pytest
import torch

from cudapathtracer_tpu_torch.ops import vecmath
from cudapathtracer_tpu_torch.ops.vecmath import Vec3, fma, stop_gradient

N = 100_000


def emulated_fma(a, b, c):
    """The emulation as it stood before it became a Function, run through
    autograd op by op."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    fix = ((err != 0) & ((s.view(torch.int64) & 1) == 0)
           & torch.isfinite(s))
    toward = torch.where(err > 0, torch.inf, -torch.inf).double()
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def _operands(b_shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(N, generator=g) * 3.0
    b = torch.randn(b_shape or (), generator=g)
    c = torch.randn(N, generator=g)
    return a, b, c


@pytest.mark.parametrize("b_shape", [(N,), (1,), ()],
                         ids=["full", "broadcast1", "scalar"])
def test_fma_function_matches_emulation_bitwise(b_shape):
    a, b, c = _operands(b_shape)
    got_in = [t.clone().requires_grad_() for t in (a, b, c)]
    want_in = [t.clone().requires_grad_() for t in (a, b, c)]
    got = fma(*got_in)
    want = emulated_fma(*want_in)
    assert torch.equal(got, want)
    assert type(got.grad_fn).__name__ == "_FMABackward"
    g = torch.randn(N, generator=torch.Generator().manual_seed(1))
    for gg, gw in zip(torch.autograd.grad(got, got_in, g),
                      torch.autograd.grad(want, want_in, g)):
        assert gg.shape == gw.shape
        assert torch.equal(gg, gw)


def test_fma_gradients_are_the_product_rule():
    a, b, c = (t.requires_grad_() for t in _operands((N,), seed=3))
    ga, gb, gc = torch.autograd.grad(fma(a, b, c).sum(), (a, b, c))
    assert torch.equal(ga, b.detach())
    assert torch.equal(gb, a.detach())
    assert torch.equal(gc, torch.ones(N))


def test_fma_gradcheck_float64():
    g = torch.Generator().manual_seed(2)
    a, b, c = (torch.randn(6, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(fma, (a, b, c))
    s = torch.randn((), generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(fma, (a, s, c))


def test_fma_without_grad_builds_no_node():
    a, b, c = _operands((N,))
    assert fma(a, b, c).grad_fn is None
    with torch.no_grad():
        assert fma(a.requires_grad_(), b, c).grad_fn is None


def test_dot_and_cross_backward_through_fma():
    """The vector forms built on fma differentiate like their plain
    float64 formulas (to float32 rounding)."""
    g = torch.Generator().manual_seed(4)
    u = Vec3(*(torch.randn(64, generator=g).requires_grad_()
               for _ in range(3)))
    v = Vec3(*(torch.randn(64, generator=g) for _ in range(3)))
    w = vecmath.cross(u, v)
    loss = vecmath.dot(w, v).sum() + vecmath.dot(u, u).sum()
    grads = torch.autograd.grad(loss, list(u))
    u64 = [c.detach().double().requires_grad_() for c in u]
    v64 = [c.double() for c in v]
    w64 = torch.linalg.cross(torch.stack(u64, 1), torch.stack(v64, 1))
    loss64 = (w64 * torch.stack(v64, 1)).sum() + sum((c * c).sum()
                                                      for c in u64)
    for gg, gw in zip(grads, torch.autograd.grad(loss64, u64)):
        torch.testing.assert_close(gg.double(), gw, rtol=1e-5, atol=1e-5)


def test_stop_gradient_detaches_nested_tuples():
    x = torch.ones(3, requires_grad=True)
    tree = (Vec3(x * 2, x, x), (x,), 4, None)
    out = stop_gradient(tree)
    assert isinstance(out[0], Vec3)
    assert not any(c.requires_grad for c in (*out[0], *out[1]))
    assert out[2] == 4 and out[3] is None
