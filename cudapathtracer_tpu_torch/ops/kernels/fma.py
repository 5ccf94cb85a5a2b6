"""FMA: ``vecmath.fma``'s float32 a*b + c rounded once, as one CUDA kernel.

The CUDA kernel (``csrc/fma.cu``) replaces no Pallas kernel; the note at
the top of its source says why it was added, what bounds it on the card and
what its design does about that.

* ``fma_plain``: the plain version, the float64 emulation that rounds once
  (the exact product, a sum rounded to odd, one rounding to float32). It
  serves CPU tensors, and it is what the CPU tests hold against the JAX
  package. ``calls`` counts its calls.
* ``fma``, the wrapper: the kernel on CUDA float32 tensors, raising if the
  build or the launch fails. An operand is read in place where one element
  stride walks it (``flat_stride``: a tensor of the output's size, or one
  element), or passed by value (a Python number, or a one-element CPU
  tensor), so that a call is one launch; any other broadcast is expanded on
  the card first. ``launches`` counts the launches, ``expanded`` those that
  needed an operand expanded.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import torch

from ...utils.build import PACKAGE_DIR, build_and_load

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "fma.cu")


def fma_plain(a, b, c):
    """a*b + c of float32 tensors rounded once, through float64: the
    product is exact in float64, the sum is rounded to odd (a TwoSum error
    term moves an inexact even result to its odd neighbour), which makes
    the final rounding to float32 the correct one. A Python number ``b`` is
    taken as float32."""
    fma_plain.calls += 1
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    fix = ((err != 0) & ((s.view(torch.int64) & 1) == 0)
           & torch.isfinite(s))
    toward = torch.where(err > 0, torch.inf, -torch.inf).double()
    return torch.where(fix, torch.nextafter(s, toward), s).float()


fma_plain.calls = 0


@functools.cache
def _load_kernel():
    # imported here: dense_resident imports vecmath, which imports this
    from .dense_resident import NVCC_FLAGS

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = build_and_load("libfma.so", [SOURCE], [nvcc] + NVCC_FLAGS)
    fn = lib.fma_launch
    fn.restype = ctypes.c_int
    operand = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float]
    fn.argtypes = operand * 3 + [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_void_p]
    return fn


def build():
    """Build and load the kernel library (it is otherwise built at the
    first launch)."""
    _load_kernel()


def flat_stride(x):
    """The one element stride that walks ``x`` in row-major order (0 for a
    single element), or None where no single stride does."""
    if x.dim() == 1:  # the glue's lanes, in a fifth of the general case's time
        return x.stride(0) if x.shape[0] != 1 else 0
    dims = [(n, s) for n, s in zip(x.shape, x.stride()) if n != 1]
    for (_, s), (n_in, s_in) in zip(dims, dims[1:]):
        if s != s_in * n_in:
            return None
    return dims[-1][1] if dims else 0


def _operand(x, shape, n, device):
    """-> (tensor or None, element stride, value) of one operand of an
    output of ``shape`` (``n`` elements) on ``device``; the tensor is a new
    one where ``x`` had to be expanded."""
    if not isinstance(x, torch.Tensor):
        return None, 0, float(x)
    if x.dtype is not torch.float32:
        raise ValueError(f"fma takes float32 operands, not {x.dtype}")
    size = x.numel()
    if x.device != device:
        if size == 1 and x.device.type == "cpu":
            return None, 0, x.item()
        raise ValueError(f"an fma operand on {x.device}, not {device}")
    if size == n and x.is_contiguous():
        return x, 1, 0.0
    stride = flat_stride(x) if size in (1, n) else None
    if stride is not None:
        return x, stride, 0.0
    return x.expand(shape).contiguous(), 1, 0.0


def _launch(out, ops):
    """Launch the kernel on the current stream of ``out``'s card; raise if
    it fails."""
    args = []
    for t, stride, value in ops:
        args += (None if t is None else t.data_ptr(), stride, value)
    index = out.get_device()
    # the raw handle (as Triton's launcher reads it): a tenth of the host
    # time of torch.cuda.current_stream(index).cuda_stream
    args += (out.data_ptr(), out.numel(),
             torch._C._cuda_getCurrentRawStream(index))
    if index == torch._C._cuda_getDevice():
        err = _load_kernel()(*args)
    else:
        with torch.cuda.device(index):
            err = _load_kernel()(*args)
    if err != 0:
        raise RuntimeError(f"fma kernel launch failed: CUDA error {err}")


def fma(a, b, c):
    """a*b + c of float32 tensors rounded once, by the kernel (``a`` on a
    card); ``b`` may be a Python number, taken as float32."""
    shape = a.shape
    number = not isinstance(b, torch.Tensor)
    if c.shape == shape and (number or b.shape == shape):
        out = torch.empty_like(a, memory_format=torch.contiguous_format)
    else:
        shape = torch.broadcast_shapes(shape, c.shape,
                                       () if number else b.shape)
        out = torch.empty(shape, dtype=torch.float32, device=a.device)
    n = out.numel()
    ops = [_operand(x, shape, n, a.device) for x in (a, b, c)]
    if n:
        _launch(out, ops)
        fma.launches += 1
        fma.expanded += any(t is not None and t is not x
                            for x, (t, _, _) in zip((a, b, c), ops))
    return out


fma.launches = 0
fma.expanded = 0
