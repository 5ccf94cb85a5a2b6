"""Threefry-2x32: each call of ``ops/rng.py`` as one CUDA kernel.

The CUDA kernel (``csrc/threefry.cu``) replaces no Pallas kernel; the note
at the top of its source says why it was added, what bounds it on the card
and what its design does about that.

* ``threefry_plain``: the plain version, the hash in int64 tensors masked
  to 32 bits. It serves CPU tensors, and it is what the CPU tests hold
  against ``jax.random``. ``calls`` counts its calls.
* ``threefry``, the wrapper: one launch of the kernel for a whole call of
  ``rng.py`` on CUDA keys, raising if the build or the launch fails. Keys
  (int64, (..., 2)) are read in place through one lane stride and one word
  stride (``flat_stride``; 0 for one key expanded to every lane), a fold
  word through its own stride or by value (a Python int, or a one-element
  CPU tensor). ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from typing import NamedTuple

import numpy as np
import torch

from ...utils.build import PACKAGE_DIR, build_and_load
from .fma import flat_stride

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "threefry.cu")

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
MAX_FOLDS = 2

# what a hash writes: the float (y0 ^ y1) >> 9 | 0x3F800000 less 1, 1 less
# that, the key pair (y0, y1), or y0 ^ y1 (the kernel's Kind)
UNIFORM, ONE_MINUS_UNIFORM, PAIR, XOR = range(4)


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry_plain(k0, k1, x0, x1):
    """20-round Threefry-2x32 on broadcastable int64 tensors holding uint32
    values (Salmon et al. 2011; the schedule of jax.random's threefry)."""
    threefry_plain.calls += 1
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


threefry_plain.calls = 0


@functools.cache
def _load_kernel():
    # imported here: dense_resident imports vecmath, which imports fma
    from .dense_resident import NVCC_FLAGS

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = build_and_load("libthreefry.so", [SOURCE], [nvcc] + NVCC_FLAGS)
    fn = lib.threefry_launch
    fn.restype = ctypes.c_int
    ll, word = ctypes.c_longlong, [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_uint]
    fn.argtypes = ([ctypes.c_void_p, ll, ll, ctypes.c_int] + word * 3
                   + [ctypes.c_int, ll, ll, ll, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p])
    return fn


def build():
    """Build and load the kernel library (it is otherwise built at the
    first launch)."""
    _load_kernel()


class Word(NamedTuple):
    """A word of every lane: ``tensor[r * stride]`` (int64, its low 32
    bits), or ``value`` where ``tensor`` is None."""
    tensor: torch.Tensor | None
    stride: int
    value: int


class Call(NamedTuple):
    """One launch: ``lanes`` keys at ``key`` (word 0 of lane r at element r
    * key_stride, word 1 word_stride further), the ``folds`` words folded in
    first, then the counters (0, i), i < n, where ``last`` is None, else the
    one word ``last``; written as ``kind`` says, (n, lanes) where
    ``by_counter``, else (lanes, n); ``per`` counters a thread."""
    key: torch.Tensor
    key_stride: int
    word_stride: int
    folds: tuple
    last: Word | None
    lanes: int
    n: int
    per: int
    kind: int
    by_counter: bool


def _word(x, batch, device):
    """-> Word of a fold word (a Python int, or an integer tensor
    broadcastable to the lanes' ``batch`` shape) for lanes on ``device``."""
    if not isinstance(x, torch.Tensor):
        return Word(None, 0, int(x) & MASK)
    if x.dtype.is_floating_point or x.dtype.is_complex:
        raise ValueError(f"an RNG word is an integer, not {x.dtype}")
    if x.device != device:
        if x.numel() == 1 and x.device.type == "cpu":
            return Word(None, 0, int(x.item()) & MASK)
        raise ValueError(f"an RNG operand on {x.device}, not {device}")
    x = x.to(torch.int64)
    if x.shape != batch:
        x = x.expand(batch)
    stride = flat_stride(x)
    if stride is None:
        x, stride = x.contiguous(), 1
    return Word(x, stride, 0)


def _launch(out, call):
    """Launch the kernel on the current stream of ``out``'s card; raise if
    it fails."""
    folds = list(call.folds) + [Word(None, 0, 0)] * (MAX_FOLDS
                                                      - len(call.folds))
    last = call.last or Word(None, 0, 0)
    args = [call.key.data_ptr(), call.key_stride, call.word_stride,
            len(call.folds)]
    for t, stride, value in folds + [last]:
        args += (None if t is None else t.data_ptr(), stride, value)
    index = out.get_device()
    # the raw handle (as Triton's launcher reads it): a tenth of the host
    # time of torch.cuda.current_stream(index).cuda_stream
    args += (call.last is None, call.lanes, call.n, call.per, call.kind,
             call.by_counter, out.data_ptr(),
             torch._C._cuda_getCurrentRawStream(index))
    if index == torch._C._cuda_getDevice():
        err = _load_kernel()(*args)
    else:
        with torch.cuda.device(index):
            err = _load_kernel()(*args)
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")


def threefry(keys, folds=(), last=None, n=1, kind=PAIR, by_counter=False):
    """One call of ``rng.py`` as one launch, for int64 ``keys`` (..., 2):
    fold each of ``folds`` (ints or integer tensors broadcastable to the
    batch ``keys.shape[:-1]``) into every key, then hash the counters
    (0, i), i < n, where ``last`` is None, else the one word ``last``.
    -> ``kind``'s values, batch + (n,) (``by_counter``: (n,) + batch;
    without counters: batch), + (2,) for ``PAIR``; UNIFORM and
    ONE_MINUS_UNIFORM float32, PAIR and XOR int64."""
    if keys.dtype is not torch.int64 or keys.dim() < 1 or \
            keys.shape[-1] != 2:
        raise ValueError(f"threefry takes int64 keys of shape (..., 2), not "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if len(folds) > MAX_FOLDS:
        raise ValueError(f"at most {MAX_FOLDS} fold words, not {len(folds)}")
    device = keys.device
    batch = keys.shape[:-1]
    for x in (*folds, last):
        if isinstance(x, torch.Tensor) and x.shape != batch:
            # numpy's: torch.broadcast_shapes imports sympy at its first
            # call, seconds of a process's set-up
            batch = torch.Size(np.broadcast_shapes(batch, x.shape))
    fold_words = tuple(_word(x, batch, device) for x in folds)
    last_word = None if last is None else _word(last, batch, device)
    kview = keys if keys.shape[:-1] == batch else keys.expand(*batch, 2)
    key_stride = flat_stride(kview[..., 0])
    if key_stride is None:
        kview = kview.contiguous()
        key_stride = 2
    lanes = batch.numel()
    if last is not None:
        n = 1
    shape = ((n, *batch) if by_counter else (*batch, n)) if last is None \
        else tuple(batch)
    if kind == PAIR:
        shape += (2,)
    dtype = torch.float32 if kind in (UNIFORM, ONE_MINUS_UNIFORM) \
        else torch.int64
    out = torch.empty(shape, dtype=dtype, device=device)
    if lanes and n:
        # a call that folds hashes a lane's fold chain once, then its n
        # counters; one that does not takes one counter a thread
        per = n if fold_words else 1
        _launch(out, Call(kview, key_stride, kview.stride(-1), fold_words,
                          last_word, lanes, n, per, kind, by_counter))
        threefry.launches += 1
    return out


threefry.launches = 0
