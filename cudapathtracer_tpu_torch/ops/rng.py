"""Counter-based RNG: threefry2x32, bit-exact with ``jax.random``.

Counterpart of ``cudapathtracer_tpu/ops/rng.py``. Every draw is a pure
function of (seed, sample index, pixel index, draw site [, bounce]), so the
port draws the very bits the JAX package draws, pixel for pixel, and the two
packages' renders can be compared per pixel instead of by statistics. A
``torch.Generator`` cannot reproduce those bits.

The bits follow ``jax.random`` with 64-bit mode off and
``jax_threefry_partitionable=True`` (JAX's default):

* a key is two uint32 words; ``PRNGKey(seed)`` is ``(0, seed)``;
* ``fold_in(key, data)`` is ``threefry2x32(key, (0, data))``;
* ``uniform(key, (n,))`` hashes the counters ``(0, i)``, xors the two output
  words, keeps the top 23 bits as a mantissa in [1, 2) and subtracts 1.

Keys are int64 tensors of shape (..., 2). On CUDA keys each call below is
one launch of a CUDA kernel (``kernels/threefry.py``); on CPU keys the
uint32 arithmetic runs in int64 masked with 0xFFFFFFFF
(``kernels/threefry.py:threefry_plain``), since torch's uint32 supports few
operations. Both give the same bits.
"""

from __future__ import annotations

import torch

from .kernels import threefry as _k
from .kernels.threefry import MASK as _MASK
from .kernels.threefry import threefry_plain as threefry2x32


def _on_card(keys) -> bool:
    """Whether the kernel serves ``keys``: CUDA tensors take it, CPU
    tensors the plain int64 code."""
    return keys.is_cuda


def prng_key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32)."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(keys, data):
    """``jax.random.fold_in`` over a (..., 2) key batch; ``data`` is an int
    or an integer tensor broadcastable to the batch."""
    if _on_card(keys):
        return _k.threefry(keys, last=data)
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def uniform(keys, n: int):
    """``jax.random.uniform(key, (n,), float32)`` for each key of a (R, 2)
    batch -> (R, n) in [0, 1)."""
    if _on_card(keys):
        return _k.threefry(keys, n=n, kind=_k.UNIFORM)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(i), i)
    bits = (y0 ^ y1) >> 9 | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def split(key, n: int):
    """``jax.random.split(key, n)`` of one (2,) key -> (n, 2): key i is
    threefry2x32 of the counters (0, i) (``_threefry_split_foldlike``,
    jax/_src/prng.py, under ``jax_threefry_partitionable``)."""
    if _on_card(key):
        return _k.threefry(key, n=n)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def _bits32(key, n: int):
    """``jax.random.bits(key, (n,), uint32)``: the xor of the two threefry
    words of the counters (0, i)."""
    if _on_card(key):
        return _k.threefry(key, n=n, kind=_k.XOR)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return y0 ^ y1


def randint(key, n: int, lo: int, hi: int):
    """``jax.random.randint(key, (n,), lo, hi)`` (int32) of one (2,) key.

    The recipe of ``_randint`` in jax/_src/random.py (JAX 0.9.0): split the
    key in two, draw 32 bits from each (higher, lower) and combine them
    modulo the span, in uint32 arithmetic that wraps:
    ((higher % span) * mult + lower % span) % span with
    mult = ((2^16 % span)^2) % span, whose square wraps too (so mult is 0
    for spans past 2^16); a span below 1 is 1."""
    if not (-2 ** 31 <= lo < 2 ** 31 and -2 ** 31 <= hi < 2 ** 31):
        raise ValueError(f"randint bounds [{lo}, {hi}) outside int32")
    k1, k2 = split(key, 2)
    higher, lower = _bits32(k1, n), _bits32(k2, n)
    span = hi - lo if hi > lo else 1
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span
    off = (((higher % span) * mult & _MASK) + lower % span) & _MASK
    return (lo + off % span).to(torch.int32)


def uniform_1(key, n: int):
    """``jax.random.uniform(key, (n,))`` of one (2,) key -> (n,)."""
    return uniform(key[None], n)[0]


def sample_key(base_key, sample_index):
    """Key for one progressive sample pass."""
    return fold_in(base_key, sample_index)


def pixel_keys(skey, idx):
    """Per-pixel keys for this sample: (R,) Morton indices -> (R, 2)."""
    return fold_in(skey.expand(idx.shape[0], 2), idx)


def uniform_site(keys, site: int, bounce=None):
    """(0, 1] uniforms, one per key (the ``1 - u`` map of rng.py:61)."""
    if _on_card(keys):
        words = (site,) if bounce is None else (site, bounce)
        return _k.threefry(keys, words, n=1, kind=_k.ONE_MINUS_UNIFORM)[:, 0]
    kk = fold_in(keys, site)
    if bounce is not None:
        kk = fold_in(kk, bounce)
    return 1.0 - uniform(kk, 1)[:, 0]


def uniform_sites(keys, group: int, n: int, bounce=0):
    """n independent (0, 1] uniforms per key from one fold of the word
    ``group * 1024 + bounce`` -> (n, R) (on the card contiguous, row by
    row)."""
    if _on_card(keys):
        return _k.threefry(keys, (group * 1024 + bounce,), n=n,
                           kind=_k.ONE_MINUS_UNIFORM, by_counter=True)
    kk = fold_in(keys, group * 1024 + bounce)
    return 1.0 - uniform(kk, n).T


class SiteGroups:
    """Group ids for uniform_sites (spaced by the 1024-bounce packing)."""

    PT_BOUNCE = 1      # rows: choice, bsdf_u1, bsdf_u2, pick, light_u, light_v
    BDPT = 2           # rows: pick, light_u, light_v, dir_u1, dir_u2,
    #                    cam_u1, cam_u2


class Sites:
    """Draw-site ids of uniform_site (the JAX package's values)."""

    LENS_U1 = 1
    LENS_U2 = 101
    PIXEL_JITTER_X = 20
    PIXEL_JITTER_Y = 21
