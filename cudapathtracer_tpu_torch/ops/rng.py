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

Keys are int64 tensors of shape (..., 2). The uint32 arithmetic runs in
int64 masked with 0xFFFFFFFF, since torch's uint32 supports few operations.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 on broadcastable int64 tensors holding uint32
    values (Salmon et al. 2011; the schedule of jax.random's threefry)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32)."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(keys, data):
    """``jax.random.fold_in`` over a (..., 2) key batch; ``data`` is an int
    or an integer tensor broadcastable to the batch."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def uniform(keys, n: int):
    """``jax.random.uniform(key, (n,), float32)`` for each key of a (R, 2)
    batch -> (R, n) in [0, 1)."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(i), i)
    bits = (y0 ^ y1) >> 9 | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def sample_key(base_key, sample_index):
    """Key for one progressive sample pass."""
    return fold_in(base_key, sample_index)


def pixel_keys(skey, idx):
    """Per-pixel keys for this sample: (R,) Morton indices -> (R, 2)."""
    return fold_in(skey.expand(idx.shape[0], 2), idx)


def uniform_site(keys, site: int, bounce=None):
    """(0, 1] uniforms, one per key (the ``1 - u`` map of rng.py:61)."""
    kk = fold_in(keys, site)
    if bounce is not None:
        kk = fold_in(kk, bounce)
    return 1.0 - uniform(kk, 1)[:, 0]


def uniform_sites(keys, group: int, n: int, bounce=0):
    """n independent (0, 1] uniforms per key from one fold of the word
    ``group * 1024 + bounce`` -> (n, R)."""
    kk = fold_in(keys, group * 1024 + bounce)
    return 1.0 - uniform(kk, n).T


class SiteGroups:
    """Group ids for uniform_sites (spaced by the 1024-bounce packing)."""

    PT_BOUNCE = 1      # rows: choice, bsdf_u1, bsdf_u2, pick, light_u, light_v


class Sites:
    """Draw-site ids of uniform_site (the JAX package's values)."""

    LENS_U1 = 1
    LENS_U2 = 101
    PIXEL_JITTER_X = 20
    PIXEL_JITTER_Y = 21
