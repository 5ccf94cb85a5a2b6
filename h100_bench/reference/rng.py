"""Counter-based random numbers: threefry2x32 as ``jax.random`` draws them.

The benchmark's own copy, written from the published algorithm (Salmon et
al., "Parallel random numbers: as easy as 1, 2, 3", 2011) and the key
conventions of ``jax.random`` with ``jax_threefry_partitionable`` on:

* a key is two uint32 words; the key of seed s is (0, s);
* ``fold_in(key, w)`` is ``threefry2x32(key, (0, w))``;
* ``uniform(key, n)`` hashes the counters (0, i), xors the two output words,
  keeps the top 23 bits as a mantissa in [1, 2) and subtracts 1.

The renderer under test keys every draw on (seed, sample, pixel, site), so
this copy draws the very numbers it draws, and the plain integrators can be
compared with it sample by sample. Keys are int64 tensors of shape (..., 2)
holding uint32 values.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

# uniform_sites groups (a fold of the word group * 1024 + bounce)
PT_BOUNCE = 1   # rows: branch, bsdf u1, bsdf u2, light pick, light u, v
BDPT = 2        # rows: light pick, light u, v, light dir u1, u2, cam u1, u2


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """20 rounds of Threefry-2x32 on broadcastable int64 tensors."""
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


def seed_key(seed: int, device="cpu") -> torch.Tensor:
    """The (2,) key of a seed; seeds past 32 bits keep their low 32."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(keys, data):
    """Fold the word(s) ``data`` into a (..., 2) key batch."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data) & MASK, dtype=torch.int64,
                            device=keys.device)
    data = data.to(torch.int64) & MASK
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def uniform(keys, n: int):
    """(R, 2) keys -> (R, n) float32 uniforms in [0, 1)."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(i), i)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def pixel_keys(base_key, sample_index: int, idx):
    """Keys of sample ``sample_index`` at Morton pixels ``idx`` (R,)."""
    skey = fold_in(base_key, sample_index)
    return fold_in(skey.expand(idx.shape[0], 2), idx)


def uniform_sites(keys, group: int, n: int, bounce: int = 0):
    """n uniforms in (0, 1] per key, from one fold of the word
    ``group * 1024 + bounce`` -> (n, R) float32."""
    kk = fold_in(keys, group * 1024 + bounce)
    return 1.0 - uniform(kk, n).T
