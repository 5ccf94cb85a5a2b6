"""Morton (Z-order) pixel indexing over torch tensors.

Counterpart of ``cudapathtracer_tpu/utils/morton.py`` (reference:
camera.h:57-75, kernel.cu:771): the same parallel-prefix bit spread, on
int64 tensors holding uint32 values.
"""

from __future__ import annotations

import torch


def _part1by1(v):
    """Spread the low 16 bits of v so there is a 0 bit between each."""
    v = v & 0x0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _compact1by1(v):
    """Inverse of _part1by1: take every other bit and pack."""
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF
    return v


def morton_encode(x, y):
    """(x, y) pixel coords -> Morton index (camera.h:66-75 semantics)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    y = y.to(torch.int64) & 0xFFFFFFFF
    return (_part1by1(x) | (_part1by1(y) << 1)) & 0xFFFFFFFF


def morton_decode(index):
    """Morton index -> (x, y) pixel coords (camera.h:57-65 semantics)."""
    index = index.to(torch.int64) & 0xFFFFFFFF
    return _compact1by1(index), _compact1by1(index >> 1)


def scanline_decode(index, width):
    """Row-major index -> (x, y) pixel coords."""
    return index % width, index // width


def scanline_encode(x, y, width):
    """(x, y) pixel coords -> row-major index."""
    return y * width + x


def morton_to_scanline_perm(width, height, device):
    """Permutation p with image_scanline[y*W+x] = image_morton[p[y*W+x]]."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    return morton_encode(xs.reshape(-1), ys.reshape(-1))
