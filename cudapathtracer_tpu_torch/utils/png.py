"""Minimal dependency-free PNG writer (8-bit RGB, zlib from the stdlib).

The reference only emits PPM (kernel.cu:764-778); PNG is the quality-of-
life extension named in the build plan (SURVEY.md §7 L7 "PPM/PNG writer").
Output is a standard non-interlaced truecolor PNG readable by anything.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path, rgb_u8, flip_x: bool = True):
    """Write an (H, W, 3) uint8 array as PNG.

    ``flip_x=True`` matches write_ppm / the reference's descending-x pixel
    loop so PPM and PNG outputs of the same render are identical images.
    """
    img = np.asarray(rgb_u8, np.uint8)
    assert img.ndim == 3 and img.shape[2] == 3, img.shape
    h, w, _ = img.shape
    if flip_x:
        img = img[:, ::-1, :]
    # filter byte 0 (None) per scanline
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path):
    """Read back an 8-bit truecolor PNG written by write_png -> (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, color, *_ = struct.unpack(">IIBBBBB", payload)
            assert depth == 8 and color == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    img = np.empty((h, w, 3), np.uint8)
    prev = np.zeros((w, 3), np.int32)
    for y in range(h):
        row = raw[y * stride : (y + 1) * stride]
        filt = row[0]
        cur = np.frombuffer(row[1:], np.uint8).reshape(w, 3).astype(np.int32)
        if filt == 0:
            pass
        elif filt == 1:  # Sub
            for x in range(1, w):
                cur[x] = (cur[x] + cur[x - 1]) % 256
        elif filt == 2:  # Up
            cur = (cur + prev) % 256
        else:
            raise NotImplementedError(f"PNG filter {filt}")
        img[y] = cur.astype(np.uint8)
        prev = cur
    return img
