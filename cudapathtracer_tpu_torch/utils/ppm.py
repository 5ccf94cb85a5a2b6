"""P3 PPM reader/writer compatible with the reference's output.

The reference writes ``P3 W H 255`` then, for each scanline y, iterates x
from W-1 down to 0 and looks the pixel up through the Morton mapping
(kernel.cu:764-778) — i.e. the stored image is x-flipped relative to camera
film coordinates. ``write_ppm`` reproduces that exact layout so our renders
are pixel-for-pixel comparable with the reference keepers, given matching
scenes.
"""

from __future__ import annotations

import numpy as np


def write_ppm(path, rgb_u8, flip_x: bool = True):
    """Write an (H, W, 3) uint8 array as P3.

    ``flip_x=True`` matches the reference writer's descending-x loop
    (kernel.cu:768).
    """
    img = np.asarray(rgb_u8)
    assert img.ndim == 3 and img.shape[2] == 3, img.shape
    h, w, _ = img.shape
    if flip_x:
        img = img[:, ::-1, :]
    flat = img.reshape(-1, 3)
    with open(path, "w") as f:
        f.write(f"P3 {w} {h} 255\n")
        # The reference writes triples separated by spaces on one giant line;
        # we chunk into lines for sanity but the format is identical.
        out = []
        for i in range(0, flat.shape[0], 1024):
            chunk = flat[i : i + 1024]
            out.append(" ".join(str(v) for v in chunk.reshape(-1)))
        f.write(" ".join(out))
        f.write(" ")


def read_ppm(path):
    """Read a P3 PPM into an (H, W, 3) uint8 array (handles the reference's
    single-line body and arbitrary whitespace)."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    for line in data.split(b"\n"):
        line = line.split(b"#")[0]
        tokens.extend(line.split())
    assert tokens[0] == b"P3", "only P3 supported"
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array([int(t) for t in tokens[4 : 4 + w * h * 3]], dtype=np.int32)
    assert vals.size == w * h * 3, (vals.size, w * h * 3)
    img = vals.reshape(h, w, 3)
    if maxval != 255:
        img = (img.astype(np.float64) * 255.0 / maxval).astype(np.int32)
    return img.astype(np.uint8)
