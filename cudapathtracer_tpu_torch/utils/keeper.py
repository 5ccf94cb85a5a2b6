"""Keeper-parity helpers: compare renders against the reference's golden
PPMs (its "keepers") distributionally, on numpy u8 images.

A copy of ``cudapathtracer_tpu/utils/keeper.py`` (the port imports nothing
of the JAX package); tests/test_torch_host_utils.py holds each function
against the original.
"""

from __future__ import annotations

import numpy as np


def to_linear(u8):
    """Invert gammaCorrect(1/2.2) then Reinhard c/(c+1) (color.h:59-71)."""
    x = np.clip(np.asarray(u8, np.float64) / 255.0, 0.0, 0.999)
    y = x ** 2.2
    return y / (1.0 - y)


def block32(u8):
    """(H, W, 3) u8 -> (32, 32, 3) linear-radiance block means."""
    h = u8.shape[0]
    b = h // 32
    return to_linear(u8).reshape(32, b, 32, b, 3).mean(axis=(1, 3))


def regions(b):
    """Teapot-free regions in 32x32-block space (the keeper scenes include
    models/teapot.obj, roughly rows 10-25 x cols 8-21 displayed)."""
    return dict(
        ceil=b[1:3, 6:26].mean(axis=(0, 1)),
        upwall=b[6:8, 8:24].mean(axis=(0, 1)),
        left=b[8:28, 1:5].mean(axis=(0, 1)),
        right=b[8:28, 27:31].mean(axis=(0, 1)),
        bottom=b[29:31, 4:28].mean(axis=(0, 1)),
    )


def region_ratios(keeper_u8, ours_u8):
    """Per-region keeper/ours mean-channel linear ratios + image means."""
    rk = regions(block32(keeper_u8))
    ro = regions(block32(ours_u8))
    out = {
        name: float((rk[name] / np.maximum(ro[name], 1e-9)).mean())
        for name in rk
    }
    out["mean_ours_u8"] = float(np.asarray(ours_u8, np.float64).mean())
    out["mean_keeper_u8"] = float(np.asarray(keeper_u8, np.float64).mean())
    return out
