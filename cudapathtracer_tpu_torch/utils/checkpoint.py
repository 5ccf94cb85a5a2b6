"""Checkpoint / resume of progressive renders.

Counterpart of ``cudapathtracer_tpu/utils/checkpoint.py:save_checkpoint``
and ``load_checkpoint``, in the same format, so that a render saved by
either package resumes in the other. The accumulation scheme is the whole
loop state (a running mean, its Kahan compensation and the sample count,
kernel.cu:552), plus the base seed: every random draw is a function of
(seed, sample index, pixel index, site), so a resumed render equals the
uninterrupted one bit for bit.

Format: one .npz, saved to a temporary name and renamed into place, so a
crash never leaves a half-written checkpoint. Its members, each the dtype
and shape the JAX package writes: ``version`` (int64), ``img_x`` ...
``comp_z`` (R,) float32 in Morton order, ``n`` a 0-d int32 (the JAX
``AccumState.n``; the port's is a Python int), ``seed`` int64, and with a
config ``width``, ``height`` (``np.asarray`` of a Python int) and
``integrator`` (a numpy unicode scalar). The sharded checkpoints of
multi-device renders are not ported yet.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..ops.vecmath import Vec3
from ..render.renderer import AccumState

_FORMAT_VERSION = 1


def save_checkpoint(path, state: AccumState, seed: int, cfg=None):
    """Atomic save. ``cfg`` (RenderConfig) is stored for shape validation."""
    payload = dict(
        version=_FORMAT_VERSION,
        img_x=state.img.x.cpu().numpy(),
        img_y=state.img.y.cpu().numpy(),
        img_z=state.img.z.cpu().numpy(),
        comp_x=state.comp.x.cpu().numpy(),
        comp_y=state.comp.y.cpu().numpy(),
        comp_z=state.comp.z.cpu().numpy(),
        n=np.asarray(state.n, np.int32),
        seed=np.asarray(seed, np.int64),
    )
    if cfg is not None:
        payload["width"] = np.asarray(cfg.width)
        payload["height"] = np.asarray(cfg.height)
        payload["integrator"] = np.asarray(cfg.integrator)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path, cfg=None, *, device="cuda"):
    """-> (AccumState on ``device``, seed). Validates the image size and
    the integrator against ``cfg`` when given (an AssertionError on a
    mismatch, as in the JAX package)."""
    with np.load(path, allow_pickle=False) as z:
        # raised, not asserted, so that the checks hold under python -O
        if int(z["version"]) != _FORMAT_VERSION:
            raise AssertionError(f"checkpoint format {int(z['version'])}")
        if cfg is not None:
            for key in ("width", "height", "integrator"):
                saved = z[key].item()
                if saved != getattr(cfg, key):
                    raise AssertionError(
                        f"checkpoint {key} {saved!r} != the config's "
                        f"{getattr(cfg, key)!r}")

        def t(name):
            return torch.from_numpy(np.ascontiguousarray(z[name])).to(device)

        state = AccumState(
            img=Vec3(t("img_x"), t("img_y"), t("img_z")),
            comp=Vec3(t("comp_x"), t("comp_y"), t("comp_z")),
            n=int(z["n"]),
        )
        return state, int(z["seed"])
