"""Traversal-cost falsecolor.

Counterpart of ``cudapathtracer_tpu/utils/profiling.py:falsecolor_state``:
the library form of the reference's 'sponza bvh.ppm' keeper mode.
"""

from __future__ import annotations

import torch

from ..accel.bvh import Accel
from ..ops import traversal
from ..ops.rng import pixel_keys, prng_key, sample_key
from ..ops.vecmath import Vec3
from ..render.camera import camera_rays
from ..render.renderer import AccumState


def falsecolor_state(scene, bvh, cam, cfg, seed: int = 1234):
    """Per-pixel traversal cost of one primary-ray trace of the fine BVH
    (``bvh``: an Accel or its fine FlatBVH) as an AccumState: red = the
    ray's node visits over the most any ray made, times 4; green = 1 minus
    that. -> (AccumState, TraceStats), deterministic for a fixed scene,
    camera and seed."""
    fine = bvh.fine if isinstance(bvh, Accel) else bvh
    td = traversal.make_trace_data(scene, fine)
    dev = cam.pos.x.device
    idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    keys = pixel_keys(sample_key(prng_key(seed, dev), 0), idx)
    o, d = camera_rays(cam, idx, keys)
    _, stats = traversal.trace(o, d, td, with_stats=True)
    v = stats.ray_visits.to(torch.float32)
    v = v / torch.clamp(v.max(), min=1.0)
    z = torch.zeros_like(v)
    return AccumState(img=Vec3(v * 4.0, 1.0 - v, z), comp=Vec3(z, z, z),
                      n=1), stats
