"""The benchmark's frozen yardstick agrees with the program's today, on a
small scene on the CPU: ``needed_work`` and ``OPS_PER_TEST`` with
``ops/kernels/work.py``, the ray accounting with the port's bench, the
scene generators with ``models/procedural.py``, and the reference's random
numbers with ``ops/rng.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from h100_bench import harness, work
from h100_bench.reference import rng


@pytest.fixture(scope="module")
def shortlists():
    from cudapathtracer_tpu_torch.models import procedural
    from cudapathtracer_tpu_torch.ops import packets
    from cudapathtracer_tpu_torch.ops.kernels.dense_resident import (
        dense_intersect_resident_plain, pack_clusters)
    from cudapathtracer_tpu_torch.ops.vecmath import Vec3
    from cudapathtracer_tpu_torch.render.renderer import (build_bvh_for_scene,
                                                          make_packet_prep)

    scene = procedural.to_scene(procedural.colonnade(subdiv=1), "cpu")
    bvh = build_bvh_for_scene(scene, 4, cluster_size=128)
    prep = make_packet_prep(scene, bvh)
    g = torch.Generator().manual_seed(3)
    R = 2048
    o = Vec3(*(torch.rand(R, generator=g) * 4 - 2 + c
               for c in (0.0, 2.0, 0.0)))
    d = torch.randn(3, R, generator=g)
    d = d / d.norm(dim=0)
    d = Vec3(d[0], d[1], d[2])
    mask = torch.ones(R, dtype=torch.bool)
    out = []
    for inter in ("bw", "mt"):
        pack = pack_clusters(prep.pdata, inter)
        sl = packets.build_shortlists(o, d, mask, prep.pdata, 128, 4095)
        t, _ = dense_intersect_resident_plain(sl.ids, sl.counts, sl.entries,
                                              sl.rays, *pack)
        out.append((sl, t, pack, scene.num_tris))
    return out


def test_needed_work_is_the_programs(shortlists):
    from cudapathtracer_tpu_torch.ops.kernels import work as port

    for sl, t, pack, T in shortlists:
        mine = work.needed_work(sl.ids, sl.counts, sl.rays, t, pack, T)
        assert mine == port.needed_work(sl, t, pack, T)
        assert mine[0] > 0
        # as super units of F = 2 over the same pack
        F = 2
        ids = torch.div(sl.ids, F, rounding_mode="floor")
        sup = type(sl)(ids, sl.counts, sl.entries, sl.rays, sl.U)
        assert work.needed_work(ids, sl.counts, sl.rays, t, pack, T, F) == \
            port.needed_work(sup, t, pack, T, F)


def test_ops_and_rays_are_the_programs():
    from cudapathtracer_tpu_torch import bench
    from cudapathtracer_tpu_torch.ops.kernels import work as port
    from cudapathtracer_tpu_torch.utils.config import RenderConfig

    assert work.OPS_PER_TEST == port.OPS_PER_TEST
    cfg = RenderConfig(width=64, height=64, integrator="pt_nee")
    assert bench._mrays(cfg, 5, [2.0]) == pytest.approx(
        work.rays(64 * 64, 5, 3) / 2.0 / 1e6)


@pytest.mark.parametrize("spec", [
    {"generator": "colonnade", "args": {"subdiv": 1}},
    {"generator": "cornell_with_sphere_mesh", "args": {"subdiv": 2}}])
def test_frozen_scenes_are_the_programs(spec):
    from cudapathtracer_tpu_torch.models import procedural

    mine = harness.make_scene(harness.BENCH_DIR, spec)
    theirs = getattr(procedural, spec["generator"])(**spec["args"])
    for k in ("verts", "tris", "tri_mats", "albedo", "emission"):
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_reference_keys_are_the_programs():
    from cudapathtracer_tpu_torch.ops import rng as port

    seed = 2 ** 31 + 99
    base = rng.seed_key(seed)
    assert torch.equal(base, port.prng_key(seed, "cpu"))
    idx = torch.arange(0, 4096, 37)
    keys = rng.pixel_keys(base, 7, idx)
    assert torch.equal(keys, port.pixel_keys(port.sample_key(base, 7), idx))
    assert torch.equal(rng.uniform_sites(keys, 1, 6, 2),
                       port.uniform_sites(keys, 1, 6, bounce=2))
