"""The port's boundary terms against the benchmark's plain reference of them
(``h100_bench/reference/edges.py``), on the CPU: the draws of both, bit for
bit; the shape-fitting scene; the loss and the gradients of one step with
both terms on a subdiv-1 hero at 32^2, 256 samples of each term; the same
comparison with the terms left out of the program, which must fail; and
the card's FMA wrapper on the edge path, which must expand no operand.

The reference shares nothing with the port but the sample draws' recipe,
so the two differ by rounding: the port's fused multiply-adds and
Baldwin-Weber hits against plain float32 and Moller-Trumbore. The
configuration's jittered camera rays keep every primary ray off the
box's quad edges, where the two intersectors would split by rounding."""

import numpy as np
import pytest
import torch

from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.diff.edge_sampling import build_edge_table
from cudapathtracer_tpu_torch.models import procedural
from cudapathtracer_tpu_torch.ops import rng as port_rng
from cudapathtracer_tpu_torch.ops.kernels import (dense, dense_resident,
                                                  dense_super)
from cudapathtracer_tpu_torch.ops.kernels import fma as kfma
from cudapathtracer_tpu_torch.render import renderer
from cudapathtracer_tpu_torch.utils.config import RenderConfig
from h100_bench import drivers, harness
from h100_bench.reference import edges, inverse
from h100_bench.reference import rng as ref_rng
from h100_bench.scenes import cornell_hero, cornell_with_sphere_mesh

SIZE = 32
SUBDIV = 1
SAMPLES = 256
HERO = 10 * 4 ** SUBDIV + 2
SEED = 2 ** 31 + 7
CONFIG = harness.load_json(harness.BENCH_DIR / "configs"
                           / "cornell_shape.json")
CAM = CONFIG["camera"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEYS = [(0, 0), (0, 7), (0x12345678, 0x9ABCDEF0), (0xFFFFFFFF, 3)]


@pytest.mark.parametrize("key", KEYS)
def test_split_and_uniform_match_the_ports_bit_for_bit(key):
    k = torch.tensor(key, dtype=torch.int64)
    assert torch.equal(edges.split(k, 5), port_rng.split(k, 5))
    got, want = edges.uniform_1(k, 1000), port_rng.uniform_1(k, 1000)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 7), (0, 65536), (0, 65537),
                                   (0, 30786), (3, 1000), (0, 1 << 20),
                                   (-5, 70000), (0, 0)])
def test_randint_matches_the_ports_bit_for_bit(lo, hi):
    for key in KEYS:
        k = torch.tensor(key, dtype=torch.int64)
        got = edges.randint(k, 4096, lo, hi)
        want = port_rng.randint(k, 4096, lo, hi)
        assert torch.equal(got, want.to(torch.int64)), (key, lo, hi)


def test_the_hero_scene_at_its_defaults_is_cornell_with_sphere_mesh():
    got = cornell_hero.generate()
    frozen = cornell_with_sphere_mesh.generate(3)
    program = procedural.cornell_with_sphere_mesh(3)
    for k in ("verts", "tris", "tri_mats", "albedo", "emission"):
        for want in (frozen, program):
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_the_edge_tables_match():
    tris = cornell_hero.generate(2)["tris"]
    port = build_edge_table(tris, device="cpu")
    ref = edges.edges_of(torch.from_numpy(tris))
    for a, b in zip(port, ref):
        assert torch.equal(a.to(torch.int64), b)


def _setup():
    desc = cornell_hero.generate(SUBDIV)
    target = cornell_hero.generate(**CONFIG["target"]["args"]
                                   | {"subdiv": SUBDIV})
    scene = drivers.port_scene(desc, "cpu")
    tscene = drivers.port_scene(target, "cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=1, samples_per_call=1,
                       reuse_primary_hit=False, **CONFIG["render"])
    bvh, tbvh = (renderer.build_bvh_for_scene(s, cfg.leaf_size,
                                              cluster_size=cfg.cluster_size)
                 for s in (scene, tscene))
    cam = drivers.camera(CONFIG, SIZE, "cpu")
    base = ref_rng.seed_key(SEED)
    tkey, key = ref_rng.fold_in(base, 0), ref_rng.fold_in(base, 1)
    return desc, target, scene, tscene, cfg, bvh, tbvh, cam, tkey, key


def _port_step(s, samples):
    desc, target, scene, tscene, cfg, bvh, tbvh, cam, tkey, key = s
    with torch.no_grad():
        tgt = rg.render_image_diff(tscene, cam, cfg, tkey, 1, bvh=tbvh)
    table = build_edge_table(scene.host_tris, device="cpu")
    params = rg.targets_of(scene)
    leaves = rg.target_leaves(params)
    img = rg.render_image_diff(rg.scene_with(scene, params), cam, cfg, key,
                               1, bvh=bvh, edge_samples=samples,
                               edge_table=table,
                               shadow_edge_samples=samples)
    loss = rg.l2_loss(img, tgt)
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    return dict(img=torch.stack([t.detach() for t in img], 1),
                target=torch.stack(list(tgt), 1),
                verts=torch.stack(g[0:3], 1), albedo=torch.stack(g[3:6], 1),
                emission=torch.stack(g[6:9], 1))


def _ref_step(s, samples):
    desc, target = s[0], s[1]
    key, tkey = s[9], s[8]
    arrays = drivers.device_arrays(desc, "cpu")
    p = {k: arrays[k].clone().requires_grad_() for k in inverse.LEAVES}
    jitter = CONFIG["render"]["jitter"]
    with torch.no_grad():
        tgt = edges.image(dict(p, verts=torch.from_numpy(target["verts"])),
                          arrays, CAM, SIZE, tkey, jitter)
    img = edges.image_with_edges(p, arrays, edges.edges_of(arrays["tris"]),
                                 CAM, SIZE, key, samples, samples, jitter)
    g = torch.autograd.grad(inverse.l2(img, tgt),
                            [p[k] for k in inverse.LEAVES])
    return dict(img=img.detach(), target=tgt, **dict(zip(inverse.LEAVES, g)))


@pytest.fixture(scope="module")
def steps():
    s = _setup()
    return {(side, n): f(s, n) for side, f in (("port", _port_step),
                                                ("ref", _ref_step))
            for n in (SAMPLES, 0)}, s


def _norms(g):
    return np.array([float(g[:, c].double().norm()) for c in range(3)])


# the port's FMAs and Baldwin-Weber hits against the reference's plain
# float32 and Moller-Trumbore: measured under 2e-6 relative on four seeds
# (my CPU runs), with room for another host's rounding
RTOL = 1e-4


def test_the_loss_and_the_gradients_match(steps):
    runs, _ = steps
    port, ref = runs[("port", SAMPLES)], runs[("ref", SAMPLES)]
    loss = [float(((r["img"] - r["target"]) ** 2).sum(1).mean())
            for r in (port, ref)]
    assert loss[0] == pytest.approx(loss[1], rel=RTOL)
    for k in ("verts", "albedo", "emission"):
        np.testing.assert_allclose(_norms(port[k]), _norms(ref[k]),
                                   rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(_norms(port["verts"][-HERO:]),
                               _norms(ref["verts"][-HERO:]), rtol=RTOL)


def test_the_boundary_terms_parts_match(steps):
    """Each side's gradient with the terms less its gradient without them:
    the terms' own part, compared by itself."""
    runs, _ = steps
    bp = runs[("port", SAMPLES)]["verts"] - runs[("port", 0)]["verts"]
    br = runs[("ref", SAMPLES)]["verts"] - runs[("ref", 0)]["verts"]
    np.testing.assert_allclose(_norms(bp), _norms(br), rtol=RTOL)
    np.testing.assert_allclose(_norms(bp[-HERO:]), _norms(br[-HERO:]),
                               rtol=RTOL)
    ref = runs[("ref", SAMPLES)]["verts"]
    assert (_norms(br[-HERO:]) > 0.1 * _norms(ref[-HERO:])).any()


def test_the_boundary_terms_move_vertices_alone(steps):
    runs, _ = steps
    for side in ("port", "ref"):
        with_, without = runs[(side, SAMPLES)], runs[(side, 0)]
        assert torch.equal(with_["img"], without["img"])
        for k in ("albedo", "emission"):
            assert torch.equal(with_[k], without[k]), (side, k)
        assert not torch.equal(with_["verts"], without["verts"])


def test_the_program_without_the_terms_fails_the_comparison(steps):
    runs, _ = steps
    for part in (slice(None), slice(-HERO, None)):
        got = _norms(runs[("port", 0)]["verts"][part])
        want = _norms(runs[("ref", SAMPLES)]["verts"][part])
        # past RTOL by more than two decades (measured 0.017 to 0.99)
        assert (np.abs(got - want) / want).max() > 100 * RTOL
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got, want, rtol=RTOL)


def test_the_edge_path_expands_no_fma_operand(monkeypatch):
    """The card's wrapper (``ops/kernels/fma.fma``, its launch stubbed) on
    every FMA of the glue in a step with both terms, forward and backward:
    no operand is expanded before a launch. The plain fold, the fold
    kernels' stand-in here, is left out: on the card its FMAs are inside
    the kernels."""
    plain = kfma.fma_plain
    folding = []
    monkeypatch.setattr(kfma, "_launch", lambda out, ops: None)

    def both(a, b, c):
        if not folding:
            kfma.fma(a, b, c)
        return plain(a, b, c)

    both.calls = 0    # the plain version counts itself by its module name
    monkeypatch.setattr(kfma, "fma_plain", both)
    for mod in (dense, dense_resident, dense_super):
        def fold(*args, _fold=mod.plain_fold, **kwargs):
            folding.append(1)
            try:
                return _fold(*args, **kwargs)
            finally:
                folding.pop()
        monkeypatch.setattr(mod, "plain_fold", fold)
    monkeypatch.setattr(kfma.fma, "launches", 0)
    monkeypatch.setattr(kfma.fma, "expanded", 0)
    s = _setup()
    assert torch.isfinite(_port_step(s, 0)["verts"]).all()
    interior = kfma.fma.launches
    assert torch.isfinite(_port_step(s, 64)["verts"]).all()
    assert kfma.fma.launches > 2 * interior > 0
    assert kfma.fma.expanded == 0
