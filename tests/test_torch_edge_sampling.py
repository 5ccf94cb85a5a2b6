"""The port's boundary terms (cudapathtracer_tpu_torch/diff/edge_sampling.py)
on the CPU: the edge table and the gradients against the JAX package on
the same scenes and keys, the value-zero contract, and the
finite-difference checks of tests/test_edge_sampling.py with their sizes
and rules, on the port alone.

Gradient parity: with the boundary terms the vertex gradients stay within
1e-3 of each array's largest |g| of the JAX package's (measured: 1.9e-7
with the primary term at 256 samples, 7.3e-8 with the shadow term at
4096); the samples, drawn with ``rng.split``/``randint``, are the JAX
package's bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cudapathtracer_tpu as J
from cudapathtracer_tpu.diff import render_grad as jrg
from cudapathtracer_tpu.diff.edge_sampling import build_edge_table as jbet
from cudapathtracer_tpu.models import procedural as jproc

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import convert
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.diff.edge_sampling import (
    boundary_image,
    build_edge_table,
    shadow_boundary_image,
)
from cudapathtracer_tpu_torch.models.scene import recompute_derived
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.ops.shading import make_shade_table, tri_shading
from cudapathtracer_tpu_torch.ops.vecmath import Vec3
from cudapathtracer_tpu_torch.render.renderer import make_trace_fn
from cudapathtracer_tpu_torch.utils.morton import morton_decode
from test_edge_sampling import occluder_scene, shadow_scene

FRAC_OF_MAX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process (tests/test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(jscene):
    """The JAX test scene carried into the port."""
    return convert.scene_from_jax(convert.to_numpy_dict(jscene), "cpu")


@pytest.mark.parametrize("scene", ["cornell_open", "cornell", "occluder",
                                   "shadow"])
def test_build_edge_table_matches_jax(scene):
    if scene == "occluder":
        _, tris, _ = occluder_scene()
    elif scene == "shadow":
        _, tris, _ = shadow_scene()
    else:
        tris = jproc.cornell_box(with_boxes=scene == "cornell")["tris"]
    want = jbet(tris)
    got = build_edge_table(tris, device="cpu")
    assert got.num_edges == want.num_edges
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # carried across, as the tests of both packages use it
    same = convert.edge_table_from_jax(convert.to_numpy_dict(want), "cpu")
    for a, b in zip(same, got):
        assert torch.equal(a, b)


def test_edge_table_structure():
    _, tris, _ = occluder_scene()
    et = build_edge_table(tris, device="cpu")
    assert bool((et.ev0 < et.ev1).all())
    # each quad's two triangles share a diagonal (fb >= 0); border edges
    # have fb == -1
    assert int((et.fb >= 0).sum()) >= 7
    keys = et.ev0.long() * 1_000_000 + et.ev1.long()
    assert torch.unique(keys).numel() == keys.numel()


def test_boundary_image_value_is_zero():
    js, tris, _ = occluder_scene()
    scene = recompute_derived(_port(js))
    et = build_edge_table(tris, device="cpu")
    cam = T.make_camera(width=16, height=16, device="cpu")

    def radiance_stub(o, d, kidx):
        return Vec3.full(o.x.shape, 1.0, 2.0, 3.0, "cpu")

    img = boundary_image(scene, cam, et, radiance_stub, prng_key(0, "cpu"),
                         256, 256)
    for c in img:
        assert c.shape == (256,) and float(c.abs().max()) == 0.0


def test_shadow_boundary_image_value_is_zero_and_carries_gradient():
    js, tris, occ = shadow_scene()
    base = _port(js)
    p = rg.targets_of(base)
    scene = recompute_derived(rg.scene_with(base, p))
    et = build_edge_table(tris, device="cpu")
    cam = T.make_camera(pos=(0.0, 0.8, 3.0), dist_from_film=1.0,
                        focal_length=3.0, width=16, height=16, device="cpu")
    cfg = T.RenderConfig(width=16, height=16, spp=1, integrator="pt_nee",
                         traversal="brute")
    stab = make_shade_table(scene)

    def shade_normal_fn(tri):
        n, alb, _ = tri_shading(stab, tri)
        return Vec3(*(c.detach() for c in n)), Vec3(*(c.detach()
                                                      for c in alb))

    img = shadow_boundary_image(scene, cam, et, make_trace_fn(scene, cfg,
                                                              None),
                                shade_normal_fn, prng_key(0, "cpu"), 4096,
                                256)
    for c in img:
        assert float(c.detach().abs().max()) == 0.0
    g = torch.autograd.grad(sum(c.sum() for c in img), p.verts.x)[0]
    assert float(g[occ].abs().max()) > 0


def _edge_case(which):
    """(JAX scene, tris, camera kwargs, RenderConfig kwargs, edge_samples,
    shadow_edge_samples) of one parity case at 16^2. The shadow term takes
    4096 samples: at 256 none of them is valid on this scene (a sample needs
    a silhouette that casts onto the small light, whose two probes see it
    differently), and both packages' terms are exactly zero."""
    if which == "primary":
        js, tris, _ = occluder_scene()
        return js, tris, {}, dict(jitter=True), 256, 0
    js, tris, _ = shadow_scene()
    return (js, tris, dict(pos=(0.0, 0.8, 3.0), dist_from_film=1.0,
                           focal_length=3.0),
            dict(jitter=False, num_bounces=2), 0, 4096)


@pytest.mark.parametrize("which", ["primary", "shadow"])
def test_boundary_gradients_match_jax(which):
    """The vertex gradients of a render with a boundary term against the
    JAX package's, and the term must move them."""
    js, tris, camkw, cfgkw, es, ses = _edge_case(which)
    ts = _port(js)
    kw = dict(width=16, height=16, spp=1, integrator="pt_nee",
              traversal="brute", **cfgkw)
    jcam = J.make_camera(width=16, height=16, **camkw)
    tcam = T.make_camera(width=16, height=16, device="cpu", **camkw)
    jcfg, tcfg = J.RenderConfig(**kw), T.RenderConfig(**kw)
    jet = jbet(tris)
    tet = build_edge_table(tris, device="cpu")

    def jf(p, e, s):
        img = jrg.render_image_diff(jrg.scene_with(js, p), jcam, jcfg,
                                    jax.random.PRNGKey(7), 1,
                                    edge_samples=e, edge_table=jet,
                                    shadow_edge_samples=s)
        return jnp.mean(img.x * 0.3 + img.y * 0.5 + img.z * 0.2)

    def tf(e, s):
        p = rg.targets_of(ts)
        img = rg.render_image_diff(rg.scene_with(ts, p), tcam, tcfg,
                                   prng_key(7, "cpu"), 1, edge_samples=e,
                                   edge_table=tet, shadow_edge_samples=s)
        val = torch.mean(img.x * 0.3 + img.y * 0.5 + img.z * 0.2)
        return val, torch.autograd.grad(val, list(p.verts))

    jval, jg = jax.jit(jax.value_and_grad(jf), static_argnums=(1, 2))(
        jrg.targets_of(js), es, ses)
    tval, tg = tf(es, ses)
    _, tg0 = tf(0, 0)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    moved = 0.0
    for a, a0, b in zip(tg, tg0, jg.verts):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert torch.isfinite(a).all()
        assert float(np.abs(a.numpy() - b).max()) <= FRAC_OF_MAX * scale
        moved = max(moved, float((a - a0).abs().max()) / scale)
    assert moved > 0.1


# ---------------------------------------------------------------------------
# finite differences (tests/test_edge_sampling.py)
# ---------------------------------------------------------------------------

def test_silhouette_gradient_matches_fd():
    """d(mean image)/d(occluder x-translation): the interior gradient
    misses it, edge sampling recovers it within Monte-Carlo tolerance."""
    js, tris, qids = occluder_scene()
    scene = _port(js)
    et = build_edge_table(tris, device="cpu")
    size = 32
    cam = T.make_camera(width=size, height=size, device="cpu")
    cfg = T.RenderConfig(width=size, height=size, spp=1,
                         integrator="pt_nee", jitter=True, traversal="brute")
    key = prng_key(42, "cpu")
    SPP = 48       # the autodiff evaluations
    SPP_FD = 192   # the FD reference: its signal lives in the one-pixel
    #                silhouette band (tests/test_edge_sampling.py)
    ES = 8192
    qsel = torch.zeros(scene.verts.x.shape[0])
    qsel[qids] = 1.0

    def mean_img(dx, edge_samples, spp=SPP):
        verts = scene.verts._replace(x=scene.verts.x + dx * qsel)
        img = rg.render_image_diff(scene._replace(verts=verts), cam, cfg,
                                   key, spp, edge_samples=edge_samples,
                                   edge_table=et if edge_samples else None)
        return (img.x.mean() + img.y.mean() + img.z.mean()) / 3.0

    def grad(edge_samples):
        dx = torch.zeros((), requires_grad=True)
        return float(torch.autograd.grad(mean_img(dx, edge_samples), dx)[0])

    g_int = grad(0)
    g_edge = grad(ES)
    eps = 4.0 / size * 0.5
    with torch.no_grad():
        fd = (float(mean_img(eps, 0, SPP_FD))
              - float(mean_img(-eps, 0, SPP_FD))) / (2 * eps)
    print(f"fd={fd:.5f} interior={g_int:.5f} with_edges={g_edge:.5f}")
    assert np.isfinite(fd) and np.isfinite(g_edge)
    assert abs(g_int - fd) > abs(g_edge - fd), (fd, g_int, g_edge)
    assert abs(g_edge - fd) <= 0.35 * abs(fd) + 5e-3, (fd, g_edge)


def test_shadow_silhouette_gradient_matches_fd():
    """d(x-weighted mean image)/d(occluder x-shift) with the occluder off
    camera: interior and primary terms are zero, the NEE shadow term
    recovers the FD truth within Monte-Carlo tolerance."""
    js, tris, occ_ids = shadow_scene()
    scene = _port(js)
    et = build_edge_table(tris, device="cpu")
    size = 32
    cam = T.make_camera(pos=(0.0, 0.8, 3.0), dist_from_film=1.0,
                        focal_length=3.0, width=size, height=size,
                        device="cpu")
    cfg = T.RenderConfig(width=size, height=size, spp=1,
                         integrator="pt_nee", jitter=False,
                         traversal="brute", num_bounces=2)
    key = prng_key(7, "cpu")
    SPP = 8
    SPP_FD = 256
    SES = 32768
    qsel = torch.zeros(scene.verts.x.shape[0])
    qsel[occ_ids] = 1.0
    px, _ = morton_decode(torch.arange(size * size))
    wx = px.to(torch.float32) / size - 0.5

    def func(dx, ses, spp=SPP):
        verts = scene.verts._replace(x=scene.verts.x + dx * qsel)
        img = rg.render_image_diff(scene._replace(verts=verts), cam, cfg,
                                   key, spp, edge_table=et,
                                   shadow_edge_samples=ses)
        return torch.mean((img.x + img.y + img.z) / 3.0 * wx)

    def grad(ses):
        dx = torch.zeros((), requires_grad=True)
        return float(torch.autograd.grad(func(dx, ses), dx)[0])

    g_int = grad(0)
    g_shadow = grad(SES)
    eps = 0.06
    with torch.no_grad():
        fd = (float(func(eps, 0, SPP_FD))
              - float(func(-eps, 0, SPP_FD))) / (2 * eps)
    print(f"fd={fd:.5f} interior={g_int:.5f} with_shadow={g_shadow:.5f}")
    assert np.isfinite(fd) and np.isfinite(g_shadow)
    assert abs(g_int) < 0.05 * abs(fd), (g_int, fd)
    assert abs(g_shadow - fd) < abs(g_int - fd), (g_int, g_shadow, fd)
    assert fd * g_shadow > 0, (fd, g_shadow)
    assert 0.45 < g_shadow / fd < 1.5, (fd, g_shadow)
