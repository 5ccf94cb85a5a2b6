"""The port's differentiable pass (cudapathtracer_tpu_torch/diff/) on the
CPU: parity with the JAX package on the same scenes and keys, and the
finite-difference checks of tests/test_diff.py and test_spheres.py with
their sizes and rules, on the port alone (test_inverse.py's recovery is
tests/test_torch_inverse.py).

Parity tolerances. The hit ids, the sample keys and the primal are the JAX
package's (the primal under ``assert_pixels_close``, the loss to rtol
1e-5). The gradients cannot match bit for bit: XLA contracts the backward
into fused multiply-adds of its own and sums the pixels and the gathers'
cotangents in another order. Measured on this suite's cases: the albedo and
emission gradients within rtol 2.9e-5 of the JAX package's (bound: rtol
1e-4), the vertex and sphere gradients within 2.1e-6 of each array's
largest |g| (bound: 1e-3 of it)."""

import numpy as np
import pytest
import torch
from torch_fold_cases import assert_pixels_close

import jax
import jax.numpy as jnp

import cudapathtracer_tpu as J
from cudapathtracer_tpu.diff import render_grad as jrg
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.models.scene import recompute_derived as j_recompute
from cudapathtracer_tpu.ops import intersect as jint
from cudapathtracer_tpu.ops.vecmath import Vec3 as JVec3
from cudapathtracer_tpu.render.renderer import build_bvh_for_scene as jbvh

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import convert
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.diff.edge_sampling import build_edge_table
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.models.scene import recompute_derived
from cudapathtracer_tpu_torch.ops import intersect as tint
from cudapathtracer_tpu_torch.ops import packets, traversal
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.ops.vecmath import Vec3
from cudapathtracer_tpu_torch.render.renderer import (build_bvh_for_scene,
                                                      init_accum,
                                                      make_trace_fn,
                                                      render_batch)

# gradient parity bounds (module docstring)
RTOL_MATERIAL = 1e-4
FRAC_OF_MAX_GEOMETRY = 1e-3
RTOL_LOSS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process (tests/test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv(a, grad=False):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                  .requires_grad_(grad) for i in range(3)))


def _np(v):
    return np.stack([np.asarray(c.detach() if torch.is_tensor(c) else c)
                     for c in v], axis=1)


# ---------------------------------------------------------------------------
# the scenes, both packages
# ---------------------------------------------------------------------------

class Case:
    """One scene at 8x8 in both packages, with its accel structures."""

    def __init__(self, scene, integrator="pt_nee", traversal="packets",
                 size=8, spp=2):
        if scene == "sphere":
            self.js = jproc.cornell_with_analytic_sphere()
            self.ts = tproc.cornell_with_analytic_sphere(device="cpu")
        else:
            self.js = jproc.to_scene(jproc.cornell_box(with_boxes=False))
            self.ts = tproc.to_scene(tproc.cornell_box(with_boxes=False),
                                     "cpu")
        kw = dict(width=size, height=size, spp=spp, integrator=integrator,
                  samples_per_call=spp, traversal=traversal)
        self.jcfg = J.RenderConfig(**kw)
        self.tcfg = T.RenderConfig(**kw)
        self.jcam = J.make_camera(width=size, height=size)
        self.tcam = T.make_camera(width=size, height=size, device="cpu")
        self.jb = jbvh(self.js, 4) if traversal != "brute" else None
        self.tb = (build_bvh_for_scene(self.ts, 4)
                   if traversal != "brute" else None)
        self.spp = spp


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX references, each built at most once: the primal images and
    the jitted value_and_grad of the loss, keyed by case."""
    cache = {}

    def get(kind, scene, integrator, traversal):
        key = (kind, scene, integrator, traversal)
        if key in cache:
            return cache[key]
        c = Case(scene, integrator, traversal,
                 size=PRIMAL_SIZE if kind == "primal" else 8)
        if kind == "primal":
            out = jrg.render_image_diff(c.js, c.jcam, c.jcfg,
                                        jax.random.PRNGKey(9), c.spp,
                                        bvh=c.jb)
        else:
            target = jrg.render_image_diff(c.js, c.jcam, c.jcfg,
                                           jax.random.PRNGKey(99), 1,
                                           bvh=c.jb)
            loss_fn = jrg.make_loss_fn(c.js, c.jcam, c.jcfg,
                                       jax.random.PRNGKey(0), c.spp,
                                       bvh=c.jb)
            loss, g = jax.jit(jax.value_and_grad(loss_fn))(
                jrg.targets_of(c.js), target)
            out = (target, float(loss), convert.targets_from_jax(
                convert.to_numpy_dict(g), "cpu"))
        cache[key] = (c, out)
        return cache[key]

    return get


# ---------------------------------------------------------------------------
# the building blocks against the JAX package
# ---------------------------------------------------------------------------

def test_recompute_derived_matches_jax():
    """Normals and the light area from perturbed vertices: values, and the
    gradient of a scalar of both w.r.t. the vertices."""
    js = jproc.to_scene(jproc.cornell_box())
    rng = np.random.default_rng(0)
    verts = _np(js.verts) + rng.normal(0, 0.01, _np(js.verts).shape).astype(
        np.float32)
    w = rng.normal(size=(js.num_tris, 3)).astype(np.float32)

    def jscalar(v):
        s = j_recompute(js._replace(verts=v))
        n = s.tri_norm
        return (jnp.sum(n.x * w[:, 0] + n.y * w[:, 1] + n.z * w[:, 2])
                + 3.0 * s.total_light_area), s

    (jval, js2), jg = jax.jit(jax.value_and_grad(jscalar, has_aux=True))(
        _jv(verts))
    ts = convert.scene_from_jax(convert.to_numpy_dict(js), "cpu")
    tv = _tv(verts, grad=True)
    ts2 = recompute_derived(ts._replace(verts=tv))
    n = ts2.tri_norm
    wt = torch.from_numpy(w)
    tval = ((n.x * wt[:, 0] + n.y * wt[:, 1] + n.z * wt[:, 2]).sum()
            + 3.0 * ts2.total_light_area)
    tg = torch.autograd.grad(tval, list(tv))
    # XLA's rsqrt is not correctly rounded (torch_fold_cases.py)
    np.testing.assert_allclose(_np(n), _np(js2.tri_norm), rtol=0,
                               atol=2.4e-7)
    np.testing.assert_allclose(float(ts2.total_light_area.detach()),
                               float(js2.total_light_area), rtol=1e-6)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-5, atol=1e-5)


def _hit_rays(seed, n=10_000):
    """Rays that hit a random triangle at a known interior point (t in
    [0.5, 5]) and rays that enter a random sphere, each at least 0.3 from
    grazing (|cos| between the ray and the surface normal), where t's
    gradient is well conditioned."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def unit(m):
        v = rng.normal(size=(m, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def away_from_grazing(nrm):
        d = unit(n)
        cos = np.sum(d * nrm, axis=1)
        while (bad := np.abs(cos) < 0.3).any():
            d[bad] = unit(int(bad.sum()))
            cos = np.sum(d * nrm, axis=1)
        return d, cos

    v0, v1, v2 = (rng.normal(0, 1, (n, 3)) for _ in range(3))
    b = rng.dirichlet((2.0, 2.0, 2.0), n)
    p = b[:, :1] * v0 + b[:, 1:2] * v1 + b[:, 2:] * v2
    nt = np.cross(v1 - v0, v2 - v0)
    d, _ = away_from_grazing(nt / np.linalg.norm(nt, axis=1, keepdims=True))
    t = rng.uniform(0.5, 5.0, (n, 1))
    tri = tuple(a.astype(f) for a in (p - d * t, d, v0, v1, v2))
    c = rng.normal(0, 1, (n, 3))
    r = rng.uniform(0.1, 1.6, n)
    nrm = unit(n)
    d, cos = away_from_grazing(nrm)
    d = np.where((cos < 0)[:, None], d, -d)  # entering at c + r * nrm
    sph = tuple(a.astype(f) for a in ((c + r[:, None] * nrm) - d * t, d, c,
                                      r))
    return tri, sph


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unchecked_t_matches_jax(seed):
    """t equal to the jitted JAX functions (inputs as arguments) on every
    ray. jax.grad of a weighted sum of t against autograd: rtol 1e-5 plus
    1e-4 of each array's largest |g|. The backward's rounding differs (XLA
    contracts it), and where a gradient's terms cancel rtol 1e-5 alone
    fails on up to 5% of the elements; measured on these seeds, no gap
    exceeds 4.6e-5 of the array's largest |g|."""
    tri, sph = _hit_rays(seed)
    w = np.random.default_rng(seed + 10).normal(size=10_000).astype(
        np.float32)
    for jfn, tfn, args in (
            (jint.ray_triangle_t_unchecked, tint.ray_triangle_t_unchecked,
             tri),
            (jint.ray_sphere_t_unchecked, tint.ray_sphere_t_unchecked, sph)):
        jargs = [_jv(a) if a.ndim == 2 else jnp.asarray(a) for a in args]
        targs = [_tv(a, grad=True) if a.ndim == 2
                 else torch.from_numpy(a).requires_grad_() for a in args]
        jt = np.asarray(jax.jit(jfn)(*jargs))
        tt = tfn(*targs)
        np.testing.assert_array_equal(tt.detach().numpy().view(np.uint32),
                                      jt.view(np.uint32))
        if jfn is jint.ray_triangle_t_unchecked:
            # the hit-tested form on the same vertices: every ray hits
            want = np.asarray(jax.jit(jint.ray_triangle_verts)(*jargs))
            got = tint.ray_triangle_verts(*targs).detach().numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
            assert (got < 1e5).all()
        jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                              argnums=tuple(range(len(args)))))(*jargs)
        leaves = [c for a in targs for c in (a if isinstance(a, Vec3)
                                             else (a,))]
        tg = torch.autograd.grad((tt * torch.from_numpy(w)).sum(), leaves)
        jleaves = [c for a in jg for c in (a if isinstance(a, JVec3)
                                           else (a,))]
        for g_t, g_j in zip(tg, jleaves):
            g_j = np.asarray(g_j)
            np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-5,
                                       atol=1e-4 * np.abs(g_j).max())


@pytest.mark.parametrize("engine", ["packets", "bvh", "brute", "spheres"])
def test_trace_is_detached(engine):
    """A trace given inputs that require grad returns hits that require
    none and builds no graph: the kernels' wrappers and the plain versions
    never see such a tensor (the JAX package's stop_gradient)."""
    if engine == "spheres":
        scene = tproc.cornell_with_analytic_sphere(device="cpu")
    else:
        scene = tproc.to_scene(tproc.cornell_box(), "cpu")
    bvh = build_bvh_for_scene(scene, 4)
    p = rg.targets_of(scene)
    gscene = rg.scene_with(scene, p)
    cam = T.make_camera(width=8, height=8, device="cpu")
    idx = torch.arange(64)
    from cudapathtracer_tpu_torch.ops.rng import pixel_keys, sample_key
    from cudapathtracer_tpu_torch.render.camera import camera_rays
    o, d = camera_rays(cam, idx, pixel_keys(sample_key(
        prng_key(0, "cpu"), 0), idx))
    o = Vec3(*(c + 0.0 * p.verts.x.sum() for c in o))
    assert o.x.requires_grad
    mask = torch.ones(64, dtype=torch.bool)
    cfg = T.RenderConfig(width=8, height=8, spp=1, integrator="pt_nee",
                         traversal="bvh" if engine == "bvh" else
                         "brute" if engine == "brute" else "packets")
    hits = [make_trace_fn(gscene, cfg, bvh)(o, d, mask,
                                            t_cap=o.x * 0 + 50.0)]
    if engine == "packets":
        # the packet data built with gradients, passed straight in
        pd = packets.make_packet_data(
            gscene, Vec3(bvh.cl_lo_x, bvh.cl_lo_y, bvh.cl_lo_z),
            Vec3(bvh.cl_hi_x, bvh.cl_hi_y, bvh.cl_hi_z), bvh.cl_tri)
        assert pd.v0.x.requires_grad
        hits.append(packets.trace_packets(o, d, pd, mask=mask,
                                          tile_size=32, sort=True))
    if engine == "bvh":
        td = traversal.make_trace_data(gscene, bvh.fine)
        assert td.leaf_v0.x.requires_grad
        hits.append(traversal.trace(o, d, td, mask=mask))
    if engine == "spheres":
        h = hits[0]
        hits.append(traversal.trace_spheres(o, d, gscene, h.t, h.tri))
        assert bool((h.tri >= gscene.num_tris).any())
    for h in hits:
        assert not h.t.requires_grad and h.t.grad_fn is None
        assert bool((h.tri >= 0).any())


# ---------------------------------------------------------------------------
# the differentiable render against the JAX package
# ---------------------------------------------------------------------------

# 16^2: the per-pixel rule admits 1% of the values past rtol 3e-6, and
# one pixel of an 8^2 image is 1.6% of them. The residue here: XLA
# contracts the re-evaluated t differently inside the sample's scan than
# jitted alone (which the port matches bit for bit), so on the 8^2 renders
# the JAX package's own forward render and its differentiable one differ
# on a pixel (BDPT pixel 47 by 5.8e-6, the sphere scene's pixel 39 by
# 8.8e-6), and the port agrees with one or the other.
PRIMAL_SIZE = 16
PRIMAL_CASES = [("cornell", "pt_nee", "packets"),
                ("cornell", "pt_nee", "brute"),
                ("cornell", "bdpt", "packets"),
                ("cornell", "bdpt", "brute"),
                ("sphere", "pt_nee", "packets")]


@pytest.mark.parametrize("scene,integrator,trav", PRIMAL_CASES)
def test_render_image_diff_primal_matches_jax(jax_refs, scene, integrator,
                                              trav):
    c, want = jax_refs("primal", scene, integrator, trav)
    with torch.no_grad():
        got = rg.render_image_diff(c.ts, c.tcam, c.tcfg, prng_key(9, "cpu"),
                                   c.spp, bvh=c.tb)
    assert_pixels_close(got, want)


GRAD_CASES = [("cornell", "pt_nee", "packets"),
              ("cornell", "bdpt", "packets"),
              ("sphere", "pt_nee", "packets")]


@pytest.mark.parametrize("scene,integrator,trav", GRAD_CASES)
def test_render_and_grad_matches_jax(jax_refs, scene, integrator, trav):
    """The loss to rtol 1e-5; albedo and emission to rtol 1e-4; vertex and
    sphere gradients within 1e-3 of each array's largest |g| (module
    docstring: measured 2.9e-5 and 2.1e-6)."""
    c, (jtarget, jloss, jg) = jax_refs("grad", scene, integrator, trav)
    target = Vec3(*(torch.tensor(np.asarray(a)) for a in jtarget))
    loss, g = rg.render_and_grad(c.ts, c.tcam, c.tcfg, prng_key(0, "cpu"),
                                 c.spp, target, bvh=c.tb)
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL_LOSS)
    for field in ("albedo", "emission"):
        for a, b in zip(getattr(g, field), getattr(jg, field)):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=RTOL_MATERIAL, atol=1e-9)
    geometry = [*g.verts, *g.sph_center, g.sph_radius]
    jgeometry = [*jg.verts, *jg.sph_center, jg.sph_radius]
    for a, b in zip(geometry, jgeometry):
        assert torch.isfinite(a).all()
        if b.numel():
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= \
                FRAC_OF_MAX_GEOMETRY * scale + 1e-12
    if scene == "sphere":
        assert float(g.sph_radius.abs().max()) > 0


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell():
    return Case("cornell")


def _grads(c, spp, **kw):
    target = Vec3(*(torch.full((64,), 0.3) for _ in range(3)))
    return rg.render_and_grad(c.ts, c.tcam, c.tcfg, prng_key(0, "cpu"),
                              spp, target, bvh=c.tb, **kw)


@pytest.mark.parametrize("form", ["unchecked", "all_checkpointed"])
@pytest.mark.parametrize("spp,terms", [(1, 0), (2, 0), (3, 0), (2, 256)],
                         ids=["spp1", "spp2", "spp3", "spp2_both_terms"])
def test_checkpoint_matches_unchecked_bitwise(cornell, monkeypatch, spp,
                                              terms, form):
    """The checkpoint policy (every sample but the last recomputed in the
    backward, the last keeping its graph) changes no bit of the loss or
    the gradients: against every sample unchecked, and against every
    sample checkpointed."""
    kw = dict(edge_samples=terms, shadow_edge_samples=terms)
    calls = []
    real = rg.checkpoint

    def counted(fn, *a, **k):
        calls.append(a[0])
        return real(fn, *a, **k)

    monkeypatch.setattr(rg, "checkpoint", counted)
    loss, g = _grads(cornell, spp, **kw)
    assert calls == list(range(spp - 1))
    if form == "unchecked":
        monkeypatch.setattr(rg, "checkpoint", lambda fn, *a, **k: fn(*a))
    else:
        calls.clear()
        monkeypatch.setattr(rg, "_checkpointed", lambda s, n: True)
    loss0, g0 = _grads(cornell, spp, **kw)
    if form == "all_checkpointed":
        assert calls == list(range(spp))
    assert float(loss) == float(loss0)
    for a, b in zip(rg.target_leaves(g), rg.target_leaves(g0)):
        assert torch.equal(a, b)


def test_tiles_equal_whole(cornell):
    """Two Morton half-tiles put together equal the whole image: the
    renderer's ``render_batch(idx=)``, and ``render_image_diff(idx=)``
    with both boundary terms, whose gradients add up to the whole's."""
    c = cornell
    key = prng_key(5, "cpu")
    whole = render_batch(c.ts, c.tb, c.tcam, c.tcfg, key,
                         init_accum(c.tcfg, device="cpu"), 2)
    halves = [torch.arange(0, 32), torch.arange(32, 64)]
    parts = [render_batch(c.ts, c.tb, c.tcam, c.tcfg, key,
                          init_accum(c.tcfg, device="cpu", num_pixels=32),
                          2, idx=i) for i in halves]
    for k in range(3):
        assert torch.equal(torch.cat([p.img[k] for p in parts]),
                           whole.img[k])
    with pytest.raises(ValueError):
        render_batch(c.ts, c.tb, c.tcam, c.tcfg, key,
                     init_accum(c.tcfg, device="cpu"), 1, idx=halves[0])

    et = build_edge_table(c.ts.host_tris, device="cpu")
    w = torch.linspace(0.5, 1.5, 64)

    def run(idx):
        p = rg.targets_of(c.ts)
        img = rg.render_image_diff(rg.scene_with(c.ts, p), c.tcam, c.tcfg,
                                   key, 1, bvh=c.tb, idx=idx,
                                   edge_samples=256, edge_table=et,
                                   shadow_edge_samples=256)
        sel = slice(None) if idx is None else idx
        s = sum((ch * w[sel]).sum() for ch in img)
        return img, torch.autograd.grad(s, list(p.verts))

    img, gw = run(None)
    tiles = [run(i) for i in halves]
    for k in range(3):
        assert torch.equal(torch.cat([t[0][k] for t in tiles]).detach(),
                           img[k].detach())
    for k in range(3):
        gsum = tiles[0][1][k] + tiles[1][1][k]
        scale = float(gw[k].abs().max())
        assert scale > 0
        assert float((gsum - gw[k]).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# finite differences (tests/test_diff.py, test_spheres.py, test_inverse.py)
# ---------------------------------------------------------------------------

def _fd_check(f, x0, g, eps, indices, rtol, atol):
    """Central finite differences on a few coordinates of a flat array
    (tests/test_diff.py:_fd_check)."""
    max_err = 0.0
    for i in indices:
        xp = x0.clone()
        xp[i] += eps
        xm = x0.clone()
        xm[i] -= eps
        fd = (f(xp) - f(xm)) / (2 * eps)
        err = abs(fd - float(g[i]))
        denom = max(abs(fd), abs(float(g[i])), atol)
        assert err <= rtol * denom + atol, (
            f"coord {i}: fd={fd:.6g} ad={float(g[i]):.6g} err={err:.3g}")
        max_err = max(max_err, err)
    return max_err


def _fd_setup(c, target_seed, spp=2):
    with torch.no_grad():
        target = rg.render_image_diff(c.ts, c.tcam, c.tcfg,
                                      prng_key(target_seed, "cpu"), 1,
                                      bvh=c.tb)
    loss_fn = rg.make_loss_fn(c.ts, c.tcam, c.tcfg, prng_key(0, "cpu"),
                              spp, bvh=c.tb)
    loss, grads = rg.render_and_grad(c.ts, c.tcam, c.tcfg,
                                     prng_key(0, "cpu"), spp, target,
                                     bvh=c.tb)
    p0 = rg.targets_of(c.ts)

    def f(**fields):
        p = p0._replace(**fields)
        with torch.no_grad():
            return float(loss_fn(p, target))

    return loss, grads, p0, f


def test_grad_albedo_fd(cornell):
    loss, grads, p0, f = _fd_setup(cornell, 99)
    assert np.isfinite(float(loss))

    def f_alb(ax):
        return f(albedo=p0.albedo._replace(x=ax))

    _fd_check(f_alb, p0.albedo.x.detach(), grads.albedo.x, eps=1e-3,
              indices=range(p0.albedo.x.shape[0]), rtol=2e-2, atol=1e-5)


def test_grad_emission_fd(cornell):
    _, grads, p0, f = _fd_setup(cornell, 7)

    def f_em(ey):
        return f(emission=p0.emission._replace(y=ey))

    # the light's material is index 3
    _fd_check(f_em, p0.emission.y.detach(), grads.emission.y, eps=1e-2,
              indices=[3], rtol=2e-2, atol=1e-6)


def test_grad_verts_fd_interior(cornell):
    """The light quad's height: interior-dominant, compared with FD."""
    _, grads, p0, f = _fd_setup(cornell, 3)
    g = grads.verts.y
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    ts = cornell.ts
    vid = int(ts.tri_v0[int(ts.lights[0])])

    def f_v(vy):
        return f(verts=p0.verts._replace(y=vy))

    _fd_check(f_v, p0.verts.y.detach(), g, eps=5e-3, indices=[vid],
              rtol=0.15, atol=1e-4)


def test_grads_zero_for_unseen_material(cornell):
    c = cornell
    ts = c.ts

    def cat(v, val):
        return Vec3(*(torch.cat([a, torch.tensor([val])]) for a in v))

    s2 = ts._replace(mat_albedo=cat(ts.mat_albedo, 0.5),
                     mat_emission=cat(ts.mat_emission, 0.0))
    with torch.no_grad():
        target = rg.render_image_diff(s2, c.tcam, c.tcfg, prng_key(1, "cpu"),
                                      1, bvh=c.tb)
    _, g = rg.render_and_grad(s2, c.tcam, c.tcfg, prng_key(0, "cpu"), 1,
                              target, bvh=c.tb)
    assert float(g.albedo.x[-1].abs()) == 0.0


def test_bdpt_also_differentiable(cornell):
    c = Case("cornell", "bdpt", spp=1)
    with torch.no_grad():
        target = rg.render_image_diff(c.ts, c.tcam, c.tcfg,
                                      prng_key(2, "cpu"), 1, bvh=c.tb)
    loss, g = rg.render_and_grad(c.ts, c.tcam, c.tcfg, prng_key(0, "cpu"),
                                 1, target, bvh=c.tb)
    assert np.isfinite(float(loss))
    assert torch.isfinite(g.albedo.x).all() and torch.isfinite(g.verts.x).all()


def test_sphere_grads_finite_difference():
    """d(loss)/d(radius) through the sphere re-evaluation against FD
    (tests/test_spheres.py:74): sign and scale, since FD also sees the
    silhouette motion the interior estimator does not model."""
    c = Case("sphere")
    with torch.no_grad():
        target = rg.render_image_diff(c.ts, c.tcam, c.tcfg,
                                      prng_key(9, "cpu"), 1, bvh=c.tb)
    loss_fn = rg.make_loss_fn(c.ts, c.tcam, c.tcfg, prng_key(0, "cpu"), 2,
                              bvh=c.tb)
    loss, grads = rg.render_and_grad(c.ts, c.tcam, c.tcfg,
                                     prng_key(0, "cpu"), 2, target,
                                     bvh=c.tb)
    assert np.isfinite(float(loss))
    g = float(grads.sph_radius[0])
    assert np.isfinite(g)
    p0 = rg.targets_of(c.ts)
    eps = 1e-3

    def f(r):
        with torch.no_grad():
            return float(loss_fn(p0._replace(sph_radius=r), target))

    r0 = p0.sph_radius.detach()
    fd = (f(r0 + eps) - f(r0 - eps)) / (2 * eps)
    assert np.isfinite(fd)
    if abs(fd) > 1e-4:
        assert abs(g - fd) <= 0.5 * max(abs(fd), abs(g)) + 1e-3, (g, fd)
