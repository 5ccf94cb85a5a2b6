"""The reference's quirk flags (``RenderConfig.orthonormal_frame``,
``light_normal_mode``, ``branch_pdf_correction``, ``jitter``,
``compensated_accum``) through the port, held against the JAX package on
the CPU with the same inputs.

* Renders: ``render`` (through ``render_batch``) of
  ``cornell_with_sphere_mesh(subdiv=2)``, seed 9, 2 spp, for each flag
  with each integrator that reads it, under the per-pixel rule
  (``torch_fold_cases.assert_pixels_close``); each flag must change its
  image in both packages. ``jitter`` turns the primary-hit reuse off. The
  renders are 16^2, but two cases change no pixel there: the BDPT render
  without compensation, and ``orthonormal_frame`` (few pixels see the
  sphere). At 32^2 they change 5 pixels, and 2 of either integrator's, so
  they are held at 32^2 beside the defaults there. At 32^2 the
  rule admits flipped pixels (``RSQRT_FLIP_SHARE``): XLA:CPU's rsqrt
  residue (``assert_pixels_close``) sends one ray of the DEFAULT render's
  pixel 63 down another path in both integrators (0.1768 against 0 in
  pt_nee's red). With the JAX package's normalize made correctly rounded
  (``jax_normalize_rounded``), the 32^2 cases agree with no pixel
  flipped (``test_32_flips_are_the_rsqrt_residue``).
* Samplers: both hemisphere samplers, with the orthonormal frame and
  without, on 100,000 random unit normals against the jitted JAX ones, to
  atol 4e-7 (tests/test_torch_bdpt.py's bound: XLA's cos, sin and rsqrt
  round otherwise by an ulp or two).
* Camera: jittered pinhole rays under ``test_camera_rays_match``'s bounds.
* Gradients: ``render_and_grad`` with ``branch_pdf_correction`` and with
  ``light_normal_mode="true"`` through the shadow boundary term
  (tests/test_torch_edge_sampling.py's shadow scene) against the JAX
  package's value and gradient, under the differentiable pass's bounds
  (tests/test_torch_diff.py: the loss to rtol 1e-5, materials to rtol
  1e-4, vertices within 1e-3 of each array's largest |g|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_edge_sampling import shadow_scene
from torch_fold_cases import (MT_SEAM_FLIP_SHARE, assert_pixels_close,
                              jax_normalize_rounded)

import cudapathtracer_tpu as J
from cudapathtracer_tpu.diff import render_grad as jrg
from cudapathtracer_tpu.diff.edge_sampling import build_edge_table as jbet
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.ops import sampling as jsamp
from cudapathtracer_tpu.ops.vecmath import Vec3 as JVec3
from cudapathtracer_tpu.render import camera as jcam

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import convert
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import rng as trng
from cudapathtracer_tpu_torch.ops import sampling as tsamp
from cudapathtracer_tpu_torch.ops.vecmath import Vec3
from cudapathtracer_tpu_torch.render import camera as tcam

SPP = 2
SEED = 9
# (integrator, flags, size): each flag with each integrator that reads it,
# the default of each integrator at each size
RENDER_CASES = (
    ("pt_nee", {}, 16),
    ("pt_nee", {"light_normal_mode": "true"}, 16),
    ("pt_nee", {"branch_pdf_correction": True}, 16),
    ("pt_nee", {"compensated_accum": False}, 16),
    ("pt_nee", {"jitter": True}, 16),
    ("bdpt", {}, 16),
    ("pt_nee", {}, 32),
    ("pt_nee", {"orthonormal_frame": True}, 32),
    ("bdpt", {}, 32),
    ("bdpt", {"orthonormal_frame": True}, 32),
    ("bdpt", {"compensated_accum": False}, 32),
)
# the share of pixels the per-pixel rule lets the rsqrt residue flip at
# 32^2 (module docstring): the rule's seam-flip share
RSQRT_FLIP_SHARE = {16: 0.0, 32: MT_SEAM_FLIP_SHARE}
SAMPLER_ATOL = 4e-7
RTOL_LOSS = 1e-5
RTOL_MATERIAL = 1e-4
FRAC_OF_MAX_GEOMETRY = 1e-3
SHADOW_EDGE_SAMPLES = 4096


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process (tests/test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case_id(integrator, flags, size):
    return f"{integrator}-{size}" + "".join(f"-{k}={v}"
                                            for k, v in flags.items())


def _cfg(pkg, integrator, flags, size):
    return pkg.RenderConfig(width=size, height=size, spp=SPP,
                            integrator=integrator, samples_per_call=SPP,
                            **flags)


@pytest.fixture(scope="module")
def jax_renders():
    """The JAX package's render of every case, built once (XLA:CPU compiles
    pile up; pytest.ini)."""
    scene = jproc.to_scene(jproc.cornell_with_sphere_mesh(subdiv=2))
    return {_case_id(*c): J.render(scene, J.make_camera(width=c[2],
                                                        height=c[2]),
                                   _cfg(J, *c), seed=SEED)
            for c in RENDER_CASES}


@pytest.fixture(scope="module")
def port_render():
    """The port's render of a case, each made once."""
    scene = tproc.to_scene(tproc.cornell_with_sphere_mesh(subdiv=2), "cpu")
    cache = {}

    def get(integrator, flags, size):
        key = _case_id(integrator, flags, size)
        if key not in cache:
            cam = T.make_camera(width=size, height=size, device="cpu")
            cache[key] = T.render(scene, cam,
                                  _cfg(T, integrator, flags, size),
                                  seed=SEED, device="cpu")
        return cache[key]

    return get


@pytest.mark.parametrize("integrator,flags,size", [
    pytest.param(*c, id=_case_id(*c)) for c in RENDER_CASES])
def test_quirk_render_matches_jax(jax_renders, port_render, integrator,
                                  flags, size):
    want = jax_renders[_case_id(integrator, flags, size)]
    got = port_render(integrator, flags, size)
    assert got.n == int(want.n) == SPP
    assert_pixels_close(got.img, want.img, RSQRT_FLIP_SHARE[size])
    assert float(got.img.x.max()) > 0
    if flags:
        base = port_render(integrator, {}, size)
        jbase = jax_renders[_case_id(integrator, {}, size)]
        changed = sum(int((a != b).sum()) for a, b in zip(got.img, base.img))
        jchanged = sum(int((np.asarray(a) != np.asarray(b)).sum())
                       for a, b in zip(want.img, jbase.img))
        assert changed > 0 and jchanged > 0, (changed, jchanged)


def _unit_normals(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((3, n))
    return [c.astype(np.float32) for c in v / np.linalg.norm(v, axis=0)]


@pytest.mark.parametrize("orthonormal", [False, True])
@pytest.mark.parametrize("sampler", ["uniform_hemisphere",
                                     "cosine_hemisphere"])
def test_sampler_matches_jax(sampler, orthonormal):
    """Both hemisphere samplers against the jitted JAX ones, in both
    tangent frames; the orthonormal frame must move the directions."""
    rng = np.random.default_rng(11)
    n = _unit_normals(100_000, 12)
    u1, u2 = (rng.uniform(0, 1, 100_000).astype(np.float32)
              for _ in range(2))
    want = jax.jit(lambda n, a, b: getattr(jsamp, sampler)(
        JVec3(*n), a, b, orthonormal=orthonormal))(n, u1, u2)
    tn = Vec3(*map(torch.from_numpy, n))
    tu1, tu2 = torch.from_numpy(u1), torch.from_numpy(u2)
    got = getattr(tsamp, sampler)(tn, tu1, tu2, orthonormal=orthonormal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=SAMPLER_ATOL)
    if orthonormal:
        other = getattr(tsamp, sampler)(tn, tu1, tu2)
        assert any(bool((a != b).any()) for a, b in zip(got, other))


def test_camera_rays_jitter_matches_jax():
    """Jittered pinhole rays against the JAX camera under jit: origins
    exact, directions within 2 ulp (XLA's rsqrt against the correctly
    rounded one, ``test_camera_rays_match``)."""
    W = 32
    jc = J.make_camera(pos=(0.0, 2.0, 3.4), focal_length=2.0, width=W,
                       height=W)
    tc = T.make_camera(pos=(0.0, 2.0, 3.4), focal_length=2.0, width=W,
                       height=W, device="cpu")
    idx = jnp.arange(W * W, dtype=jnp.uint32)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(7), 2), i))(idx)
    jo, jd = jax.jit(lambda k: jcam.camera_rays(jc, idx, k, jitter=True,
                                                lens=False))(keys)
    tkeys = trng.pixel_keys(trng.sample_key(trng.prng_key(7, "cpu"), 2),
                            torch.arange(W * W))
    to, td = tcam.camera_rays(tc, torch.arange(W * W), tkeys, jitter=True,
                              lens=False)
    _, still = tcam.camera_rays(tc, torch.arange(W * W), tkeys, lens=False)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jd, td):
        np.testing.assert_array_max_ulp(np.asarray(a), b.numpy(), 2)
    assert any(bool((a != b).any()) for a, b in zip(td, still))


@pytest.fixture(scope="module")
def shadow_case():
    """The shadow scene at 16^2 (tests/test_torch_edge_sampling.py's shadow
    parity case) in both packages, its edge table and a constant target."""
    js, tris, _ = shadow_scene()
    camkw = dict(pos=(0.0, 0.8, 3.0), dist_from_film=1.0, focal_length=3.0)
    return dict(js=js, ts=convert.scene_from_jax(convert.to_numpy_dict(js),
                                                 "cpu"),
                jet=jbet(tris), jcam=J.make_camera(width=16, height=16,
                                                   **camkw),
                tcam=T.make_camera(width=16, height=16, device="cpu",
                                   **camkw),
                target=np.full((16 * 16,), 0.05, np.float32))


def _shadow_grads(case, flags):
    """(JAX (loss, GradTargets), the port's (loss, GradTargets)) of the L2
    loss against the constant target, the shadow term at
    SHADOW_EDGE_SAMPLES."""
    kw = dict(width=16, height=16, spp=1, integrator="pt_nee",
              traversal="brute", jitter=False, num_bounces=2, **flags)
    jcfg, tcfg = J.RenderConfig(**kw), T.RenderConfig(**kw)
    jtarget = JVec3(*([jnp.asarray(case["target"])] * 3))
    ttarget = Vec3(*([torch.from_numpy(case["target"])] * 3))

    def jf(p):
        img = jrg.render_image_diff(
            jrg.scene_with(case["js"], p), case["jcam"], jcfg,
            jax.random.PRNGKey(7), 1, edge_table=case["jet"],
            shadow_edge_samples=SHADOW_EDGE_SAMPLES)
        return jrg.l2_loss(img, jtarget)

    jloss, jg = jax.jit(jax.value_and_grad(jf))(jrg.targets_of(case["js"]))
    tloss, tg = rg.render_and_grad(
        case["ts"], case["tcam"], tcfg, trng.prng_key(7, "cpu"), 1, ttarget,
        shadow_edge_samples=SHADOW_EDGE_SAMPLES)
    return (float(jloss), convert.targets_from_jax(
        convert.to_numpy_dict(jg), "cpu")), (float(tloss), tg)


@pytest.mark.parametrize("flags", [{"branch_pdf_correction": True},
                                   {"light_normal_mode": "true"}],
                         ids=lambda f: "-".join(f"{k}={v}"
                                                for k, v in f.items()))
def test_render_and_grad_quirk_matches_jax(shadow_case, flags):
    """The loss and the gradients with the flag against the JAX package's;
    the flag must move the port's loss or gradients off the default's."""
    (jloss, jg), (tloss, tg) = _shadow_grads(shadow_case, flags)
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL_LOSS)
    for field in ("albedo", "emission"):
        for a, b in zip(getattr(tg, field), getattr(jg, field)):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=RTOL_MATERIAL, atol=1e-9)
    for a, b in zip(tg.verts, jg.verts):
        assert torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= \
            FRAC_OF_MAX_GEOMETRY * scale + 1e-12
    dloss, dg = rg.render_and_grad(
        shadow_case["ts"], shadow_case["tcam"],
        T.RenderConfig(width=16, height=16, spp=1, integrator="pt_nee",
                       traversal="brute", jitter=False, num_bounces=2),
        trng.prng_key(7, "cpu"), 1,
        Vec3(*([torch.from_numpy(shadow_case["target"])] * 3)),
        shadow_edge_samples=SHADOW_EDGE_SAMPLES)
    assert float(dloss) != tloss or any(
        not torch.equal(a, b) for a, b in zip(rg.target_leaves(dg),
                                              rg.target_leaves(tg)))


@pytest.mark.parametrize("integrator,flags,size", [
    pytest.param(*c, id=_case_id(*c)) for c in RENDER_CASES
    if c[2] == 32 and c[1]])
def test_32_flips_are_the_rsqrt_residue(port_render, integrator, flags,
                                        size):
    """The 32^2 cases against the JAX package with its normalize correctly
    rounded: the per-pixel rule holds with no pixel flipped, so the flips
    the rule admits at 32^2 are XLA:CPU's rsqrt residue."""
    scene = jproc.to_scene(jproc.cornell_with_sphere_mesh(subdiv=2))
    with jax_normalize_rounded():
        want = J.render(scene, J.make_camera(width=size, height=size),
                        _cfg(J, integrator, flags, size), seed=SEED)
    assert_pixels_close(port_render(integrator, flags, size).img, want.img)
