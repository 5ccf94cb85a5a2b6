"""The port's BDPT render (cudapathtracer_tpu_torch/integrators/bdpt.py, the
configuration's default integrator) end to end on the CPU: per-pixel
accumulators against the JAX package's BDPT render, the
cornell_bdpt_32_spp8 golden under tests/test_goldens.py:_check's rule,
seeds, the visibility knobs (``tile_size_vis``, ``vis_dropout``), the sphere
guard and a render in a process where JAX cannot be imported; and the
pieces BDPT adds below it (the uniform hemisphere, the light table's
emission, the guarded divisions) against their JAX counterparts.

Tolerance of the renders: rtol 3e-6 per pixel (atol 1e-7), the tolerance
of the port's pt_nee render (tests/test_torch_render.py). Hits are
identical; the shading arithmetic around them differs in the last bits
where XLA's CPU code is not correctly rounded: its rsqrt is the hardware
estimate refined by one Newton step, and its cos and sin differ from the
correctly rounded value on about 1% of inputs. The rsqrt estimate differs
between processors, so the per-pixel rule admits the one residue it leaves
on some hosts (``torch_fold_cases.assert_pixels_close``: pixel 22 of the
sphere_mesh render, 1.35e-5 relative, on an AVX-512 Xeon). Both
intersectors render alike against the JAX package, and the fine-BVH walk
and brute force render the packet engine's image."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fold_cases import MT_SEAM_FLIP_SHARE, assert_pixels_close

import cudapathtracer_tpu as J
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.ops import sampling as jsamp
from cudapathtracer_tpu.ops import shading as jshade
from cudapathtracer_tpu.ops import vecmath as jvec

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import sampling as tsamp
from cudapathtracer_tpu_torch.ops import shading as tshade
from cudapathtracer_tpu_torch.ops import vecmath as tvec
from cudapathtracer_tpu_torch.utils.ppm import read_ppm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process (tests/test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")
SCENES = {
    "cornell": ("cornell_box", {}),
    "sphere_mesh": ("cornell_with_sphere_mesh", {"subdiv": 2}),
}


def _cfg(pkg, w, spp, **kw):
    # integrator left at its default: "bdpt" in both packages
    return pkg.RenderConfig(width=w, height=w, spp=spp, samples_per_call=spp,
                            **kw)


def _port_render(scene, w, spp, seed, **kw):
    name, skw = SCENES[scene]
    return T.render(tproc.to_scene(getattr(tproc, name)(**skw), "cpu"),
                    T.make_camera(width=w, height=w, device="cpu"),
                    _cfg(T, w, spp, **kw), seed=seed, device="cpu")


# (scene, spp, intersector); the Baldwin-Weber cases keep their ids
PER_PIXEL = (("cornell", 4, "bw"), ("sphere_mesh", 2, "bw"),
             ("sphere_mesh", 2, "mt"))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's BDPT renders, built once (XLA:CPU compiles pile
    up; pytest.ini)."""
    out = {}
    for scene, spp, isect in PER_PIXEL:
        name, kw = SCENES[scene]
        out[scene, isect] = J.render(
            jproc.to_scene(getattr(jproc, name)(**kw)),
            J.make_camera(width=16, height=16),
            _cfg(J, 16, spp, intersector=isect), seed=9)
    return out


@pytest.mark.parametrize("scene,spp,intersector", [
    pytest.param(*c, id=f"{c[0]}-{c[1]}" + ("-mt" if c[2] == "mt" else ""))
    for c in PER_PIXEL])
def test_bdpt_matches_jax_per_pixel(jax_ref, scene, spp, intersector):
    want = jax_ref[scene, intersector]
    got = _port_render(scene, 16, spp, seed=9, intersector=intersector)
    assert got.n == int(want.n) == spp
    assert_pixels_close(got.img, want.img,
                        MT_SEAM_FLIP_SHARE if intersector == "mt" else 0.0)
    assert float(got.img.x.max()) > 0


@pytest.mark.parametrize("intersector", ["bw", "mt"])
def test_bdpt_engines_render_alike(intersector):
    """BDPT through the fine-BVH walk and brute force: the same image bit
    for bit, and the packet engine's under the per-pixel rule (the capped
    visibility traces give the same decisions in every engine)."""
    imgs = {tr: _port_render("cornell", 16, 2, seed=9, traversal=tr,
                             intersector=intersector)
            for tr in ("bvh", "brute", "packets")}
    for a, b in zip(imgs["bvh"].img, imgs["brute"].img):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert_pixels_close(imgs["bvh"].img, imgs["packets"].img)
    assert float(imgs["bvh"].img.x.max()) > 0


def test_golden_cornell_bdpt():
    """cornell_bdpt_32_spp8.ppm under tests/test_goldens.py:_check's rule,
    rendered through T.render's defaults (BDPT)."""
    cfg = T.RenderConfig(width=32, height=32, spp=8, samples_per_call=8)
    assert cfg.integrator == "bdpt"
    st = T.render(tproc.to_scene(tproc.cornell_box(), "cpu"),
                  T.make_camera(width=32, height=32, device="cpu"), cfg,
                  seed=1234, device="cpu")
    img = T.finalize_image(st, cfg).astype(np.int32)[:, ::-1]
    gold = read_ppm(os.path.join(GOLDENS, "cornell_bdpt_32_spp8.ppm")).astype(
        np.int32)
    assert img.shape == gold.shape
    frac_bad = (np.abs(img - gold) > 2).mean()
    assert frac_bad < 0.005, f"{frac_bad:.2%} of channels differ by more than 2"


def test_seeds_deterministic_and_distinct():
    a = _port_render("cornell", 16, 3, seed=5)
    b = _port_render("cornell", 16, 3, seed=5)
    c = _port_render("cornell", 16, 3, seed=6)
    for x, y in zip(a.img, b.img):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert float((a.img.x - c.img.x).abs().max()) > 0


def test_visibility_knobs_bit_identical():
    """``tile_size_vis`` retiles only the connection rays, and
    ``vis_dropout`` retires occluded ones early: both leave the image
    bit-identical (after tests/test_render.py:138-166)."""
    a = _port_render("cornell", 16, 3, seed=7)
    for kw in (dict(tile_size_vis=64), dict(vis_dropout=True),
               dict(vis_dropout=True, tile_size_vis=64)):
        b = _port_render("cornell", 16, 3, seed=7, **kw)
        for x, y in zip(a.img, b.img):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_bdpt_with_spheres_raises():
    cfg = _cfg(T, 16, 1)
    with pytest.raises(NotImplementedError, match="triangles-only"):
        T.render(tproc.cornell_with_analytic_sphere(device="cpu"),
                 T.make_camera(width=16, height=16, device="cpu"), cfg,
                 device="cpu")


def test_port_renders_bdpt_without_jax():
    code = """
import sys
sys.modules["jax"] = None
import numpy as np
import cudapathtracer_tpu_torch as cpt
from cudapathtracer_tpu_torch.models import procedural
assert "cudapathtracer_tpu" not in sys.modules
scene = procedural.to_scene(procedural.cornell_box(), "cpu")
cam = cpt.make_camera(width=16, height=16, device="cpu")
cfg = cpt.RenderConfig(width=16, height=16, spp=2, samples_per_call=2,
                       vis_dropout=True)
assert cfg.integrator == "bdpt"
st = cpt.render(scene, cam, cfg, seed=1234, device="cpu")
img = cpt.finalize_image(st, cfg)
assert img.shape == (16, 16, 3) and img.max() > 150
assert all(np.isfinite(c.numpy()).all() for c in st.img)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _unit_normals(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((3, n))
    return [c.astype(np.float32) for c in v / np.linalg.norm(v, axis=0)]


def test_uniform_hemisphere_matches_jax():
    """The jitted JAX sampler and the port's: the same fused 1 - u1^2 and
    correctly rounded sqrt; the directions differ only where XLA's cos,
    sin and rsqrt round otherwise (a few ulp, on a minority of rays)."""
    rng = np.random.default_rng(4)
    n = _unit_normals(20000, 5)
    u1, u2 = (rng.uniform(0, 1, 20000).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda n, a, b: jsamp.uniform_hemisphere(
        jvec.Vec3(*n), a, b))(n, u1, u2)
    got = tsamp.uniform_hemisphere(tvec.Vec3(*map(torch.from_numpy, n)),
                                   torch.from_numpy(u1), torch.from_numpy(u2))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=4e-7)
        assert (a.numpy() == np.asarray(b)).mean() > 0.6


def test_sqrt_rounds_like_xla():
    """Fault repaired with this slice: torch's float32 sqrt on the CPU is
    not correctly rounded (it missed XLA's, which is, on about a fifth of
    inputs), so the port's samplers and lengths drifted from the JAX
    package's by an ulp. vecmath.sqrt rounds through float64."""
    x = np.random.default_rng(6).uniform(0, 4, 100000).astype(np.float32)
    want = np.asarray(jax.jit(jnp.sqrt)(x))
    np.testing.assert_array_equal(tvec.sqrt(torch.from_numpy(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(np.sqrt(x), want)


def test_guarded_helpers_match_jax():
    rng = np.random.default_rng(7)
    num = rng.standard_normal(4000).astype(np.float32)
    den = rng.standard_normal(4000).astype(np.float32)
    den[::5] = 0.0
    v = [rng.standard_normal(4000).astype(np.float32) for _ in range(3)]
    for c in v:
        c[::7] = 0.0
    tv = tvec.Vec3(*map(torch.from_numpy, v))
    cases = (
        (jax.jit(jvec.safe_div)(num, den),
         tvec.safe_div(torch.from_numpy(num), torch.from_numpy(den))),
        (jax.jit(lambda d: jvec.safe_div(3.14159, d))(den),
         tvec.safe_div(3.14159, torch.from_numpy(den))),
        (jax.jit(lambda *c: jvec.safe_length(jvec.Vec3(*c)))(*v),
         tvec.safe_length(tv)),
        (jax.jit(lambda *c: jvec.max_component(jvec.Vec3(*c)))(*v),
         tvec.max_component(tv)),
    )
    for want, got in cases:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tvec.safe_div(torch.from_numpy(num),
                          torch.from_numpy(den))[::5] == 0).all()


def test_light_lookup_with_emission_matches_jax():
    js = jproc.to_scene(jproc.cornell_box())
    ts = tproc.to_scene(tproc.cornell_box(), "cpu")
    L = int(js.lights.shape[0])
    slot = np.arange(-1, L + 2, dtype=np.int32)
    want = jshade.light_lookup(jshade.make_light_table(js),
                               jnp.asarray(np.clip(slot, 0, L)),
                               with_emission=True)
    got = tshade.light_lookup(tshade.make_light_table(ts),
                              torch.from_numpy(slot), with_emission=True)
    # JAX's (v0, a1, a2, n, tri, emission); the port carries no tri
    for w, g in zip(want[:4] + want[5:], got):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(got[4].x.max()) > 0
    assert len(tshade.light_lookup(tshade.make_light_table(ts),
                                   torch.from_numpy(slot))) == 4
