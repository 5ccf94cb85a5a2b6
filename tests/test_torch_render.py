"""The port's PT+NEE render (cudapathtracer_tpu_torch) end to end on the
CPU: per-pixel accumulators against the JAX package's render, the pt_nee
goldens under tests/test_goldens.py:_check's rule, resuming (within the port
and from a JAX state carried over by convert.py), and a render in a process
where JAX cannot be imported.

Tolerance: rtol 3e-6 per pixel (atol 1e-7), the tolerance the JAX package's
packet path is held to between engines: hits are identical, while the shading
arithmetic around them rounds differently in the last bits (XLA's cos, sin
and rsqrt are not torch's)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cudapathtracer_tpu as J
from cudapathtracer_tpu.models import procedural as jproc

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import convert
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.utils.ppm import read_ppm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU, and torch's default of a thread per core in each of them
    oversubscribes it (the renders here ran 10x slower so)."""
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


def _cfg(pkg, w, spp):
    return pkg.RenderConfig(width=w, height=w, spp=spp, integrator="pt_nee",
                            samples_per_call=spp)


def _jax_render(scene, w, spp, seed, state=None):
    name, kw = SCENES[scene]
    return J.render(jproc.to_scene(getattr(jproc, name)(**kw)),
                    J.make_camera(width=w, height=w), _cfg(J, w, spp),
                    seed=seed, state=state)


def _port_render(scene, w, spp, seed, state=None):
    name, kw = SCENES[scene]
    return T.render(tproc.to_scene(getattr(tproc, name)(**kw), "cpu"),
                    T.make_camera(width=w, height=w, device="cpu"),
                    _cfg(T, w, spp), seed=seed, state=state, device="cpu")


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's renders, built once (XLA:CPU compiles pile up;
    pytest.ini)."""
    return {
        ("cornell", 4): _jax_render("cornell", 16, 4, seed=9),
        ("sphere_mesh", 2): _jax_render("sphere_mesh", 16, 2, seed=9),
        ("cornell", 3): _jax_render("cornell", 16, 3, seed=3),
        ("cornell", 6): _jax_render("cornell", 16, 6, seed=3),
    }


def _close(port_state, jax_state):
    for a, b in zip(port_state.img, jax_state.img):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("scene,spp", [("cornell", 4), ("sphere_mesh", 2)])
def test_render_matches_jax_per_pixel(jax_ref, scene, spp):
    want = jax_ref[scene, spp]
    got = _port_render(scene, 16, spp, seed=9)
    assert got.n == int(want.n) == spp
    _close(got, want)
    assert float(got.img.x.max()) > 0


def _check(state, cfg, name, tol=2):
    """tests/test_goldens.py:_check, on the port's finalize_image."""
    img = T.finalize_image(state, cfg).astype(np.int32)[:, ::-1]
    gold = read_ppm(os.path.join(GOLDENS, name)).astype(np.int32)
    assert img.shape == gold.shape
    frac_bad = (np.abs(img - gold) > tol).mean()
    assert frac_bad < 0.005, (
        f"{name}: {frac_bad:.2%} of channels differ by more than {tol}")


@pytest.mark.parametrize("w,spp", [(64, 16), (128, 8)])
def test_golden_cornell_pt_nee(w, spp):
    st = _port_render("cornell", w, spp, seed=1234)
    _check(st, _cfg(T, w, spp), f"cornell_pt_nee_{w}_spp{spp}.ppm")


def test_golden_analytic_sphere():
    cfg = _cfg(T, 32, 8)
    st = T.render(tproc.cornell_with_analytic_sphere(device="cpu"),
                  T.make_camera(width=32, height=32, device="cpu"), cfg,
                  seed=1234, device="cpu")
    _check(st, cfg, "cornell_sphere_pt_nee_32_spp8.ppm")


def test_resume_equals_straight_run():
    full = _port_render("cornell", 16, 6, seed=3)
    part = _port_render("cornell", 16, 3, seed=3)
    resumed = _port_render("cornell", 16, 6, seed=3, state=part)
    assert resumed.n == 6
    for a, b in zip(full.img, resumed.img):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_resume_from_jax_state(jax_ref):
    """A render begun in JAX (3 spp) and finished in the port (to 6 spp)
    matches JAX's straight 6 spp render."""
    part = jax_ref["cornell", 3]
    full = jax_ref["cornell", 6]
    state = convert.accum_from_jax(convert.to_numpy_dict(part), "cpu")
    assert state.n == 3
    resumed = _port_render("cornell", 16, 6, seed=3, state=state)
    assert resumed.n == 6
    _close(resumed, full)


def test_convert_scene_and_camera_render_alike():
    """The JAX scene and camera carried over by convert.py render the same
    image in the port as the port's own constructors."""
    js = jproc.to_scene(jproc.cornell_box())
    jc = J.make_camera(width=16, height=16)
    ts = convert.scene_from_jax(convert.to_numpy_dict(js), "cpu")
    tc = convert.camera_from_jax(convert.to_numpy_dict(jc), "cpu")
    a = T.render(ts, tc, _cfg(T, 16, 1), seed=4, device="cpu")
    b = _port_render("cornell", 16, 1, seed=4)
    for x, y in zip(a.img, b.img):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("n_lights", [0, 5, 100])
def test_pick_light_slot_matches_jax(n_lights):
    """Both branches of the light pick (the scan for L <= 64, the binary
    search beyond) pick the JAX package's slot. For short light lists the
    cumulative areas round alike, so exact bin boundaries are included;
    past 32 lights XLA sums them in another order, so boundaries may
    differ by an ulp and only interior points are compared."""
    import jax.numpy as jnp
    import torch

    from cudapathtracer_tpu.ops import shading as jshade
    from cudapathtracer_tpu_torch.ops import shading as tshade

    rng = np.random.default_rng(n_lights)
    areas = rng.uniform(0.1, 1.0, n_lights).astype(np.float32)
    cum = np.cumsum(areas, dtype=np.float32)
    x = rng.uniform(-0.1, 1.1, 3000) * max(cum[-1:], default=1)
    if n_lights <= 32:
        x = np.concatenate([x, cum, [0.0]])
    x = x.astype(np.float32)
    want = jshade.pick_light_slot(jnp.asarray(x), jnp.asarray(areas))
    got = tshade.pick_light_slot(torch.from_numpy(x), torch.from_numpy(areas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_render_device_must_match():
    ts = tproc.to_scene(tproc.cornell_box(), "cpu")
    tc = T.make_camera(width=16, height=16, device="cpu")
    with pytest.raises(ValueError):
        T.render(ts, tc, _cfg(T, 16, 1), device="meta")


def test_port_renders_without_jax():
    code = """
import sys
sys.modules["jax"] = None
import numpy as np
import cudapathtracer_tpu_torch as cpt
from cudapathtracer_tpu_torch.models import procedural
assert "cudapathtracer_tpu" not in sys.modules
scene = procedural.to_scene(procedural.cornell_box(), "cpu")
cam = cpt.make_camera(width=16, height=16, device="cpu")
cfg = cpt.RenderConfig(width=16, height=16, spp=2, integrator="pt_nee",
                       samples_per_call=2)
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
