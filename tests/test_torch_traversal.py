"""Intersection and traversal in cudapathtracer_tpu_torch against the JAX
package on identical rays (cornell_with_sphere_mesh(subdiv=2) at 32^2, as
tests/test_packets.py:20-45 sets up).

Triangle ids match exactly. The triangle tests match the jitted JAX
functions bit for bit, since the port forms the same fused multiply-adds.
Inside the JAX package's fused loops (the brute-force scan, the BVH
while_loop) XLA could contract some of them differently, so against those
engines the Baldwin-Weber t is held to rtol 1e-6, the tolerance
tests/test_packets.py:202 allows between the JAX package's own engines;
the Moller-Trumbore engines and the sphere test are held to equality, and
so is the walk's count of its visits (TraceStats); among the port's engines
t is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu import make_camera
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.ops import intersect as jint
from cudapathtracer_tpu.ops import traversal as jtrav
from cudapathtracer_tpu.ops.rng import pixel_keys, sample_key
from cudapathtracer_tpu.ops.vecmath import Vec3 as JVec3
from cudapathtracer_tpu.render.camera import camera_rays
from cudapathtracer_tpu.render.renderer import build_bvh_for_scene

from cudapathtracer_tpu_torch import convert
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import intersect as tint
from cudapathtracer_tpu_torch.ops import traversal as ttrav
from cudapathtracer_tpu_torch.ops.vecmath import Vec3 as TVec3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU, and torch's default of a thread per core in each of them
    oversubscribes it (the renders here ran 10x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tv(v):
    return TVec3(*(torch.from_numpy(np.array(c)) for c in v))


@pytest.fixture(scope="module")
def setup():
    js = jproc.to_scene(jproc.cornell_with_sphere_mesh(subdiv=2))
    accel = build_bvh_for_scene(js, leaf_size=4, cluster_size=16)
    idx = jnp.arange(32 * 32, dtype=jnp.uint32)
    keys = pixel_keys(sample_key(jax.random.PRNGKey(0), 0), idx)
    o, d = camera_rays(make_camera(width=32, height=32), idx, keys,
                       jitter=False)
    mask = (np.arange(32 * 32) % 3) != 0
    jtd = jtrav.make_trace_data(js, accel.fine)
    ref = {
        "brute": jtrav.trace_bruteforce(o, d, js),
        "brute_mask": jtrav.trace_bruteforce(o, d, js,
                                             mask=jnp.asarray(mask)),
        "trace": jtrav.trace(o, d, jtd),
        "trace_mask": jtrav.trace(o, d, jtd, mask=jnp.asarray(mask)),
    }
    for m, jm in (("", None), ("_mask", jnp.asarray(mask))):
        ref["brute_mt" + m] = jtrav.trace_bruteforce(o, d, js, mask=jm,
                                                     intersector="mt")
        ref["trace_mt" + m] = jtrav.trace(o, d, jtd, mask=jm,
                                          intersector="mt")
    ts = tproc.to_scene(tproc.cornell_with_sphere_mesh(subdiv=2), "cpu")
    tacc = convert.accel_from_jax(convert.to_numpy_dict(accel), "cpu")
    return dict(ref=ref, ts=ts, ttd=ttrav.make_trace_data(ts, tacc.fine),
                o=tv(o), d=tv(d), mask=torch.from_numpy(mask))


def _check(hit, ref, exact_t=False):
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref.tri))
    if exact_t:
        np.testing.assert_array_equal(hit.t.numpy(), np.asarray(ref.t))
    else:
        np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t),
                                   rtol=1e-6, atol=1e-6)


def _random_tris(seed, n=20000):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(15)]


@pytest.mark.parametrize("seed", [0, 1])
def test_ray_triangle_bw_bit_exact(seed):
    a = _random_tris(seed)
    o, d, v0, e1, e2 = (a[i:i + 3] for i in range(0, 15, 3))
    jattrs = jint.bw_precompute(JVec3(*e1), JVec3(*e2))
    tattrs = tint.bw_precompute(tv(e1), tv(e2))
    for ja, ta in zip(jattrs, tattrs):
        for x, y in zip(ja, ta):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    want = jax.jit(jint.ray_triangle_bw)(JVec3(*o), JVec3(*d), JVec3(*v0),
                                         *jattrs)
    got = tint.ray_triangle_bw(tv(o), tv(d), tv(v0), *tattrs)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", [2, 3])
def test_ray_triangle_mt_bit_exact(seed):
    a = _random_tris(seed)
    o, d, v0, e1, e2 = (a[i:i + 3] for i in range(0, 15, 3))
    want = jax.jit(jint.ray_triangle)(*(JVec3(*v) for v in (o, d, v0, e1,
                                                             e2)))
    got = tint.ray_triangle(*(tv(v) for v in (o, d, v0, e1, e2)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_trace_bruteforce_matches_jax(setup, masked):
    s = setup
    mask = s["mask"] if masked else None
    hit = ttrav.trace_bruteforce(s["o"], s["d"], s["ts"], mask=mask)
    _check(hit, s["ref"]["brute_mask" if masked else "brute"])
    assert (hit.tri >= 0).sum() > 500


@pytest.mark.parametrize("masked", [False, True])
def test_trace_matches_jax_and_brute(setup, masked):
    s = setup
    mask = s["mask"] if masked else None
    hit = ttrav.trace(s["o"], s["d"], s["ttd"], mask=mask)
    _check(hit, s["ref"]["trace_mask" if masked else "trace"])
    brute = ttrav.trace_bruteforce(s["o"], s["d"], s["ts"], mask=mask)
    np.testing.assert_array_equal(hit.tri.numpy(), brute.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), brute.t.numpy())
    if masked:
        assert (hit.tri.numpy()[~s["mask"].numpy()] == -1).all()


@pytest.mark.parametrize("masked", [False, True])
def test_mt_engines_match_jax(setup, masked):
    """Moller-Trumbore in the brute-force oracle and the BVH walk: ids and
    t equal to the JAX package's engines with intersector="mt", and to each
    other."""
    s = setup
    mask = s["mask"] if masked else None
    m = "_mask" if masked else ""
    brute = ttrav.trace_bruteforce(s["o"], s["d"], s["ts"], mask=mask,
                                   intersector="mt")
    hit = ttrav.trace(s["o"], s["d"], s["ttd"], mask=mask, intersector="mt")
    _check(brute, s["ref"]["brute_mt" + m], exact_t=True)
    _check(hit, s["ref"]["trace_mt" + m], exact_t=True)
    assert (hit.tri >= 0).sum() > 500


@pytest.mark.parametrize("engine", ["trace", "trace_bruteforce"])
def test_engines_reject_unknown_intersector(setup, engine):
    s = setup
    scene = s["ttd"] if engine == "trace" else s["ts"]
    with pytest.raises(ValueError, match="intersector"):
        getattr(ttrav, engine)(s["o"], s["d"], scene, intersector="xyz")


@pytest.mark.parametrize("intersector", ["bw", "mt"])
def test_ray_triangle_any_matches_jax(intersector):
    a = _random_tris(4)
    o, d, v0, e1, e2 = (a[i:i + 3] for i in range(0, 15, 3))
    want = jax.jit(lambda *v: jint.ray_triangle_any(
        *(JVec3(*c) for c in v), intersector=intersector))(o, d, v0, e1, e2)
    got = tint.ray_triangle_any(*(tv(v) for v in (o, d, v0, e1, e2)),
                                intersector=intersector)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    with pytest.raises(ValueError, match="intersector"):
        tint.ray_triangle_any(*(tv(v) for v in (o, d, v0, e1, e2)),
                              intersector="xyz")


@pytest.mark.parametrize("masked,intersector", [(False, "bw"), (True, "bw"),
                                                (False, "mt")])
def test_trace_stats_match_jax(masked, intersector):
    """TraceStats of the walk on colonnade subdiv 2 (the falsecolor
    golden's scene and camera, 32^2): the triangle visits (pad visits in
    slot T, those of masked lanes included), the loop's steps and each
    ray's node visits equal the JAX walk's, and the hits too. The port's
    loop runs only the selected lanes and still counts as the JAX loop
    over all of them does."""
    js = jproc.to_scene(jproc.colonnade(subdiv=2))
    accel = build_bvh_for_scene(js, leaf_size=4)
    idx = jnp.arange(32 * 32, dtype=jnp.uint32)
    keys = pixel_keys(sample_key(jax.random.PRNGKey(1234), 0), idx)
    o, d = camera_rays(make_camera(pos=(0.0, 2.0, 3.4), width=32, height=32,
                                   focal_length=2.0), idx, keys)
    mask = (np.arange(32 * 32) % 5) != 0 if masked else None
    jh, js_ = jtrav.trace(o, d, jtrav.make_trace_data(js, accel.fine),
                          mask=None if mask is None else jnp.asarray(mask),
                          with_stats=True, intersector=intersector)
    ts = tproc.to_scene(tproc.colonnade(subdiv=2), "cpu")
    tacc = convert.accel_from_jax(convert.to_numpy_dict(accel), "cpu")
    th, tst = ttrav.trace(tv(o), tv(d), ttrav.make_trace_data(ts, tacc.fine),
                          mask=None if mask is None
                          else torch.from_numpy(mask),
                          with_stats=True, intersector=intersector)
    _check(th, jh, exact_t=True)
    np.testing.assert_array_equal(tst.tri_visits.numpy(),
                                  np.asarray(js_.tri_visits))
    assert int(tst.steps) == int(js_.steps) > 0
    np.testing.assert_array_equal(tst.ray_visits.numpy(),
                                  np.asarray(js_.ray_visits))
    assert tst.tri_visits.shape == (ts.num_tris + 1,)
    assert int(tst.tri_visits[-1]) > 0
    if masked:
        assert (tst.ray_visits.numpy()[~mask] == 0).all()


def test_apply_t_cap_matches_jax(setup):
    s = setup
    hit = ttrav.trace_bruteforce(s["o"], s["d"], s["ts"])
    cap = np.random.default_rng(0).uniform(1.0, 5.0, hit.t.shape[0]).astype(
        np.float32)
    want = jtrav.apply_t_cap(jtrav.Hit(tri=jnp.asarray(hit.tri.numpy()),
                                       t=jnp.asarray(hit.t.numpy())), cap)
    got = ttrav.apply_t_cap(hit, torch.from_numpy(cap))
    _check(got, want, exact_t=True)


def test_trace_spheres_matches_jax():
    """Sphere ids and t match exactly. Repaired fault: XLA contracts the
    quadratic's c = dot(oc, oc) - r * r into fma(-r, r, dot(oc, oc)); the
    port computed it unfused, and the quadratic's cancellation carried the
    rounding into t (equal on only 84% of hits among 200,000 random rays,
    up to 2.7e-5 relative apart elsewhere). ray_sphere now forms the same
    fused multiply-add (test_ray_sphere_matches_jax). The scene goes into
    the jitted JAX function as an argument, as the renderer passes it: a
    scene closed over as a constant lets XLA fold r * r and form no
    fused multiply-add there (7 of these rays then differ by up to 2.6e-6
    relative)."""
    js = jproc.cornell_with_analytic_sphere()
    ts = tproc.cornell_with_analytic_sphere(device="cpu")
    idx = jnp.arange(16 * 16, dtype=jnp.uint32)
    o, d = camera_rays(make_camera(width=16, height=16), idx, None,
                       lens=False)
    jh = jtrav.trace_bruteforce(o, d, js)
    want = jax.jit(jtrav.trace_spheres)(o, d, js, jh.t, jh.tri)
    th = ttrav.trace_bruteforce(tv(o), tv(d), ts)
    got = ttrav.trace_spheres(tv(o), tv(d), ts, th.t, th.tri)
    assert (got.tri.numpy() >= ts.num_tris).sum() > 0
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ray_sphere_matches_jax(seed):
    """ray_sphere against the jitted JAX function on 200,000 random rays
    (origins N(0, 3^2), unit directions, centers N(0, 1), radii U(0.1,
    1.6)): t equal on every ray, hits and misses alike."""
    rng = np.random.default_rng(seed)
    n = 200000
    o = [(3.0 * rng.standard_normal(n)).astype(np.float32) for _ in range(3)]
    dv = rng.standard_normal((3, n))
    dv /= np.linalg.norm(dv, axis=0)
    d = [c.astype(np.float32) for c in dv]
    c = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    r = rng.uniform(0.1, 1.6, n).astype(np.float32)
    want = np.asarray(jax.jit(lambda o, d, c, r: jint.ray_sphere(
        JVec3(*o), JVec3(*d), JVec3(*c), r))(o, d, c, r))
    got = tint.ray_sphere(tv(o), tv(d), tv(c), torch.from_numpy(r)).numpy()
    assert (want < 1e5).sum() > 1000
    np.testing.assert_array_equal(got, want)
