"""Host code copied or ported into cudapathtracer_tpu_torch, held against
the JAX package: RenderConfig, the procedural generators, make_scene, the
accel build, the camera, Morton order and the color pipeline."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cudapathtracer_tpu as J
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.render import camera as jcam
from cudapathtracer_tpu.render import renderer as jren
from cudapathtracer_tpu.utils import color as jcolor
from cudapathtracer_tpu.utils import morton as jmorton
from cudapathtracer_tpu.ops.vecmath import Vec3 as JVec3

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import rng as trng
from cudapathtracer_tpu_torch.ops.vecmath import Vec3 as TVec3
from cudapathtracer_tpu_torch.render import camera as tcam
from cudapathtracer_tpu_torch.render import renderer as tren
from cudapathtracer_tpu_torch.utils import build as tbuild
from cudapathtracer_tpu_torch.utils import color as tcolor
from cudapathtracer_tpu_torch.utils import morton as tmorton
from cudapathtracer_tpu_torch.utils.config import check_supported

SCENES = [
    ("cornell_box", {}),
    ("cornell_with_sphere_mesh", {"subdiv": 2}),
    ("colonnade", {"subdiv": 1}),
]


def test_render_config_defaults_field_by_field():
    jf = {f.name: f.default for f in dataclasses.fields(J.RenderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(T.RenderConfig)}
    assert list(jf) == list(tf)
    for name, value in jf.items():
        assert tf[name] == value, name


# each case keeps the id it had while the list also held the knobs that
# are ported since (integrator="bdpt", vis_dropout, tile_size_vis; kw7
# intersector="mt" and kw8 traversal="bvh", then kw1-5, kw12 and kw14: the
# two-level cull, rounds, sample batches and sort windows, moved to the
# accepted list); what is left picks a TPU engine or schedule
@pytest.mark.parametrize("kw,knob", [
    pytest.param(kw, knob, id=f"kw{i}-{knob}") for i, (kw, knob) in (
        (9, (dict(packet_engine="xla"), "packet_engine")),
        (10, (dict(warm_start=2), "warm_start")),
        (11, (dict(ray_groups=2), "ray_groups")),
    )
])
def test_unsupported_knobs_raise(kw, knob):
    with pytest.raises(NotImplementedError, match=knob):
        check_supported(T.RenderConfig(**{"integrator": "pt_nee", **kw}))


@pytest.mark.parametrize("kw", [
    dict(two_level_cull="super"),
    dict(two_level_cull=False),
    dict(two_level_cull="super", super_factor=4, super_list=31),
    dict(integrator="bdpt"),
    dict(integrator="bdpt", vis_dropout=True),
    dict(integrator="bdpt", tile_size_vis=64),
] + [pytest.param(kw, id=i) for i, kw in (
    ("kw7-intersector", dict(intersector="mt")),
    ("kw8-traversal", dict(traversal="bvh")),
    ("traversal-brute", dict(traversal="brute")),
    ("bdpt-brute-mt", dict(integrator="bdpt", traversal="brute",
                           intersector="mt")),
    ("kw1-packet_rounds", dict(packet_rounds=2)),
    ("kw2-sample_batch", dict(sample_batch=2)),
    ("kw3-sort_window", dict(sort_window=256)),
    ("kw4-two_level_cull", dict(two_level_cull=True)),
    ("kw5-super_slots", dict(two_level_cull="super", super_slots=4)),
    ("kw12-super_slots", dict(super_factor=4, super_slots=8)),
    ("kw14-packet_rounds_bdpt", dict(integrator="bdpt",
                                     packet_rounds_bdpt=2)),
)])
def test_super_cull_knobs_accepted(kw):
    """The super cull and its knobs are ported, and so are the capped
    two-level cull (two_level_cull=True, super_slots), straggler rounds
    (packet_rounds, packet_rounds_bdpt), sample batches and sort windows,
    BDPT and its visibility knobs, the Moller-Trumbore intersector and the
    fine-BVH and brute-force engines."""
    check_supported(T.RenderConfig(**{"integrator": "pt_nee", **kw}))


@pytest.mark.parametrize("name,kw", SCENES)
def test_procedural_generators_equal(name, kw):
    a = getattr(jproc, name)(**kw)
    b = getattr(tproc, name)(**kw)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _eq_vec(jv, tv):
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name,kw", SCENES)
def test_make_scene_tensors_equal(name, kw):
    js = jproc.to_scene(getattr(jproc, name)(**kw))
    ts = tproc.to_scene(getattr(tproc, name)(**kw), "cpu")
    for f in J.Scene._fields:
        a, b = getattr(js, f), getattr(ts, f)
        if isinstance(a, JVec3):
            _eq_vec(a, b)
        else:
            assert np.asarray(a).dtype == b.numpy().dtype, f
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f)


@pytest.mark.parametrize("name,kw,cluster", [
    ("cornell_with_sphere_mesh", {"subdiv": 2}, None),
    ("cornell_with_sphere_mesh", {"subdiv": 2}, 16),
    ("colonnade", {"subdiv": 1}, None),
])
def test_build_bvh_for_scene_arrays_equal(name, kw, cluster):
    ja = jren.build_bvh_for_scene(jproc.to_scene(getattr(jproc, name)(**kw)),
                                  4, cluster_size=cluster)
    ta = tren.build_bvh_for_scene(
        tproc.to_scene(getattr(tproc, name)(**kw), "cpu"), 4,
        cluster_size=cluster)
    for f in ja._fields[1:]:
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)),
                                      getattr(ta, f).numpy(), err_msg=f)
    for f in ja.fine._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ja.fine, f)),
                                      getattr(ta.fine, f).numpy(), err_msg=f)


def test_native_builder_source_is_the_ports_own_copy():
    """The port compiles its own copy of the BVH builder, byte for byte the
    JAX package's file; nothing it builds lies outside its package."""
    import os

    from cudapathtracer_tpu_torch.accel import native as tnative

    src = os.path.realpath(tnative.SOURCE)
    assert src.startswith(os.path.realpath(tbuild.PACKAGE_DIR) + os.sep)
    ref = os.path.join(os.path.dirname(J.__file__), "native",
                       "bvh_builder.cpp")
    with open(src, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_library_name_follows_command_and_sources(tmp_path):
    """A native library is rebuilt when its flags or its sources change,
    not only when a source is newer than the built file."""
    src = tmp_path / "k.cu"
    src.write_text("int f() { return 1; }\n")
    cmd = ["nvcc", "-O3", "-fmad=false"]
    name = tbuild.library_path("libk.so", [str(src)], cmd)
    assert name == tbuild.library_path("libk.so", [str(src)], list(cmd))
    assert name.startswith(tbuild.BUILD_DIR) and name.endswith(".so")
    assert name != tbuild.library_path("libk.so", [str(src)], cmd[:2])
    src.write_text("int f() { return 2; }\n")
    assert name != tbuild.library_path("libk.so", [str(src)], cmd)
    with pytest.raises(FileNotFoundError):
        tbuild.library_path("libk.so", [str(tmp_path / "none.cu")], cmd)


def test_adaptive_cluster_size_equal():
    for t in (100, 20884, 82000, 328000, 2_000_000):
        assert (tren.adaptive_cluster_size(t)
                == jren.adaptive_cluster_size(t))


@pytest.mark.parametrize("radius", [0.0, 0.05])
def test_camera_rays_match(radius):
    """Primary rays against the JAX camera as the renderer runs it (under
    jit). Pinhole origins are exact, and pinhole directions may differ by
    one ulp: XLA turns normalize's 1/sqrt into its own rsqrt, which is
    within one ulp of the correctly rounded value the port computes.

    The lens path adds XLA's and torch's cos/sin, which may differ by an ulp
    or two, so lens origins are held to 2 ulp. Its directions are held by
    absolute error on the unit vector's scale (4 * 2^-24), not by ulps: a
    direction is normalize(film - lens_o), and where a component is near
    zero that difference cancels, so lens_o's 1-2 ulp grow to more ulps of
    the small component (5 ulp, 2.3e-9 absolute, on d.x = -0.006 at 32^2,
    radius 0.05) while staying far below an ulp of the vector's length."""
    W = 32
    jc = J.make_camera(pos=(0.0, 2.0, 3.4), focal_length=2.0, radius=radius,
                       width=W, height=W)
    tc = T.make_camera(pos=(0.0, 2.0, 3.4), focal_length=2.0, radius=radius,
                       width=W, height=W, device="cpu")
    lens = radius > 0
    idx = jnp.arange(W * W, dtype=jnp.uint32)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(7), 2), i))(idx)
    jo, jd = jax.jit(lambda k: jcam.camera_rays(jc, idx, k, lens=lens))(keys)
    tkeys = trng.pixel_keys(trng.sample_key(trng.prng_key(7, "cpu"), 2),
                            torch.arange(W * W))
    to, td = tcam.camera_rays(tc, torch.arange(W * W), tkeys, lens=lens)
    if lens:
        for a, b in zip(jo, to):
            np.testing.assert_array_max_ulp(np.asarray(a), b.numpy(), 2)
        for a, b in zip(jd, td):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                       atol=4 * 2.0**-24)
    else:
        _eq_vec(jo, to)
        for a, b in zip(jd, td):
            np.testing.assert_array_max_ulp(np.asarray(a), b.numpy(), 2)


def test_morton_permutations_equal():
    for w, h in ((8, 8), (64, 32), (256, 256)):
        want = np.asarray(jmorton.morton_to_scanline_perm(w, h))
        got = tmorton.morton_to_scanline_perm(w, h, "cpu").numpy()
        np.testing.assert_array_equal(want.astype(np.int64), got)
    i = np.random.default_rng(0).integers(0, 2**32, 1000, dtype=np.uint64)
    jx, jy = jmorton.morton_decode(jnp.asarray(i.astype(np.uint32)))
    tx, ty = tmorton.morton_decode(torch.from_numpy(i.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())


def test_color_and_quantize_equal():
    rng = np.random.default_rng(3)
    c = [np.concatenate([rng.exponential(0.5, 4000), [0.0, 1e-8, 50.0]]
                        ).astype(np.float32) for _ in range(3)]
    jc = jax.jit(lambda v: jcolor.finalize(v))(JVec3(*c))
    tc = tcolor.finalize(TVec3(*(torch.from_numpy(a) for a in c)))
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=3e-7)
    np.testing.assert_array_equal(
        np.asarray(jcolor.quantize_u8(jc)),
        tcolor.quantize_u8(TVec3(*(torch.from_numpy(np.array(a))
                                   for a in jc))).numpy())
