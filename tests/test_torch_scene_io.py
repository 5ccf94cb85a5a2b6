"""The port's scene I/O (cudapathtracer_tpu_torch/models/objio.py, loader.py,
cornell_original.py, scene.merge_scenes, procedural.write_obj, accel/native.py
parse_obj_native and utils/si.py) held against the JAX package on the CPU.

The parsers' shapes and materials equal the JAX package's field for field
(the Python parser against the Python parser, the native one against the
native one; the two kinds against each other as the JAX package's own tests
hold them), and the loaded scenes' arrays equal the JAX package's exactly:
vertices, triangle indices, normals, materials, lights and the total light
area, the host geometry included."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import cudapathtracer_tpu as J
from cudapathtracer_tpu.accel import native as jnative
from cudapathtracer_tpu.models import cornell_original as jcornell
from cudapathtracer_tpu.models import loader as jloader
from cudapathtracer_tpu.models import objio as jobjio
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.models.scene import host_geometry
from cudapathtracer_tpu.utils import si as jsi

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.accel import native as tnative
from cudapathtracer_tpu_torch.models import cornell_original as tcornell
from cudapathtracer_tpu_torch.models import loader as tloader
from cudapathtracer_tpu_torch.models import objio as tobjio
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import traversal as ttrav
from cudapathtracer_tpu_torch.ops.vecmath import Vec3
from cudapathtracer_tpu_torch.render import renderer as tren
from cudapathtracer_tpu_torch.utils import build as tbuild
from cudapathtracer_tpu_torch.utils import si as tsi


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the parser cases of tests/test_scene_io.py and tests/test_native.py
OBJ_CASES = {
    "fan_negative": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf -4 -3 -2 -1\n",
    "vtn_forms": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
                  "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1\nf 1//1 2//1 3//1\n"),
    "groups_and_materials": (
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "g first\nusemtl b\nf 1 2 3 4\no second\nusemtl a\nf 1 2 5\n"
        "usemtl missing\nf 2 3 5\n"),
}
MTL_TEXT = ("newmtl a\nKa 0.1 0.1 0.1\nKd 0.2 0.3 0.4\nKs 1 1 1\n"
            "Ke 5 6 7\nNs 10\nNi 1.5\nd 0.9\nillum 2\n"
            "newmtl b\nKd 0.5 0.5 0.5\nTr 0.25\nmap_Kd tex.png\n")


def _write_case(tmp_path, name):
    if name in ("cornell", "colonnade"):
        desc = (jproc.cornell_box() if name == "cornell"
                else jproc.colonnade(subdiv=1))
        obj = tmp_path / f"{name}.obj"
        jproc.write_obj(obj, tmp_path / f"{name}.mtl", desc)
        return obj
    (tmp_path / "m.mtl").write_text(MTL_TEXT)
    obj = tmp_path / f"{name}.obj"
    obj.write_text(OBJ_CASES[name])
    return obj


def _fields(items):
    return [dataclasses.asdict(x) for x in items]


PARSE_CASES = ["cornell", "colonnade", *OBJ_CASES]


@pytest.mark.parametrize("case", PARSE_CASES)
def test_python_parser_matches_jax(case, tmp_path):
    obj = _write_case(tmp_path, case)
    t_shapes, t_mats = tobjio.parse_obj(obj)
    j_shapes, j_mats = jobjio.parse_obj(obj)
    assert _fields(t_shapes) == _fields(j_shapes)
    assert _fields(t_mats) == _fields(j_mats)


@pytest.mark.parametrize("case", PARSE_CASES)
def test_native_parser_matches_jax(case, tmp_path):
    """The port's native parser (its own copy of obj_loader.cpp) gives the
    JAX package's native shapes and materials, and the Python parser's
    within float32 (tests/test_native.py's rule)."""
    obj = _write_case(tmp_path, case)
    t_shapes, t_mats = tnative.parse_obj_native(str(obj))
    j_shapes, j_mats = jnative.parse_obj_native(str(obj))
    assert _fields(t_shapes) == _fields(j_shapes)
    assert _fields(t_mats) == _fields(j_mats)
    p_shapes, p_mats = tobjio.parse_obj(obj)
    assert len(t_shapes) == len(p_shapes) and len(t_mats) == len(p_mats)
    for c, p in zip(t_shapes, p_shapes):
        np.testing.assert_array_equal(c.indices, p.indices)
        np.testing.assert_array_equal(c.material_ids, p.material_ids)
        np.testing.assert_allclose(c.positions, p.positions, rtol=1e-6)
    for c, p in zip(t_mats, p_mats):
        assert c.name == p.name and c.illum == p.illum
        np.testing.assert_allclose(c.diffuse, p.diffuse, rtol=1e-6)
        np.testing.assert_allclose(c.emission, p.emission, rtol=1e-6)


def test_parse_mtl_matches_jax(tmp_path):
    p = tmp_path / "m.mtl"
    p.write_text(MTL_TEXT)
    t, j = tobjio.parse_mtl(p), jobjio.parse_mtl(p)
    assert list(t) == list(j) == ["a", "b"]
    assert [dataclasses.asdict(m) for m in t.values()] == \
        [dataclasses.asdict(m) for m in j.values()]
    assert t["a"].emission == (5.0, 6.0, 7.0) and t["b"].dissolve == 0.75


def test_native_parser_raises_on_a_missing_file(tmp_path):
    with pytest.raises(RuntimeError):
        tnative.parse_obj_native(str(tmp_path / "missing.obj"))


def _assert_scene_equal(ts, js):
    """Every array of the port's scene equal to the JAX scene's, in dtype
    and value, the host geometry included."""
    def same(a, b, what):
        b = np.asarray(b)
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)

    for f in ("verts", "tri_norm", "mat_albedo", "mat_emission",
              "sph_center"):
        for c in "xyz":
            same(getattr(getattr(ts, f), c), getattr(getattr(js, f), c),
                 f"{f}.{c}")
    for f in ("tri_v0", "tri_v1", "tri_v2", "tri_mat", "lights",
              "total_light_area", "sph_radius", "sph_mat"):
        same(getattr(ts, f), getattr(js, f), f)
    # the JAX merge registers no host copy: its device arrays are the truth
    hv, ht = host_geometry(js) or (
        np.stack([np.asarray(c) for c in js.verts], axis=1),
        np.stack([np.asarray(js.tri_v0), np.asarray(js.tri_v1),
                  np.asarray(js.tri_v2)], axis=1))
    same(ts.host_verts, hv, "host_verts")
    same(ts.host_tris, ht, "host_tris")
    assert ts.num_lights == js.num_lights and ts.num_mats == js.num_mats


LOAD_CASES = {
    "plain": {},
    "transform": dict(origin=(1.0, 2.0, 3.0), scale=2.0),
    "flip": dict(flip_normals=True),
}


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("case", list(LOAD_CASES))
def test_load_obj_matches_jax(case, use_native, tmp_path):
    obj = _write_case(tmp_path, "cornell")
    kw = LOAD_CASES[case]
    ts = T.load_obj(obj, use_native=use_native, device="cpu", **kw)
    js = jloader.load_obj(obj, use_native=use_native, **kw)
    _assert_scene_equal(ts, js)


def test_load_obj_without_mtl_matches_jax(tmp_path):
    obj = _write_case(tmp_path, "fan_negative")
    _assert_scene_equal(T.load_obj(obj, device="cpu"),
                        jloader.load_obj(obj, use_native=False))


def test_load_objs_merge_matches_jax_and_second_part_is_hit(tmp_path):
    """A merged scene equals the JAX merge, and its accel covers the
    second part: rays aimed at the second copy's back wall hit its
    triangles, in the fine BVH walk as in brute force."""
    obj = str(_write_case(tmp_path, "cornell"))
    specs = [(obj, (0.0, 0.0, 0.0), 1.0), (obj, (5.0, 0.0, 0.0), 0.5, True)]
    ts = T.load_objs(specs, device="cpu")
    js = J.load_objs(specs)
    _assert_scene_equal(ts, js)
    first = T.load_obj(obj, device="cpu").num_tris
    assert ts.num_tris == 2 * first

    bvh = tren.build_bvh_for_scene(ts, 4)
    n = 64
    u = torch.linspace(-0.2, 0.2, n)
    o = Vec3(5.0 + u, torch.full((n,), 0.5), torch.full((n,), 3.0))
    d = Vec3(torch.zeros(n), torch.zeros(n), torch.full((n,), -1.0))
    walk = ttrav.trace(o, d, ttrav.make_trace_data(ts, bvh.fine))
    brute = ttrav.trace_bruteforce(o, d, ts)
    assert bool((walk.tri >= first).all())
    assert torch.equal(walk.tri, brute.tri) and torch.equal(walk.t, brute.t)


def test_write_obj_matches_jax(tmp_path):
    for name in ("cornell_box", "colonnade"):
        kw = {"subdiv": 1} if name == "colonnade" else {}
        tdir, jdir = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
        tdir.mkdir()
        jdir.mkdir()
        tproc.write_obj(tdir / "s.obj", tdir / "s.mtl",
                        getattr(tproc, name)(**kw))
        jproc.write_obj(jdir / "s.obj", jdir / "s.mtl",
                        getattr(jproc, name)(**kw))
        for f in ("s.obj", "s.mtl"):
            assert (tdir / f).read_bytes() == (jdir / f).read_bytes()


def test_cornell_original_matches_jax(tmp_path):
    assert tcornell.CORNELL_ORIGINAL_OBJ == jcornell.CORNELL_ORIGINAL_OBJ
    assert tcornell.CORNELL_ORIGINAL_MTL == jcornell.CORNELL_ORIGINAL_MTL
    path = tcornell.write_cornell_original(str(tmp_path))
    assert os.path.basename(path) == "CornellBox-Original.obj"
    _assert_scene_equal(tcornell.cornell_original_scene(device="cpu"),
                        jcornell.cornell_original_scene())
    tc = tcornell.reference_camera(64, 64, device="cpu")
    jc = jcornell.reference_camera(64, 64)
    for c in "xyz":
        assert float(getattr(tc.pos, c)) == float(getattr(jc.pos, c))
    for f in ("dist_from_film", "focal_length", "radius"):
        assert float(getattr(tc, f)) == float(getattr(jc, f))
    assert (tc.width, tc.height) == (jc.width, jc.height) == (64, 64)


def test_emissive_detection_red_channel_quirk():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    for emission, lights in (([[0.0, 5.0, 0.0]], 0), ([[2.0, 0.0, 0.0]], 1)):
        ts = T.make_scene(verts, tris, [0], [[1, 1, 1]], emission,
                          device="cpu")
        js = J.make_scene(verts, tris, [0], [[1, 1, 1]], emission)
        assert ts.num_lights == js.num_lights == lights
        assert float(ts.total_light_area) == float(js.total_light_area)


def test_obj_loader_source_is_the_ports_own_copy():
    src = os.path.realpath(tnative.OBJ_SOURCE)
    assert src.startswith(os.path.realpath(tbuild.PACKAGE_DIR) + os.sep)
    ref = os.path.join(os.path.dirname(J.__file__), "native",
                       "obj_loader.cpp")
    with open(src, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_loader_has_no_silent_fallback(tmp_path, monkeypatch):
    """use_native=True means the native parser: its failure raises instead
    of handing the file to the Python parser."""
    obj = _write_case(tmp_path, "cornell")

    def broken(*a, **kw):
        raise RuntimeError("native parser unavailable")

    monkeypatch.setattr(tnative, "parse_obj_native", broken)
    with pytest.raises(RuntimeError, match="unavailable"):
        tloader.load_obj(obj, device="cpu")
    assert tloader.load_obj(obj, use_native=False, device="cpu").num_tris \
        == 36


# ---- utils/si.py -----------------------------------------------------------

SI_ERRORS = {
    "add": lambda si: si.si_area(1.0) + si.Quantity(1.0, si.LENGTH),
    "sub": lambda si: si.si_area(1.0) - si.Quantity(1.0, si.DIMLESS),
    "check_area": lambda si: si.check_area(si.Quantity(1.0, si.LENGTH)),
}


@pytest.mark.parametrize("op", list(SI_ERRORS))
def test_si_errors_match_jax(op):
    with pytest.raises(TypeError) as t_err:
        SI_ERRORS[op](tsi)
    with pytest.raises(TypeError) as j_err:
        SI_ERRORS[op](jsi)
    assert str(t_err.value) == str(j_err.value)


def test_si_propagation_matches_jax():
    for si in (tsi, jsi):
        a, b = si.Quantity(2.0, si.LENGTH), si.Quantity(3.0, si.LENGTH)
        area = a * b
        assert area.dim == si.AREA and area.raw == 6.0
        assert (area / a).dim == si.LENGTH and (a / b).dim == si.DIMLESS
        assert si.check_area(si.si_area(0.1786)) == pytest.approx(0.1786)
    assert tsi.RADIANCE == jsi.RADIANCE and tsi.AREA == jsi.AREA


def test_make_scene_types_the_light_area(monkeypatch):
    """make_scene sends the summed light area through the typed check, as
    the JAX package's does (scene.py:119-128)."""
    from cudapathtracer_tpu_torch.models import scene as tscene

    seen = []

    def check(q):
        seen.append(q.dim)
        return tsi.check_area(q)

    monkeypatch.setattr(tscene, "check_area", check)
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    s = tscene.make_scene(verts, [[0, 1, 2]], [0], [[1, 1, 1]], [[1, 1, 1]],
                          device="cpu")
    assert seen == [tsi.AREA]
    assert float(s.total_light_area) == pytest.approx(0.5)


# ---- every entry point runs on the card unless the caller names another --

def test_entry_points_default_to_the_card():
    import inspect

    from cudapathtracer_tpu_torch.utils import checkpoint as tck

    fns = [tproc.to_scene, T.make_scene, T.make_camera, T.init_accum,
           T.render, T.load_obj, T.load_objs,
           tproc.cornell_with_analytic_sphere,
           tcornell.cornell_original_scene, tcornell.reference_camera,
           tck.load_checkpoint]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__name__
    if not torch.cuda.is_available():
        # no card: the default raises; nothing falls back to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            tproc.to_scene(tproc.cornell_box())
