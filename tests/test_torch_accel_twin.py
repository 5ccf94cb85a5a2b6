"""The port's numpy twin of the BVH builder (cudapathtracer_tpu_torch/
accel/bvh.py) against the JAX package's twin (accel/bvh.py:build_bvh) array
for array and against the native builder bit for bit, its ``validate`` and
``clusters_from_flat``, ``build_bvh_for_scene(use_native=)``; and the
differentiable render's ``trace_data=`` escape hatch
(diff/render_grad.py:render_image_diff), which walks the fine BVH: its image
equals the ``bvh`` engine's bit for bit and the JAX package's
``render_image_diff(trace_data=)`` per pixel."""

import jax
import numpy as np
import pytest
import torch
from torch_fold_cases import assert_pixels_close

import cudapathtracer_tpu as J
from cudapathtracer_tpu.accel import bvh as jbvh
from cudapathtracer_tpu.diff import render_grad as jrg
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.ops import traversal as jtrav
from cudapathtracer_tpu.render.renderer import (
    build_bvh_for_scene as jbuild)

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.accel import bvh as tbvh
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import traversal as ttrav
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.render import renderer as tren


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process (the suite runs several workers on
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (generator, kwargs, leaf size)
BUILDS = [("cornell_box", {}, 4), ("cornell_with_sphere_mesh",
                                   {"subdiv": 2}, 4),
          ("cornell_with_sphere_mesh", {"subdiv": 2}, 16),
          ("colonnade", {"subdiv": 1}, 4), ("colonnade", {"subdiv": 1}, 64)]


def _geometry(name, kw):
    scene = tproc.to_scene(getattr(tproc, name)(**kw), "cpu")
    return scene, scene.host_verts, scene.host_tris


@pytest.mark.parametrize("name,kw,leaf", BUILDS)
def test_twin_matches_jax_twin(name, kw, leaf):
    """The port's twin builds the JAX package's twin's tree array for
    array, its meta included, and it validates."""
    _, verts, tris = _geometry(name, kw)
    tflat, tmeta = tbvh.build_bvh(verts, tris, leaf, device="cpu")
    jflat, jmeta = jbvh.build_bvh(verts, tris, leaf)
    assert tuple(tmeta) == tuple(jmeta)
    for f in jbvh.FlatBVH._fields:
        a, b = getattr(tflat, f).numpy(), np.asarray(getattr(jflat, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tbvh.validate(tflat, tmeta)
    for a, b in zip(tbvh.clusters_from_flat(tflat),
                    jbvh.clusters_from_flat(jflat)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kw,leaf", BUILDS[:4])
def test_twin_matches_native(name, kw, leaf):
    """``build_bvh_for_scene(use_native=False)`` builds the native
    builder's Accel bit for bit, the fine BVH and the cluster level."""
    scene, _, _ = _geometry(name, kw)
    a = tren.build_bvh_for_scene(scene, 4, cluster_size=leaf)
    b = tren.build_bvh_for_scene(scene, 4, use_native=False,
                                 cluster_size=leaf)
    for f in tbvh.FlatBVH._fields:
        x, y = getattr(a.fine, f), getattr(b.fine, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    for f in tbvh.Accel._fields[1:]:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_validate_catches_a_broken_tree():
    """validate raises for a triangle left out, a skip link pointing back
    and a duplicated leaf id."""
    _, verts, tris = _geometry("cornell_box", {})
    flat, meta = tbvh.build_bvh(verts, tris, 4, device="cpu")
    lt = flat.leaf_tri.clone()
    lt[0, 0] = meta.num_tris
    skip = flat.node_skip.clone()
    skip[1] = 0
    leaf = flat.node_leaf.clone()
    i, j = torch.nonzero(leaf >= 0)[:2, 0].tolist()
    leaf[j] = leaf[i]
    for bad in (flat._replace(leaf_tri=lt), flat._replace(node_skip=skip),
                flat._replace(node_leaf=leaf)):
        with pytest.raises(AssertionError):
            tbvh.validate(bad, meta)


def test_native_failure_raises(monkeypatch):
    """A native build that fails raises; the twin is never a silent
    fallback."""
    scene, _, _ = _geometry("cornell_box", {})

    def broken(*a, **kw):
        raise OSError("no compiler")

    monkeypatch.setattr(tren, "build_bvh_native", broken)
    with pytest.raises(OSError, match="no compiler"):
        tren.build_bvh_for_scene(scene, 4)
    assert tren.build_bvh_for_scene(scene, 4, use_native=False).cl_tri.shape


# ---- render_image_diff(trace_data=) ----------------------------------------
TD_SIZE = 16
TD_SPP = 2


def _td_case(scene, integrator):
    if scene == "sphere":
        js = jproc.cornell_with_analytic_sphere()
        ts = tproc.cornell_with_analytic_sphere(device="cpu")
    else:
        js = jproc.to_scene(jproc.cornell_box(with_boxes=False))
        ts = tproc.to_scene(tproc.cornell_box(with_boxes=False), "cpu")
    kw = dict(width=TD_SIZE, height=TD_SIZE, spp=TD_SPP,
              integrator=integrator, samples_per_call=TD_SPP)
    return js, ts, kw


TD_CASES = [("cornell", "pt_nee"), ("cornell", "bdpt"), ("sphere", "pt_nee")]


@pytest.fixture(scope="module")
def jax_trace_data_images():
    """The JAX package's render_image_diff(trace_data=) of each case, seed
    9: the per-ray walk over a fine TraceData, no Accel bundle."""
    out = {}
    for scene, integrator in TD_CASES:
        js, _, kw = _td_case(scene, integrator)
        td = jtrav.make_trace_data(js, jbuild(js, 4).fine)
        out[scene, integrator] = jrg.render_image_diff(
            js, J.make_camera(width=TD_SIZE, height=TD_SIZE),
            J.RenderConfig(**kw), jax.random.PRNGKey(9), TD_SPP,
            trace_data=td)
    return out


@pytest.mark.parametrize("scene,integrator", TD_CASES)
def test_trace_data_equals_bvh_engine(jax_trace_data_images, scene,
                                      integrator):
    """With bvh=None and a fine TraceData, render_image_diff walks the fine
    BVH, the analytic spheres folded in: the image of traversal="bvh" with
    the Accel bundle bit for bit, from any configured engine, and the JAX
    package's trace_data= image per pixel."""
    _, ts, kw = _td_case(scene, integrator)
    cam = T.make_camera(width=TD_SIZE, height=TD_SIZE, device="cpu")
    bvh = tren.build_bvh_for_scene(ts, 4)
    td = ttrav.make_trace_data(ts, bvh.fine)
    with torch.no_grad():
        got = rg.render_image_diff(ts, cam, T.RenderConfig(**kw),
                                   prng_key(9, "cpu"), TD_SPP, trace_data=td)
        want = rg.render_image_diff(
            ts, cam, T.RenderConfig(traversal="bvh", **kw),
            prng_key(9, "cpu"), TD_SPP, bvh=bvh)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(torch.stack(list(got)).max()) > 0
    assert_pixels_close(got, jax_trace_data_images[scene, integrator])
