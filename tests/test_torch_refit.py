"""The accel refit (``accel/bvh.py:refit``) on the CPU: at the vertices it
was built from it is the build, box for box; after a move every box is the
exact bound of its triangles; and the differentiable pass, which refits the
accel it is given on every call, finds the moved mesh's own hits with the
start mesh's accel, where the same comparison without the refit fails.

A shape-fitting step moves the vertices, and the accel is built once at
set-up: a triangle moved out of its boxes was missed by the boxes' culls,
so the image, and the gradients after the first update, were another
geometry's."""

import numpy as np
import pytest
import torch

import cudapathtracer_tpu_torch as cpt
from cudapathtracer_tpu_torch.accel import bvh as accel_bvh
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.models import procedural
from cudapathtracer_tpu_torch.models.scene import make_scene
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.render import renderer

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hero(origin=(0.35, 0.6, 0.3), scale=0.75, subdiv=2):
    """Cornell box + an icosphere hero (its vertices last) at ``origin``."""
    cb = procedural.cornell_box(with_boxes=True)
    sv, sf = procedural.icosphere(subdiv, radius=0.35)
    sv = procedural.transformed(sv, origin=origin, scale=scale)
    verts = np.concatenate([cb["verts"], sv])
    tris = np.concatenate([cb["tris"], sf + len(cb["verts"])])
    mats = np.concatenate([cb["tri_mats"], np.zeros(len(sf), np.int32)])
    return make_scene(verts, tris, mats, cb["albedo"], cb["emission"],
                      device="cpu")


def _refit(accel, scene):
    return accel_bvh.refit(accel, scene.verts,
                           (scene.tri_v0, scene.tri_v1, scene.tri_v2))


def _boxes(accel):
    return list(accel.fine[:6]) + list(accel[1:7])


@pytest.mark.parametrize("which", ["hero", "colonnade"])
def test_refit_at_the_build_vertices_is_the_build(which):
    scene = (_hero() if which == "hero" else procedural.to_scene(
        procedural.colonnade(subdiv=1), "cpu"))
    accel = renderer.build_bvh_for_scene(scene, 4, cluster_size=256)
    for a, b in zip(_boxes(accel), _boxes(_refit(accel, scene))):
        assert torch.equal(a, b)


def test_refit_boxes_are_the_exact_bounds_after_a_move():
    start = _hero()
    moved = _hero(origin=(0.40, 0.62, 0.25), scale=0.825)
    accel = _refit(renderer.build_bvh_for_scene(start, 4, cluster_size=256),
                   moved)
    v = torch.stack(list(moved.verts), 1).numpy()
    tri = torch.stack([moved.tri_v0, moved.tri_v1, moved.tri_v2],
                      1).numpy()
    corners = v[tri]                                    # (T, 3, 3)
    fine = accel.fine
    lo = torch.stack(list(fine[0:3]), 1).numpy()
    hi = torch.stack(list(fine[3:6]), 1).numpy()
    skip, leaf = fine.node_skip.numpy(), fine.node_leaf.numpy()
    leaf_tri = fine.leaf_tri.numpy()
    for i in range(skip.shape[0]):
        ids = leaf_tri[[leaf[j] for j in range(i, skip[i]) if leaf[j] >= 0]]
        pts = corners[ids[ids < tri.shape[0]]].reshape(-1, 3)
        assert np.array_equal(lo[i], pts.min(0)), i
        assert np.array_equal(hi[i], pts.max(0)), i
    clo = torch.stack(list(accel[1:4]), 1).numpy()
    chi = torch.stack(list(accel[4:7]), 1).numpy()
    for k, ids in enumerate(accel.cl_tri.numpy()):
        pts = corners[ids[ids < tri.shape[0]]].reshape(-1, 3)
        assert np.array_equal(clo[k], pts.min(0))
        assert np.array_equal(chi[k], pts.max(0))


def _image(scene, accel, traversal):
    cam = cpt.make_camera(width=SIZE, height=SIZE, device="cpu")
    cfg = cpt.RenderConfig(width=SIZE, height=SIZE, spp=1,
                           integrator="pt_nee", samples_per_call=1,
                           traversal=traversal)
    with torch.no_grad():
        img = rg.render_image_diff(scene, cam, cfg, prng_key(5, "cpu"), 1,
                                   bvh=accel)
    return torch.stack(list(img), 1)


@pytest.fixture(scope="module")
def moved_images():
    """The moved hero through the start mesh's accel (the 'bvh' walk and
    the packet engine) and by brute force."""
    start = _hero()
    moved = _hero(origin=(0.40, 0.62, 0.25), scale=0.825)
    accel = renderer.build_bvh_for_scene(start, 4, cluster_size=256)
    return dict(accel=accel, moved=moved,
                brute=_image(moved, None, "brute"),
                bvh=_image(moved, accel, "bvh"),
                packets=_image(moved, accel, "packets"))


def test_a_moved_mesh_renders_its_own_hits(moved_images):
    m = moved_images
    # the fine-BVH walk answers brute force's hits bit for bit, and the
    # packet engine within its rtol 3e-6 (the engines' rule)
    assert torch.equal(m["bvh"], m["brute"])
    torch.testing.assert_close(m["packets"], m["brute"], rtol=3e-6,
                               atol=1e-7)


def test_without_the_refit_the_moved_mesh_is_missed(moved_images,
                                                     monkeypatch):
    m = moved_images
    monkeypatch.setattr(rg, "refit", lambda accel, verts, tris: accel)
    stale = _image(m["moved"], m["accel"], "bvh")
    off = (stale - m["brute"]).abs().amax(1) > 1e-3
    assert int(off.sum()) > 0
