"""K3, the super-shortlist kernel (cudapathtracer_tpu_torch/ops/kernels/
dense_super.py), and the packet engine's super route.

Its plain version is held against the JAX package's Pallas kernel
dense_intersect_resident_super(..., super_factor=2, bw=True,
interpret=True) on identical super shortlists, at C = 128: triangle ids
exactly, t to rtol 1e-6 / atol 1e-6 (tests/test_packets.py:247). The scene
is tests/test_packets.py:389-426's at subdiv 3 (1,316 triangles, K = 16
clusters): at subdiv 2, K = 4 is not above 2F, so both packages leave the
super route for the resident one there. trace_packets with
two_level="super", super_factor=2 equals brute force and the JAX package's
trace_packets(engine="pallas_interpret") exactly, with the whole super list
(255) and with a one-super list, which forces the dropped-super bound U and
the fine-BVH fallback.

The CUDA kernel runs only on a card: its case is marked ``cuda`` and skips
elsewhere. The JAX package is imported only by the cases that compare
against it, so the CUDA case also runs where JAX is not installed:
``python -m pytest -o addopts="" --noconftest -m cuda
tests/test_torch_dense_super.py``."""

import numpy as np
import pytest
import torch
from torch_fold_cases import jax_scene, packet_data, rays, shortlists, tv

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import packets as tpk
from cudapathtracer_tpu_torch.ops import traversal as ttrav
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as tk1
from cudapathtracer_tpu_torch.ops.kernels import dense_super as tk3
from cudapathtracer_tpu_torch.render import renderer as tren

F = 2
SUBDIV = 3


@pytest.fixture(scope="module")
def scene():
    return jax_scene(SUBDIV)


def _shortlists(tpd, kind, sort, super_list=255):
    return shortlists(tpd, kind, sort, max_clusters=4095, super_factor=F,
                      super_list=super_list)


def test_super_shortlists(scene):
    """Super units: ids ascend by entry below each count, the sentinel S
    past it; with the whole list nothing is dropped (U = inf), with a
    one-super list some tile drops a super (finite U)."""
    tpd = scene["tpd"]
    S = -(-tpd.num_clusters // F)
    assert tpd.num_clusters > 2 * F
    sl = _shortlists(tpd, "camera", True)
    assert sl.ids.shape[1] == S
    real = torch.arange(S)[None, :] < sl.counts[:, None]
    assert bool((sl.ids[~real] == S).all())
    assert bool((sl.ids[real] < S).all())
    assert bool((sl.entries[:, 1:] >= sl.entries[:, :-1]).all())
    assert not torch.isfinite(sl.U).any()
    one = _shortlists(tpd, "camera", True, super_list=1)
    assert one.ids.shape[1] == 1 and torch.isfinite(one.U).any()


def test_expand_supers():
    ids = torch.tensor([[0, 2, 3], [1, 3, 3]], dtype=torch.int32)
    counts = torch.tensor([2, 1], dtype=torch.int32)
    entries = torch.tensor([[0.5, 1.0, np.inf], [0.25, np.inf, np.inf]])
    m, c, e = tk3.expand_supers(ids, counts, entries, 2, 5)
    assert m.tolist() == [[0, 1, 4, 5, 5, 5], [2, 3, 5, 5, 5, 5]]
    assert c.tolist() == [4, 2]
    assert e[0, :4].tolist() == [0.5, 0.5, 1.0, 1.0]


@pytest.mark.parametrize("kind,sort", [("camera", False), ("camera", True),
                                       ("random", True)])
def test_plain_matches_pallas_interpret(scene, kind, sort):
    sl = _shortlists(scene["tpd"], kind, sort)
    assert int(sl.counts.max()) >= 2
    t, tri = tk3.dense_intersect_super_plain(
        sl.ids, sl.counts, sl.entries, sl.rays, *scene["pack"], F)
    jnp = scene["jnp"]
    jt, jtri = scene["jdr"].dense_intersect_resident_super(
        jnp.asarray(sl.ids.numpy()), jnp.asarray(sl.counts.numpy()),
        jnp.asarray(sl.entries.numpy()), jnp.asarray(sl.rays.numpy()),
        scene["jpack"], scene["jboxes"], scene["js"].num_tris,
        super_factor=F, interpret=True, bw=True)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-6)
    assert (tri.numpy() >= 0).sum() > 100


def test_wrapper_takes_plain_version_on_cpu(scene):
    sl = _shortlists(scene["tpd"], "camera", True)
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *scene["pack"])
    before = (tk3.dense_intersect_super.launches,
              tk3.dense_intersect_super_plain.calls)
    got = tk3.dense_intersect_super(*args, F)
    want = tk3.dense_intersect_super_plain(*args, F)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tk3.dense_intersect_super.launches == before[0]
    assert tk3.dense_intersect_super_plain.calls == before[1] + 2
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk3.dense_intersect_super(*(a.to("meta") for a in args), F)
    with pytest.raises(ValueError):
        tk3.dense_intersect_super(*args, 0)


@pytest.mark.parametrize("super_list", [255, 1])
def test_trace_packets_super_route(scene, super_list):
    """The super route equals brute force and the JAX package's super
    route exactly; super_list = 1 drops supers, so U is finite and the
    fine-BVH fallback runs."""
    jnp, JVec3 = scene["jnp"], scene["JVec3"]
    o, d, mask = rays("camera")
    kw = dict(tile_size=64, sort=True, two_level="super", super_factor=F,
              super_list=super_list)
    tpd = scene["tpd"]
    assert tpk.route(tpd.num_clusters, tpd.cluster_size, "super", F) \
        == "super"
    calls = tk3.dense_intersect_super_plain.calls
    hit = tpk.trace_packets(tv(o), tv(d), tpd, fine_td=scene["ttd"],
                            mask=torch.from_numpy(mask), **kw)
    assert tk3.dense_intersect_super_plain.calls == calls + 1
    ref = scene["jpk"].trace_packets(
        JVec3(*(jnp.asarray(c) for c in o)),
        JVec3(*(jnp.asarray(c) for c in d)), scene["jpd"],
        fine_td=scene["jtd"], mask=jnp.asarray(mask),
        engine="pallas_interpret", **kw)
    brute = ttrav.trace_bruteforce(tv(o), tv(d), scene["ts"],
                                   mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(hit.tri.numpy(), brute.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), brute.t.numpy())
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(hit.t.numpy(), np.asarray(ref.t))
    assert (hit.tri.numpy() >= 0).sum() > 100


def test_render_super_route_matches_flat(scene):
    """RenderConfig's super knobs reach the packet engine: a 16^2 render on
    the super route equals the flat route's, pixel for pixel."""
    ts = scene["ts"]
    cam = T.make_camera(width=16, height=16, device="cpu")
    bvh = tren.build_bvh_for_scene(ts, 4, cluster_size=128)
    imgs = []
    for kw in (dict(two_level_cull=False),
               dict(two_level_cull="super", super_factor=F, super_list=3)):
        cfg = T.RenderConfig(width=16, height=16, spp=1, integrator="pt_nee",
                             cluster_size=128, tile_size=64, **kw)
        calls = tk3.dense_intersect_super_plain.calls
        st = T.render(ts, cam, cfg, seed=7, bvh=bvh, device="cpu")
        assert (tk3.dense_intersect_super_plain.calls > calls) == (
            kw["two_level_cull"] == "super")
        imgs.append(np.stack([c.numpy() for c in st.img]))
    np.testing.assert_array_equal(imgs[0], imgs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_cuda_kernel_matches_plain(kind):
    """On a card: K3 and its plain version agree bit for bit, and the
    wrapper counts the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    ts = tproc.to_scene(tproc.cornell_with_sphere_mesh(subdiv=SUBDIV), "cpu")
    tpd = packet_data(tren.build_bvh_for_scene(ts, 4, cluster_size=128), ts)
    sl = _shortlists(tpd, kind, True)
    args = [a.to(dev) for a in (sl.ids, sl.counts, sl.entries, sl.rays,
                                *tk1.pack_clusters(tpd))]
    n = tk3.dense_intersect_super.launches
    t, tri = tk3.dense_intersect_super(*args, F)
    torch.cuda.synchronize()
    assert tk3.dense_intersect_super.launches == n + 1
    pt, ptri = tk3.dense_intersect_super_plain(*args, F)
    np.testing.assert_array_equal(tri.cpu().numpy(), ptri.cpu().numpy())
    np.testing.assert_array_equal(t.cpu().numpy(), pt.cpu().numpy())
