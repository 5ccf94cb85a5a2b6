"""K3, the super-shortlist kernel (cudapathtracer_tpu_torch/ops/kernels/
dense_super.py), and the packet engine's super route.

Its plain version is held against the JAX package's Pallas kernel
dense_intersect_resident_super(..., super_factor=2, interpret=True) on
identical super shortlists, at C = 128: triangle ids exactly, t to rtol
1e-6 / atol 1e-6 (tests/test_packets.py:247) with Baldwin-Weber (bw=True),
bit for bit with Moller-Trumbore (bw=False). The scene
is tests/test_packets.py:389-426's at subdiv 3 (1,316 triangles, K = 16
clusters): at subdiv 2, K = 4 is not above 2F, so both packages leave the
super route for the resident one there. trace_packets with
two_level="super", super_factor=2 equals brute force and the JAX package's
trace_packets(engine="pallas_interpret") exactly, with the whole super list
(255) and with a one-super list, which forces the dropped-super bound U and
the fine-BVH fallback, with either intersector.

The CUDA kernel runs only on a card: its case is marked ``cuda`` and skips
elsewhere. The JAX package is imported only by the cases that compare
against it, so the CUDA case also runs where JAX is not installed:
``python -m pytest -o addopts="" --noconftest -m cuda
tests/test_torch_dense_super.py``."""

import numpy as np
import pytest
import torch
from torch_fold_cases import (VIS_BAND, check_vis, colonnade_case,
                              jax_scene, packet_data, rays, shortlists, tv,
                              vis_case, with_mt)

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import packets as tpk
from cudapathtracer_tpu_torch.ops import traversal as ttrav
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as tk1
from cudapathtracer_tpu_torch.ops.kernels import dense_super as tk3
from cudapathtracer_tpu_torch.ops.kernels.work import needed_work
from cudapathtracer_tpu_torch.render import renderer as tren

F = 2
SUBDIV = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU, and torch's default of a thread per core in each of them
    oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("kind,sort,intersector", with_mt(
    [("camera", False), ("camera", True), ("random", True)]))
def test_plain_matches_pallas_interpret(scene, kind, sort, intersector):
    mt = intersector == "mt"
    sl = _shortlists(scene["tpd"], kind, sort)
    assert int(sl.counts.max()) >= 2
    t, tri = tk3.dense_intersect_super_plain(
        sl.ids, sl.counts, sl.entries, sl.rays,
        *scene["pack_mt" if mt else "pack"], F)
    jnp = scene["jnp"]
    jt, jtri = scene["jdr"].dense_intersect_resident_super(
        jnp.asarray(sl.ids.numpy()), jnp.asarray(sl.counts.numpy()),
        jnp.asarray(sl.entries.numpy()), jnp.asarray(sl.rays.numpy()),
        scene["jpack_mt" if mt else "jpack"], scene["jboxes"],
        scene["js"].num_tris, super_factor=F, interpret=True, bw=not mt)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    if mt:
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    else:
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
    with pytest.raises(ValueError, match="counts_out"):
        tk3.dense_intersect_super(*args, F, counts_out=torch.zeros(
            (sl.ids.shape[0], 2), dtype=torch.int64))


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_needed_work_counts_members(scene, kind):
    """The tests a super shortlist needs are those of its expansion into
    K1's member shortlist, and no more than the plain fold's ungated tests
    of the live rays."""
    sl = _shortlists(scene["tpd"], kind, True)
    pack = scene["pack"]
    t, _ = tk3.dense_intersect_super_plain(sl.ids, sl.counts, sl.entries,
                                           sl.rays, *pack, F)
    num_tris = scene["ts"].num_tris
    tests, touched, _ = needed_work(sl, t, pack, num_tris, F)
    m_ids, m_counts, m_entries = tk3.expand_supers(
        sl.ids, sl.counts, sl.entries, F, pack[0].shape[0] - 1)
    flat = type(sl)(m_ids, m_counts, m_entries, sl.rays, sl.U)
    assert (tests, touched) == needed_work(flat, t, pack, num_tris)[:2]
    live = (sl.rays[:, 6] > 0.5).sum(dim=1)
    C = pack[0].shape[2]
    assert 0 < tests <= int((m_counts * live).sum()) * C


@pytest.mark.parametrize("super_list,intersector", with_mt([255, 1]))
def test_trace_packets_super_route(scene, super_list, intersector):
    """The super route equals brute force and the JAX package's super
    route exactly, with either intersector; super_list = 1 drops supers,
    so U is finite and the fine-BVH fallback runs."""
    jnp, JVec3 = scene["jnp"], scene["JVec3"]
    o, d, mask = rays("camera")
    kw = dict(tile_size=64, sort=True, two_level="super", super_factor=F,
              super_list=super_list, intersector=intersector)
    tpd = scene["tpd"]
    assert tpk.route(tpd.num_clusters, tpd.cluster_size, "super",
                     F).kernel == "super"
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
                                   mask=torch.from_numpy(mask),
                                   intersector=intersector)
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


@pytest.mark.cuda
@pytest.mark.parametrize("cluster_size,intersector",
                         with_mt([128, 512, 1024]))
def test_cuda_kernel_at_cluster_widths(cluster_size, intersector):
    """On a card, at F = 8 on colonnade subdiv 3: K3 equals its plain
    version bit for bit at cluster widths of one to eight rounds of its 128
    threads, with either intersector; its counting instance returns the
    same hits, folds at most the listed members and issues at least the
    tests the rays need."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    f = 8
    sl, pack, num_tris = colonnade_case(cluster_size, torch.device("cuda"),
                                        super_factor=f,
                                        intersector=intersector)
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    t, tri = tk3.dense_intersect_super(*args, f, intersector=intersector)
    counts = torch.empty((sl.ids.shape[0], tk1.COUNT_COLS),
                         dtype=torch.int64, device="cuda")
    tc, tric = tk3.dense_intersect_super(*args, f, counts_out=counts,
                                         intersector=intersector)
    pt, ptri = tk3.dense_intersect_super_plain(*args, f)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(tri.cpu().numpy(), ptri.cpu().numpy())
    np.testing.assert_array_equal(t.cpu().numpy(), pt.cpu().numpy())
    assert torch.equal(t, tc) and torch.equal(tri, tric)
    assert bool((counts[:, 0] <= sl.counts * f).all())
    assert needed_work(sl, t, pack, num_tris, f)[0] <= int(counts[:, 1].sum())
    assert (tri >= 0).sum() > 100


def _super_plain(f):
    def fold(*args, vis_band=0.0):
        return tk3.dense_intersect_super_plain(*args, f, vis_band)
    return fold


def test_vis_band_super_plain():
    """K3's plain version of a visibility query on super shortlists (F = 8,
    colonnade subdiv 3): t is -3e38 exactly where the closest hit over the
    members lies below the floor, the closest hit elsewhere."""
    f = 8
    args = vis_case("colonnade", 128, 128, F=f, fold=_super_plain(f))
    got = tk3.dense_intersect_super_plain(*args, f, VIS_BAND)
    assert check_vis(args, got, _super_plain(f)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cluster_size,intersector",
                         with_mt([128, 256, 1024]))
def test_cuda_vis_instance(cluster_size, intersector):
    """On a card, at F = 8 on colonnade subdiv 3 with caps near each ray's
    closest hit: K3's visibility instance against its plain version, t bit
    for bit (the -3e38 set included) and ids wherever t is not -3e38; its
    counting instance returns the same hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    f = 8
    args = vis_case("colonnade", cluster_size, 128, "cuda", F=f,
                    fold=_super_plain(f), intersector=intersector)
    n = tk3.dense_intersect_super.launches
    got = tk3.dense_intersect_super(*args, f, vis_band=VIS_BAND,
                                    intersector=intersector)
    torch.cuda.synchronize()
    assert tk3.dense_intersect_super.launches == n + 1
    assert check_vis(args, got, _super_plain(f)) > 0
    counts = torch.empty((args[0].shape[0], tk1.COUNT_COLS),
                         dtype=torch.int64, device="cuda")
    tc, tric = tk3.dense_intersect_super(*args, f, counts_out=counts,
                                         vis_band=VIS_BAND,
                                         intersector=intersector)
    assert torch.equal(tc, got[0]) and torch.equal(tric, got[1])
