"""K2, the stream kernel (cudapathtracer_tpu_torch/ops/kernels/dense.py),
and the packet engine's stream route.

Its plain version is held against the JAX package's Pallas kernel
dense_intersect(..., interpret=True) on identical shortlists, at C = 128 as
in tests/test_packets.py:206-248: triangle ids exactly, t to rtol 1e-6 /
atol 1e-6 (tests/test_packets.py:247) with Baldwin-Weber (bw=True) and bit
for bit with Moller-Trumbore (bw=False). trace_packets, forced onto the
stream route by shrinking the port's copy of the resident budget (as
tests/test_packets.py:240 shrinks the JAX package's), equals brute force
and the JAX package's trace_packets(engine="pallas_interpret") exactly,
with either intersector.

The CUDA kernel runs only on a card: its cases are marked ``cuda`` and skip
elsewhere. The JAX package is imported only by the cases that compare
against it, so the CUDA cases also run where JAX is not installed:
``python -m pytest -o addopts="" --noconftest -m cuda
tests/test_torch_dense_stream.py``."""

import numpy as np
import pytest
import torch
from torch_fold_cases import (SYNTHETIC_CASES, VIS_BAND, check_vis,
                              colonnade_case, jax_scene, rays, shortlists,
                              tv, vis_case, with_mt)

from cudapathtracer_tpu_torch.ops import packets as tpk
from cudapathtracer_tpu_torch.ops import traversal as ttrav
from cudapathtracer_tpu_torch.ops.kernels import dense as tk2
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as tk1
from cudapathtracer_tpu_torch.ops.kernels.work import needed_work


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
    return jax_scene(subdiv=2)


@pytest.mark.parametrize("kind,sort,intersector", with_mt(
    [("camera", False), ("camera", True), ("random", True)]))
def test_plain_matches_pallas_interpret(scene, kind, sort, intersector):
    mt = intersector == "mt"
    sl = shortlists(scene["tpd"], kind, sort)
    assert int(sl.counts.max()) >= 2
    t, tri = tk2.dense_intersect_plain(sl.ids, sl.counts, sl.entries,
                                       sl.rays,
                                       *scene["pack_mt" if mt else "pack"])
    jnp = scene["jnp"]
    jt, jtri = scene["jd"].dense_intersect(
        jnp.asarray(sl.ids.numpy()), jnp.asarray(sl.counts.numpy()),
        jnp.asarray(sl.entries.numpy()), jnp.asarray(sl.rays.numpy()),
        scene["jpack_mt" if mt else "jpack"], scene["jboxes"],
        scene["js"].num_tris, interpret=True, bw=not mt)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    if mt:
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    else:
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6,
                                   atol=1e-6)
    assert (tri.numpy() >= 0).sum() > 100


def test_wrapper_takes_plain_version_on_cpu(scene):
    sl = shortlists(scene["tpd"], "camera", True)
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *scene["pack"])
    before = (tk2.dense_intersect.launches, tk2.dense_intersect_plain.calls,
              tk1.dense_intersect_resident_plain.calls)
    got = tk2.dense_intersect(*args)
    want = tk1.dense_intersect_resident_plain(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tk2.dense_intersect.launches == before[0]
    assert tk2.dense_intersect_plain.calls == before[1] + 1
    assert tk1.dense_intersect_resident_plain.calls == before[2] + 1
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk2.dense_intersect(*(a.to("meta") for a in args))
    with pytest.raises(ValueError):
        tk2.dense_intersect(sl.ids.long(), *args[1:])
    with pytest.raises(ValueError, match="counts_out"):
        tk2.dense_intersect(*args, counts_out=torch.zeros(
            (sl.ids.shape[0], 2), dtype=torch.int64))


@pytest.mark.parametrize("masked,intersector", with_mt([False, True]))
def test_trace_packets_stream_route(scene, monkeypatch, masked,
                                    intersector):
    """The stream route, forced on a resident-eligible scene, equals brute
    force and the JAX package's DMA-kernel route exactly, with either
    intersector; a two-cluster shortlist drops candidates (K = 4), so the
    fallback walk runs too."""
    jnp, JVec3 = scene["jnp"], scene["JVec3"]
    o, d, mask = rays("camera")
    if not masked:
        mask = np.ones_like(mask)
    kw = dict(tile_size=64, max_clusters=2, sort=True,
              intersector=intersector)
    monkeypatch.setattr(tk1, "RESIDENT_VMEM_BUDGET", 1024)
    tpd = scene["tpd"]
    assert tpk.route(tpd.num_clusters, tpd.cluster_size).kernel == "stream"
    calls = tk2.dense_intersect_plain.calls
    hit = tpk.trace_packets(tv(o), tv(d), tpd, fine_td=scene["ttd"],
                            mask=torch.from_numpy(mask), **kw)
    assert tk2.dense_intersect_plain.calls == calls + 1

    monkeypatch.setattr(scene["jdr"], "RESIDENT_VMEM_BUDGET", 1024)
    ref = scene["jpk"].trace_packets(
        JVec3(*(jnp.asarray(c) for c in o)),
        JVec3(*(jnp.asarray(c) for c in d)), scene["jpd"],
        fine_td=scene["jtd"], mask=jnp.asarray(mask),
        engine="pallas_interpret", **kw)
    brute = ttrav.trace_bruteforce(tv(o), tv(d), scene["ts"],
                                   mask=torch.from_numpy(mask),
                                   intersector=intersector)
    assert bool(torch.isfinite(tpk.build_shortlists(
        tv(o), tv(d), torch.from_numpy(mask), tpd, 64, 2).U).any())
    np.testing.assert_array_equal(hit.tri.numpy(), brute.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), brute.t.numpy())
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(hit.t.numpy(), np.asarray(ref.t))
    assert (hit.tri.numpy() >= 0).sum() > 100


@pytest.mark.cuda
@pytest.mark.parametrize("cluster_size,intersector",
                         with_mt([128, 512, 1024]))
def test_cuda_kernel_matches_plain_and_k1(cluster_size, intersector):
    """On a card: K2 equals its plain version and K1 bit for bit, at
    cluster widths of one to eight rounds of its 128 threads, with either
    intersector, and the wrapper counts the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    sl, pack, _ = colonnade_case(cluster_size, torch.device("cuda"),
                                 intersector=intersector)
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    n = tk2.dense_intersect.launches
    t, tri = tk2.dense_intersect(*args, intersector=intersector)
    torch.cuda.synchronize()
    assert tk2.dense_intersect.launches == n + 1
    for want in (tk2.dense_intersect_plain(*args),
                 tk1.dense_intersect_resident(*args,
                                              intersector=intersector)):
        np.testing.assert_array_equal(tri.cpu().numpy(), want[1].cpu().numpy())
        np.testing.assert_array_equal(t.cpu().numpy(), want[0].cpu().numpy())
    assert (tri >= 0).sum() > 100


@pytest.mark.cuda
@pytest.mark.parametrize("cluster_size", [128, 512, 1024])
def test_cuda_counting_instance(cluster_size):
    """On a card: K2's counting instance returns the timed instance's hits,
    folds per tile exactly what the plain count of its block per tile folds
    (K1 folds in blocks of at most 128 rays, tdr.k1_group, so at P = 256 the
    two fold different slots), and both issue at least the tests the rays
    need."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    sl, pack, num_tris = colonnade_case(cluster_size, torch.device("cuda"))
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    t, tri = tk2.dense_intersect(*args)
    c2 = torch.empty((sl.ids.shape[0], tk1.COUNT_COLS), dtype=torch.int64,
                     device="cuda")
    c1 = torch.empty_like(c2)
    t2, tri2 = tk2.dense_intersect(*args, counts_out=c2)
    tk1.dense_intersect_resident(*args, counts_out=c1)
    torch.cuda.synchronize()
    assert torch.equal(t, t2) and torch.equal(tri, tri2)
    P = sl.rays.shape[2]
    assert torch.equal(c2[:, 0], tk1.fold_schedule(*args, P)[2])
    assert bool((c2[:, 0] <= sl.counts).all())
    needed = needed_work(sl, t, pack, num_tris)[0]
    assert needed > 0
    assert needed <= int(c2[:, 1].sum()) and needed <= int(c1[:, 1].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("case,intersector",
                         with_mt(SYNTHETIC_CASES + ("colonnade",)))
def test_cuda_vis_instance(case, intersector):
    """On a card: K2's visibility instance against its plain version (t bit
    for bit, the -3e38 set included; ids wherever t is not -3e38) and, in
    full, against the plain count of its block-per-tile schedule; its
    counting instance folds what that schedule folds. Either
    intersector."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    args = vis_case(case, 128, 128, "cuda", intersector=intersector)
    n = tk2.dense_intersect.launches
    got = tk2.dense_intersect(*args, vis_band=VIS_BAND,
                              intersector=intersector)
    torch.cuda.synchronize()
    assert tk2.dense_intersect.launches == n + 1
    check_vis(args, got, tk2.dense_intersect_plain, group=128)
    counts = torch.empty((args[0].shape[0], tk1.COUNT_COLS),
                         dtype=torch.int64, device="cuda")
    tc, tric = tk2.dense_intersect(*args, counts_out=counts,
                                   vis_band=VIS_BAND,
                                   intersector=intersector)
    assert torch.equal(tc, got[0]) and torch.equal(tric, got[1])
    assert torch.equal(counts[:, 0], tk1.fold_schedule(
        *args, 128, vis_band=VIS_BAND)[2])
