"""K1, the dense cluster kernel (cudapathtracer_tpu_torch/ops/kernels/
dense_resident.py): its plain PyTorch version against the JAX package's
Pallas kernel dense_intersect_resident(..., interpret=True) on identical
shortlists, at C = 128 as in tests/test_packets.py:173-203, with either
triangle test: Baldwin-Weber (bw=True) and Moller-Trumbore (bw=False).

Triangle ids match exactly; t to rtol 1e-6 for Baldwin-Weber, the
tolerance tests/test_packets.py:202 holds the JAX package's engines to, and
bit for bit for Moller-Trumbore. The CUDA
kernel itself runs only on a card: its case is marked ``cuda`` and skips
elsewhere. The JAX package is imported only by the cases that compare
against it, so the CUDA case also runs where JAX is not installed:
``python -m pytest -o addopts="" --noconftest -m cuda
tests/test_torch_dense_resident.py``."""

import numpy as np
import pytest
import torch
from torch_fold_cases import (
    SYNTHETIC_CASES,
    VIS_BAND,
    check_vis,
    colonnade_case,
    jax_scene,
    packet_data,
    shortlists,
    synthetic_case,
    vis_case,
    with_mt,
)

from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as tdr
from cudapathtracer_tpu_torch.ops.kernels.work import OPS_PER_TEST, needed_work
from cudapathtracer_tpu_torch.render import renderer as tren


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


def test_resident_fits_matches_jax():
    from cudapathtracer_tpu.ops.pallas import dense_resident as jdr

    for k, c in ((115, 256), (459, 1024), (1842, 256), (4000, 1024)):
        assert tdr.resident_fits(k, c) == jdr.resident_fits(k, c)


def test_pack_matches_jax_rows(scene):
    packed, tri, boxes = scene["pack"]
    jpack = np.asarray(scene["jpack"])
    K1, _, C = packed.shape
    assert K1 == scene["tpd"].num_clusters + 1 and C == 128
    np.testing.assert_array_equal(packed.numpy(), jpack[:, :12, :C])
    np.testing.assert_array_equal(
        tri.numpy(), (jpack[:, 12, :C] - float(1 << 23)).astype(np.int32))
    jb = np.asarray(scene["jboxes"]).reshape(-1, 8)[:K1, :6]
    np.testing.assert_array_equal(boxes.numpy()[:-1], jb[:-1])
    assert (np.sort(tri.numpy()[:-1][tri.numpy()[:-1] < scene["js"].num_tris])
            == np.arange(scene["js"].num_tris)).all()


def test_mt_pack_matches_jax_rows(scene):
    """The Moller-Trumbore pack: rows v0, e1, e2 equal to the JAX package's
    pack_clusters_resident rows 0-8, its row 9 less 2^23 equal to the ids,
    the boxes and ids those of the Baldwin-Weber pack."""
    packed, tri, boxes = scene["pack_mt"]
    jpack = np.asarray(scene["jpack_mt"])
    K1, rows, C = packed.shape
    assert rows == tdr.ROWS["mt"] == 9 and C == 128
    np.testing.assert_array_equal(packed.numpy(), jpack[:, :9, :C])
    np.testing.assert_array_equal(
        tri.numpy(), (jpack[:, 9, :C] - float(1 << 23)).astype(np.int32))
    assert torch.equal(tri, scene["pack"][1])
    assert torch.equal(boxes, scene["pack"][2])
    assert not packed[-1].any()          # the sentinel cluster: all zero


def _interpret_cases():
    """(kind, sort, intersector), the Baldwin-Weber cases under the ids
    they had before the Moller-Trumbore ones joined them."""
    for kind, sort in (("camera", False), ("camera", True), ("random", True)):
        yield pytest.param(kind, sort, "bw", id=f"{kind}-{sort}")
        yield pytest.param(kind, sort, "mt", id=f"{kind}-{sort}-mt")


@pytest.mark.parametrize("kind,sort,intersector", _interpret_cases())
def test_plain_matches_pallas_interpret(scene, kind, sort, intersector):
    mt = intersector == "mt"
    sl = shortlists(scene["tpd"], kind, sort)
    assert int(sl.counts.max()) >= 2
    t, tri = tdr.dense_intersect_resident_plain(
        sl.ids, sl.counts, sl.entries, sl.rays,
        *scene["pack_mt" if mt else "pack"])
    jnp = scene["jnp"]
    jt, jtri = scene["jdr"].dense_intersect_resident(
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
    before = (tdr.dense_intersect_resident.launches,
              tdr.dense_intersect_resident_plain.calls)
    got = tdr.dense_intersect_resident(sl.ids, sl.counts, sl.entries,
                                       sl.rays, *scene["pack"])
    want = tdr.dense_intersect_resident_plain(sl.ids, sl.counts, sl.entries,
                                              sl.rays, *scene["pack"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tdr.dense_intersect_resident.launches == before[0]
    assert tdr.dense_intersect_resident_plain.calls == before[1] + 2


def test_wrapper_checks_inputs(scene):
    sl = shortlists(scene["tpd"], "camera", True)
    with pytest.raises(ValueError):
        tdr.dense_intersect_resident(sl.ids.long(), sl.counts, sl.entries,
                                     sl.rays, *scene["pack"])
    # a pack of the other intersector's rows, or of neither's
    args = (sl.ids, sl.counts, sl.entries, sl.rays)
    with pytest.raises(ValueError, match="mt"):
        tdr.dense_intersect_resident(*args, *scene["pack"], intersector="mt")
    with pytest.raises(ValueError, match="bw"):
        tdr.dense_intersect_resident(*args, *scene["pack_mt"])
    packed, tri, boxes = scene["pack"]
    with pytest.raises(ValueError, match="10 rows"):
        tdr.plain_fold(*args, packed[:, :10].contiguous(), tri, boxes)
    with pytest.raises(ValueError, match="intersector"):
        tdr.pack_clusters(scene["tpd"], "xyz")
    with pytest.raises(ValueError, match="counts_out"):
        tdr.dense_intersect_resident(
            sl.ids, sl.counts, sl.entries, sl.rays, *scene["pack"],
            counts_out=torch.zeros((sl.ids.shape[0], 2), dtype=torch.int64))


def _schedule_reference(args, group):
    """The gated schedule's clusters folded per tile, tile by tile and group
    by group in plain Python: a group ends at the first slot whose entry no
    live ray of it reaches; a ray folds a slot's cluster when it passes the
    cluster's box gate at its current t; the group folds it when any of its
    rays does."""
    ids, counts, entries, rays, packed, tri, boxes = args
    Tl, P = rays.shape[0], rays.shape[2]
    inv = tdr.guarded_inv(rays[:, 3:6])
    folds = []
    for i in range(Tl):
        t, best = tdr._init(rays[i:i + 1])
        t, best = t[0], best[0]
        live = rays[i, 6] > 0.5
        n = 0
        for g0 in range(0, P, group):
            lanes = slice(g0, g0 + group)
            for s in range(int(counts[i])):
                if not bool((live[lanes] & (t[lanes] >= entries[i, s])).any()):
                    break
                sid = ids[i, s].long()
                gate = live[lanes] & tdr.box_gate(
                    boxes[sid], [rays[i, k, lanes] for k in range(3)],
                    [inv[i, k, lanes] for k in range(3)], t[lanes])
                if not bool(gate.any()):
                    continue
                n += 1
                tn, idn = tdr._slot_hits(rays[i:i + 1], packed, tri,
                                         sid[None])
                tn, idn = tn[0, lanes], idn[0, lanes]
                tb, ib = t[lanes], best[lanes]
                better = gate & ((tn < tb) | ((tn == tb) & (idn < ib)))
                t[lanes] = torch.where(better, tn, tb)
                best[lanes] = torch.where(better, idn, ib)
        folds.append(n)
    return torch.tensor(folds, dtype=torch.int64)


@pytest.mark.parametrize("case,intersector", with_mt(SYNTHETIC_CASES) + [
    pytest.param("colonnade", "bw", id="colonnade")])
@pytest.mark.parametrize("group", [32, 64, 128])
def test_fold_schedule_counts_and_hits(case, group, intersector):
    """fold_schedule on tiles of P = 128 rays, the plain count of groups
    of one warp (32), of blocks that cover part of a tile (64, as K1's
    blocks of 128 do at P = 256) and of a block per tile (128, K2's), folds
    per tile what a Python loop over tiles, groups and slots folds, and
    returns plain_fold's hits bit for bit: the gates skip only clusters that
    cannot improve a hit. The same with Moller-Trumbore packs."""
    if case == "colonnade":
        sl, pack, _ = colonnade_case(128, torch.device("cpu"))
        args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    else:
        args, _ = synthetic_case(case, 128, 128, intersector=intersector)
    t, tri, folds = tdr.fold_schedule(*args, group)
    want_t, want_tri = tdr.plain_fold(*args)
    np.testing.assert_array_equal(t.numpy().view(np.int32),
                                  want_t.numpy().view(np.int32))
    np.testing.assert_array_equal(tri.numpy(), want_tri.numpy())
    np.testing.assert_array_equal(folds.numpy(),
                                  _schedule_reference(args, group).numpy())
    assert bool((folds <= args[1].long() * (128 // group)).all())


@pytest.mark.parametrize("tile_size,group", [(32, 32), (64, 64), (96, 96),
                                             (128, 128), (256, 128),
                                             (384, 128), (1024, 128)])
def test_k1_group(tile_size, group):
    """K1's blocks: min(K1_BLOCK_RAYS, P) rays, halved until they divide
    the tile size P, so a block never straddles two tiles."""
    assert tdr.k1_group(tile_size) == group
    assert tile_size % group == 0 and group <= tdr.K1_BLOCK_RAYS


@pytest.mark.parametrize("case", SYNTHETIC_CASES + ("colonnade",))
@pytest.mark.parametrize("group", [32, 128])
def test_vis_band_plain_and_schedule(case, group):
    """The visibility query on the CPU: the plain version sets t to -3e38
    exactly where the closest hit lies below cap - vis_band; the plain count
    of a schedule that retires rays as the kernels do gives the same t, the
    closest hit's id on every ray it keeps, and folds no more clusters than
    the closest-hit schedule."""
    args = vis_case(case, 128, 128)
    st, stri, folds = tdr.fold_schedule(*args, group, vis_band=VIS_BAND)
    retired = check_vis(args, (st, stri))
    if case in ("band", "colonnade"):
        assert retired > 0
    assert bool((folds <= tdr.fold_schedule(*args, group)[2]).all())
    with pytest.raises(ValueError, match="vis_band"):
        tdr.plain_fold(*args, vis_band=-1.0)


def test_fold_schedule_checks_group():
    args, _ = synthetic_case("ties", 128, 128)
    with pytest.raises(ValueError, match="group"):
        tdr.fold_schedule(*args, 48)


# the cases whose caps do not come from a fold of their own pack
@pytest.mark.parametrize("case", [c for c in SYNTHETIC_CASES
                                  if c not in ("cap_is_hit", "band")])
def test_mt_and_bw_folds_agree(case):
    """The Moller-Trumbore fold against the Baldwin-Weber one on the same
    inputs: the JAX package's cross-intersector contract
    (tests/test_packets.py:364-386), t to rtol 2e-5 where both hit and
    under 6% of the live rays flipping between hit and miss; the padding's
    all-zero rows never hit in either."""
    bw, T = synthetic_case(case, 128, 128)
    mt, _ = synthetic_case(case, 128, 128, intersector="mt")
    assert mt[4].shape[1] == 9 and all(torch.equal(a, b) for a, b in
                                       zip(bw[:4] + bw[5:], mt[:4] + mt[5:]))
    tb, ib = tdr.plain_fold(*bw)
    tm, im = tdr.plain_fold(*mt)
    live = bw[3][:, 6] > 0.5
    both = live & (ib >= 0) & (im >= 0)
    np.testing.assert_allclose(tm[both].numpy(), tb[both].numpy(),
                               rtol=2e-5, atol=2e-6)
    flips = live & ((ib >= 0) != (im >= 0))
    assert int(flips.sum()) < 0.06 * int(live.sum())
    assert int(both.sum()) > 100
    assert bool((ib < T).all()) and bool((im < T).all())


def test_needed_work_reads_the_mt_pack(scene):
    """needed_work over a Moller-Trumbore pack: the same real triangles
    (e1 x e2 is the Baldwin-Weber pack's normal row) and tests as over the
    Baldwin-Weber pack, 9 rows' bytes, MT's own operations per test."""
    sl = shortlists(scene["tpd"], "camera", True)
    t, _ = tdr.plain_fold(sl.ids, sl.counts, sl.entries, sl.rays,
                          *scene["pack"])
    nt = scene["ts"].num_tris
    tests, touched, nbytes = needed_work(sl, t, scene["pack"], nt)
    mtests, mtouched, mbytes = needed_work(sl, t, scene["pack_mt"], nt)
    C = scene["pack"][0].shape[2]
    assert (mtests, mtouched) == (tests, touched) and tests > 0
    assert nbytes - mbytes == touched * 3 * C * 4
    assert OPS_PER_TEST["mt"] > OPS_PER_TEST["bw"]


def test_max_float_tie_keeps_the_init():
    """A hit at exactly t = MAX_FLOAT ties the init (MAX_FLOAT, -1) of a ray
    whose cap lies past it, and loses the tie: the ray keeps (MAX_FLOAT,
    -1). So no test at MAX_FLOAT, hit or reject, ever wins, though the
    kernels' guard before the key's atomic (gated_fold.cuh:fold_listed,
    ts <= the ray's t) lets such a test through."""
    args, _ = synthetic_case("max_float_cap", 128, 128)
    ids, counts, entries, rays, packed, tri, boxes = args
    far = packed.shape[0] - 2           # the far cluster, before the sentinel
    assert far in ids[0, :counts[0]].tolist()
    tn, idn = tdr._slot_hits(rays[:1], packed, tri, torch.tensor([far]))
    assert bool((tn == 1e5).all()) and bool((idn[0] == tri[far, 0]).all())
    assert bool((rays[0, 7] > 1e5).all())
    t, best = tdr.plain_fold(*args)
    assert bool((t[0] == 1e5).all()) and bool((best[0] == -1).all())
    assert int((best[1:] >= 0).sum()) > 100


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_cuda_kernel_matches_plain(kind):
    """On a card: K1 and its plain version agree bit for bit on 64-ray
    tiles, and the wrapper counts the launch."""
    dev = _cuda()
    ts = tproc.to_scene(tproc.cornell_with_sphere_mesh(subdiv=2), "cpu")
    tpd = packet_data(tren.build_bvh_for_scene(ts, 4, cluster_size=128), ts)
    sl = shortlists(tpd, kind, True)
    args = [a.to(dev) for a in (sl.ids, sl.counts, sl.entries, sl.rays,
                                *tdr.pack_clusters(tpd))]
    n = tdr.dense_intersect_resident.launches
    t, tri = tdr.dense_intersect_resident(*args)
    torch.cuda.synchronize()
    assert tdr.dense_intersect_resident.launches == n + 1
    pt, ptri = tdr.dense_intersect_resident_plain(*args)
    np.testing.assert_array_equal(tri.cpu().numpy(), ptri.cpu().numpy())
    np.testing.assert_array_equal(t.cpu().numpy(), pt.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("cluster_size,intersector", with_mt([128, 1024]))
def test_cuda_counting_instance(cluster_size, intersector):
    """On a card: K1's counting instance returns the timed instance's hits,
    folds per tile exactly what the plain count of its schedule folds, and
    issues at least the tests the rays need, in whole warps, and at most C
    tests for each ray of a group that folds a cluster."""
    dev = _cuda()
    sl, pack, num_tris = colonnade_case(cluster_size, dev,
                                        intersector=intersector)
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    t, tri = tdr.dense_intersect_resident(*args, intersector=intersector)
    counts = torch.empty((sl.ids.shape[0], tdr.COUNT_COLS),
                         dtype=torch.int64, device=dev)
    tc, tric = tdr.dense_intersect_resident(*args, counts_out=counts,
                                            intersector=intersector)
    torch.cuda.synchronize()
    assert torch.equal(t, tc) and torch.equal(tri, tric)
    group = tdr.k1_group(sl.rays.shape[2])
    assert torch.equal(counts[:, 0], tdr.fold_schedule(*args, group)[2])
    assert bool((counts[:, 1] % 32 == 0).all())
    assert needed_work(sl, t, pack, num_tris)[0] <= int(counts[:, 1].sum())
    assert int(counts[:, 1].sum()) <= cluster_size * group * int(
        counts[:, 0].sum())
    assert bool((counts[:, 2:] >= 0).all()) and int(counts[:, 2:].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cluster_size,intersector",
                         with_mt([128, 256, 512, 1024]))
@pytest.mark.parametrize("tile_size", [128, 256])
def test_cuda_kernel_at_widths(cluster_size, tile_size, intersector):
    """On a card: K1 equals its plain version bit for bit at every cluster
    width the resident route sends it (multiples of 128) and both tile
    sizes, with either intersector, and the wrapper counts the launch."""
    dev = _cuda()
    sl, pack, _ = colonnade_case(cluster_size, dev, tile_size=tile_size,
                                 intersector=intersector)
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    n = tdr.dense_intersect_resident.launches
    t, tri = tdr.dense_intersect_resident(*args, intersector=intersector)
    torch.cuda.synchronize()
    assert tdr.dense_intersect_resident.launches == n + 1
    pt, ptri = tdr.dense_intersect_resident_plain(*args)
    np.testing.assert_array_equal(tri.cpu().numpy(), ptri.cpu().numpy())
    np.testing.assert_array_equal(t.cpu().numpy(), pt.cpu().numpy())
    assert (tri >= 0).sum() > 100


@pytest.mark.cuda
@pytest.mark.parametrize("case,intersector", with_mt(SYNTHETIC_CASES))
@pytest.mark.parametrize("cluster_size,tile_size", [(128, 128), (256, 256)])
def test_cuda_corner_cases(case, cluster_size, tile_size, intersector):
    """On a card: K1 equals its plain version bit for bit on exact-t ties,
    masked lanes, caps equal to a hit, negative caps, padding-heavy
    clusters (with Moller-Trumbore, all-zero rows that reject through
    |a| < eps) and hits at exactly MAX_FLOAT, with either intersector, and
    its counting instance folds what its schedule folds."""
    dev = _cuda()
    args, _ = synthetic_case(case, cluster_size, tile_size, dev,
                             intersector=intersector)
    t, tri = tdr.dense_intersect_resident(*args, intersector=intersector)
    pt, ptri = tdr.dense_intersect_resident_plain(*args)
    np.testing.assert_array_equal(tri.cpu().numpy(), ptri.cpu().numpy())
    np.testing.assert_array_equal(t.cpu().numpy(), pt.cpu().numpy())
    counts = torch.empty((args[0].shape[0], tdr.COUNT_COLS),
                         dtype=torch.int64, device=dev)
    tdr.dense_intersect_resident(*args, counts_out=counts,
                                 intersector=intersector)
    group = tdr.k1_group(tile_size)
    assert torch.equal(counts[:, 0], tdr.fold_schedule(*args, group)[2])



@pytest.mark.cuda
@pytest.mark.parametrize("case,intersector",
                         with_mt(SYNTHETIC_CASES + ("colonnade",)))
@pytest.mark.parametrize("cluster_size,tile_size", [(128, 128), (256, 256)])
def test_cuda_vis_instance(case, cluster_size, tile_size, intersector):
    """On a card: K1's visibility instance (vis_band > 0) against its plain
    version (t bit for bit, the -3e38 set included; ids wherever t is not
    -3e38) and, in full, against the plain count of its blocks' schedule;
    its counting instance folds what that schedule folds. Either
    intersector."""
    dev = _cuda()
    args = vis_case(case, cluster_size, tile_size, "cuda",
                    intersector=intersector)
    group = tdr.k1_group(tile_size)
    n = tdr.dense_intersect_resident.launches
    got = tdr.dense_intersect_resident(*args, vis_band=VIS_BAND,
                                       intersector=intersector)
    torch.cuda.synchronize()
    assert tdr.dense_intersect_resident.launches == n + 1
    check_vis(args, got, group=group)
    counts = torch.empty((args[0].shape[0], tdr.COUNT_COLS),
                         dtype=torch.int64, device=dev)
    tc, tric = tdr.dense_intersect_resident(*args, counts_out=counts,
                                            vis_band=VIS_BAND,
                                            intersector=intersector)
    assert torch.equal(tc, got[0]) and torch.equal(tric, got[1])
    assert torch.equal(counts[:, 0], tdr.fold_schedule(
        *args, group, vis_band=VIS_BAND)[2])
