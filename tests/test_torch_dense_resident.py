"""K1, the dense cluster kernel (cudapathtracer_tpu_torch/ops/kernels/
dense_resident.py): its plain PyTorch version against the JAX package's
Pallas kernel dense_intersect_resident(..., bw=True, interpret=True) on
identical shortlists, at C = 128 as in tests/test_packets.py:173-203.

Triangle ids match exactly; t to rtol 1e-6, the tolerance
tests/test_packets.py:202 holds the JAX package's engines to. The CUDA
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
)

from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as tdr
from cudapathtracer_tpu_torch.ops.kernels.work import needed_work
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


@pytest.mark.parametrize("kind,sort", [("camera", False), ("camera", True),
                                       ("random", True)])
def test_plain_matches_pallas_interpret(scene, kind, sort):
    sl = shortlists(scene["tpd"], kind, sort)
    assert int(sl.counts.max()) >= 2
    t, tri = tdr.dense_intersect_resident_plain(
        sl.ids, sl.counts, sl.entries, sl.rays, *scene["pack"])
    jnp = scene["jnp"]
    jt, jtri = scene["jdr"].dense_intersect_resident(
        jnp.asarray(sl.ids.numpy()), jnp.asarray(sl.counts.numpy()),
        jnp.asarray(sl.entries.numpy()), jnp.asarray(sl.rays.numpy()),
        scene["jpack"], scene["jboxes"], scene["js"].num_tris,
        interpret=True, bw=True)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
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


@pytest.mark.parametrize("case", SYNTHETIC_CASES + ("colonnade",))
@pytest.mark.parametrize("group", [32, 64, 128])
def test_fold_schedule_counts_and_hits(case, group):
    """fold_schedule on tiles of P = 128 rays, the plain count of groups
    of one warp (32), of blocks that cover part of a tile (64, as K1's
    blocks of 128 do at P = 256) and of a block per tile (128, K2's), folds
    per tile what a Python loop over tiles, groups and slots folds, and
    returns plain_fold's hits bit for bit: the gates skip only clusters that
    cannot improve a hit."""
    if case == "colonnade":
        sl, pack, _ = colonnade_case(128, torch.device("cpu"))
        args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    else:
        args, _ = synthetic_case(case, 128, 128)
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
@pytest.mark.parametrize("cluster_size", [128, 1024])
def test_cuda_counting_instance(cluster_size):
    """On a card: K1's counting instance returns the timed instance's hits,
    folds per tile exactly what the plain count of its schedule folds, and
    issues at least the tests the rays need, in whole warps, and at most C
    tests for each ray of a group that folds a cluster."""
    dev = _cuda()
    sl, pack, num_tris = colonnade_case(cluster_size, dev)
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    t, tri = tdr.dense_intersect_resident(*args)
    counts = torch.empty((sl.ids.shape[0], tdr.COUNT_COLS),
                         dtype=torch.int64, device=dev)
    tc, tric = tdr.dense_intersect_resident(*args, counts_out=counts)
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
@pytest.mark.parametrize("cluster_size", [128, 256, 512, 1024])
@pytest.mark.parametrize("tile_size", [128, 256])
def test_cuda_kernel_at_widths(cluster_size, tile_size):
    """On a card: K1 equals its plain version bit for bit at every cluster
    width the resident route sends it (multiples of 128) and both tile
    sizes, and the wrapper counts the launch."""
    dev = _cuda()
    sl, pack, _ = colonnade_case(cluster_size, dev, tile_size=tile_size)
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    n = tdr.dense_intersect_resident.launches
    t, tri = tdr.dense_intersect_resident(*args)
    torch.cuda.synchronize()
    assert tdr.dense_intersect_resident.launches == n + 1
    pt, ptri = tdr.dense_intersect_resident_plain(*args)
    np.testing.assert_array_equal(tri.cpu().numpy(), ptri.cpu().numpy())
    np.testing.assert_array_equal(t.cpu().numpy(), pt.cpu().numpy())
    assert (tri >= 0).sum() > 100


@pytest.mark.cuda
@pytest.mark.parametrize("case", SYNTHETIC_CASES)
@pytest.mark.parametrize("cluster_size,tile_size", [(128, 128), (256, 256)])
def test_cuda_corner_cases(case, cluster_size, tile_size):
    """On a card: K1 equals its plain version bit for bit on exact-t ties,
    masked lanes, caps equal to a hit, negative caps, padding-heavy
    clusters and hits at exactly MAX_FLOAT, and its counting instance folds
    what its schedule folds."""
    dev = _cuda()
    args, _ = synthetic_case(case, cluster_size, tile_size, dev)
    t, tri = tdr.dense_intersect_resident(*args)
    pt, ptri = tdr.dense_intersect_resident_plain(*args)
    np.testing.assert_array_equal(tri.cpu().numpy(), ptri.cpu().numpy())
    np.testing.assert_array_equal(t.cpu().numpy(), pt.cpu().numpy())
    counts = torch.empty((args[0].shape[0], tdr.COUNT_COLS),
                         dtype=torch.int64, device=dev)
    tdr.dense_intersect_resident(*args, counts_out=counts)
    group = tdr.k1_group(tile_size)
    assert torch.equal(counts[:, 0], tdr.fold_schedule(*args, group)[2])



@pytest.mark.cuda
@pytest.mark.parametrize("case", SYNTHETIC_CASES + ("colonnade",))
@pytest.mark.parametrize("cluster_size,tile_size", [(128, 128), (256, 256)])
def test_cuda_vis_instance(case, cluster_size, tile_size):
    """On a card: K1's visibility instance (vis_band > 0) against its plain
    version (t bit for bit, the -3e38 set included; ids wherever t is not
    -3e38) and, in full, against the plain count of its blocks' schedule;
    its counting instance folds what that schedule folds."""
    dev = _cuda()
    args = vis_case(case, cluster_size, tile_size, "cuda")
    group = tdr.k1_group(tile_size)
    n = tdr.dense_intersect_resident.launches
    got = tdr.dense_intersect_resident(*args, vis_band=VIS_BAND)
    torch.cuda.synchronize()
    assert tdr.dense_intersect_resident.launches == n + 1
    check_vis(args, got, group=group)
    counts = torch.empty((args[0].shape[0], tdr.COUNT_COLS),
                         dtype=torch.int64, device=dev)
    tc, tric = tdr.dense_intersect_resident(*args, counts_out=counts,
                                            vis_band=VIS_BAND)
    assert torch.equal(tc, got[0]) and torch.equal(tric, got[1])
    assert torch.equal(counts[:, 0], tdr.fold_schedule(
        *args, group, vis_band=VIS_BAND)[2])
