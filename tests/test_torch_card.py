"""The port on the card, end to end, against oracles that do not depend on
the card: the golden files, the port's own CPU path, and the plain versions
of the kernels. Every case needs an NVIDIA GPU: it is marked ``cuda`` and
skips where torch finds none. The file imports no jax; the command that
runs the card tests is in tests/torch_card_helpers.py.

* the five goldens under tests/test_goldens.py:_check's rule;
* the ``bvh`` and ``brute`` engines bit for bit, with no fold launched;
* the packet engine's fine-BVH fallback against brute force;
* K1, K2 and K3 on the batches of real samples (PT+NEE with either
  intersector, BDPT's three batches and its joint subpath batch of two
  samples, the live config's): each kernel against its plain version, K1
  and K2 bit for bit on the same shortlists, K3's super shortlists, the
  counting instances against the plain count of their schedules, and the
  visibility instances on BDPT's capped connection rays;
* the same at the benchmark cells' sizes (1024^2 PT+NEE, 512^2 BDPT), the
  plain versions on tiles spread over each batch, and one pass of each
  launching K1 alone;
* each route (resident, stream, super, capped two-level) launching its
  kernel and the glue's FMA and threefry alone, no plain version run;
* the capped two-level cull's hits against the flat cull's;
* ``vis_dropout``, ``sample_batch`` 2, straggler rounds and a sort window,
  each rendering the default's image bit for bit;
* the train step at 64^2 and at the cells' 256^2 (at 1 spp no recompute
  and K1 once per trace call of the forward, a repeat's gradients; at 2
  spp sample 0 alone recomputed, its hits the forward's; at 256^2 and 4
  spp the peak memory of the kept last graph against every sample
  checkpointed), a finite difference,
  ``render_and_grad`` against the CPU, BDPT's step;
* ``entry()`` against ``entry("cpu")``, and each quirk flag against the
  same render on the CPU.

Scenes stay at colonnade subdiv 3 or smaller, and images at 64^2 or
smaller where the CPU renders an oracle (``entry``'s own 128^2 aside)."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch_card_helpers import (  # noqa: F401
    FOLDS, dev, image_rule, launched)

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import entry as E
from cudapathtracer_tpu_torch.diff import render_grad as rg
from cudapathtracer_tpu_torch.models import procedural
from cudapathtracer_tpu_torch.ops import packets, traversal
from cudapathtracer_tpu_torch.ops.kernels import dense as k2
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as k1
from cudapathtracer_tpu_torch.ops.kernels import dense_super as k3
from cudapathtracer_tpu_torch.ops.kernels import kernel_counts
from cudapathtracer_tpu_torch.ops.kernels.work import needed_work
from cudapathtracer_tpu_torch.ops.rng import pixel_keys, prng_key, sample_key
from cudapathtracer_tpu_torch.ops.vecmath import Vec3, stop_gradient
from cudapathtracer_tpu_torch.render import renderer
from cudapathtracer_tpu_torch.render.camera import camera_rays
from cudapathtracer_tpu_torch.utils.constants import EPS_VISIBILITY
from cudapathtracer_tpu_torch.utils.ppm import read_ppm

pytestmark = pytest.mark.cuda

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
SIZE = 64
# clusters per super of K3's shortlists
SUPER_F = 8
# a cluster width off the multiples of 128 that K1 takes: the stream route
STREAM_C = 64
# kernel against plain version: ids may differ only on exact-t ties, t by
# rounding where the ids agree
ID_MISMATCH_MAX = 1e-5
T_RTOL = 1e-6
# Moller-Trumbore against Baldwin-Weber on the same rays, the JAX
# package's contract (tests/test_packets.py:364-386)
MT_BW_RTOL = 2e-5
MT_BW_FLIPS_MAX = 0.06
# a repeat of the train step: each gradient array within this share of its
# largest |g| (the backward's atomics reorder sums)
REPEAT_FRAC = 1e-5
# the train cells' image side (h100_bench/traffic/train_256.json), and the
# edge samples of each boundary term there
TRAIN_SIZE = 256
TRAIN_EDGE_SAMPLES = 16384
# samples a step of the peak-memory case: three checkpointed, one kept
MEMORY_SPP = 4


def bits(st):
    return [t.view(torch.int32).cpu() for t in (*st.img, *st.comp)]


def assert_same_bits(a, b):
    assert all(torch.equal(x, y) for x, y in zip(bits(a), bits(b)))


def lit(st):
    img = torch.stack(list(st.img), dim=1)
    return bool(torch.isfinite(img).all()) and float(img.max()) > 0


def bench_camera(size, dev):
    return T.make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                         focal_length=2.0, device=dev)


def colonnade(dev, subdiv=3):
    return procedural.to_scene(procedural.colonnade(subdiv=subdiv), dev)


def cornell(dev):
    return procedural.to_scene(procedural.cornell_box(), dev)


def render(scene, cam, cfg, bvh=None, prep=None):
    """``render_batch`` of cfg.spp samples from a new accumulator, seed
    1234."""
    dev = cam.pos.x.device
    if bvh is None:
        bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size,
                                           cluster_size=cfg.cluster_size)
    return T.render_batch(scene, bvh, cam, cfg, prng_key(1234, dev),
                          T.init_accum(cfg, device=dev),
                          cfg.spp, prep=prep)


# ---- the goldens ------------------------------------------------------------

def _golden_scene(name, dev):
    if name == "cornell_sphere_pt_nee_32_spp8":
        return procedural.cornell_with_analytic_sphere(device=dev)
    return cornell(dev)


GOLDEN_RENDERS = {
    "cornell_pt_nee_64_spp16": (64, dict(spp=16, integrator="pt_nee")),
    "cornell_pt_nee_128_spp8": (128, dict(spp=8, integrator="pt_nee")),
    "cornell_sphere_pt_nee_32_spp8": (32, dict(spp=8, integrator="pt_nee")),
    "cornell_bdpt_32_spp8": (32, dict(spp=8)),
}


@pytest.mark.parametrize("name", list(GOLDEN_RENDERS))
def test_golden_on_the_card(dev, name):
    size, kw = GOLDEN_RENDERS[name]
    cfg = T.RenderConfig(width=size, height=size, samples_per_call=kw["spp"],
                         **kw)
    st = T.render(_golden_scene(name, dev),
                  T.make_camera(width=size, height=size, device=dev), cfg,
                  seed=1234, device=dev)
    image_rule(T.finalize_image(st, cfg)[:, ::-1],
               read_ppm(os.path.join(GOLDENS, f"{name}.ppm")))


def test_golden_bvh_falsecolor_on_the_card(dev):
    """The fine-BVH walk with its visit counts on the card."""
    from cudapathtracer_tpu_torch.utils.profiling import falsecolor_state

    scene = colonnade(dev, subdiv=2)
    cfg = T.RenderConfig(width=64, height=64, spp=1, samples_per_call=1,
                         integrator="pt_nee")
    st, stats = falsecolor_state(
        scene, renderer.build_bvh_for_scene(scene, cfg.leaf_size),
        bench_camera(64, dev), cfg, seed=1234)
    assert int(stats.ray_visits.max()) > 0
    image_rule(T.finalize_image(st, cfg)[:, ::-1], read_ppm(
        os.path.join(GOLDENS, "colonnade_bvh_falsecolor_64.ppm")))


# ---- the engines and the fallback ------------------------------------------

def test_bvh_and_brute_engines_bit_identical_without_a_fold(dev):
    imgs = {}
    before = kernel_counts()
    for tr in ("bvh", "brute"):
        cfg = T.RenderConfig(width=32, height=32, spp=4, samples_per_call=4,
                             integrator="pt_nee", traversal=tr)
        imgs[tr] = T.render(cornell(dev), T.make_camera(
            width=32, height=32, device=dev), cfg, seed=1234, device=dev)
    after = kernel_counts()
    assert all(after[k] == before[k] for k in after
               if k.startswith(FOLDS) or k == "plain_calls")
    assert_same_bits(imgs["bvh"], imgs["brute"])
    assert lit(imgs["bvh"])


@pytest.mark.parametrize("intersector", ["bw", "mt"])
def test_fallback_equals_brute_force(dev, intersector):
    """Primary rays through the packet engine with a one-cluster
    shortlist, so that the fine-BVH fallback runs on the card: the hits
    are brute force's."""
    scene = colonnade(dev)
    bvh = renderer.build_bvh_for_scene(scene, 4)
    prep = renderer.make_packet_prep(scene, bvh, intersector)
    P = renderer.resolve_tile_size(T.RenderConfig(), scene.num_tris)
    idx = torch.arange(SIZE * SIZE, dtype=torch.int64, device=dev)
    o, d = camera_rays(bench_camera(SIZE, dev), idx, pixel_keys(
        sample_key(prng_key(1234, dev), 0), idx), lens=False)
    mask = torch.ones(SIZE * SIZE, dtype=torch.bool, device=dev)
    hit = packets.trace_packets(
        o, d, prep.pdata, fine_td=traversal.make_trace_data(scene, bvh.fine),
        mask=mask, tile_size=P, max_clusters=1,
        resident_pack=prep.resident_pack, intersector=intersector)
    brute = traversal.trace_bruteforce(o, d, scene, intersector=intersector)
    # unsorted, so the tiles are build_shortlists' in ray order; a ray took
    # the fallback exactly when its final t is not below U
    u = packets.build_shortlists(o, d, mask, prep.pdata, P, 1).U
    assert int((hit.t >= u.repeat_interleave(P)[:SIZE * SIZE]).sum()) > 0
    assert torch.equal(hit.tri, brute.tri)
    assert torch.equal(hit.t.view(torch.int32), brute.t.view(torch.int32))


# ---- the fold kernels on a sample's batches ---------------------------------

def record_batches(scene, cfg, cam, bvh, prep, S=1):
    """The batches of one sample of ``cfg.integrator`` as the renderer's
    trace closure receives them, each (o, d, mask, t_cap or None): pt_nee's
    primary and first bounce batches; BDPT's primary batch (R rays), its
    joint subpath batch (2R) and its capped connection batch (4R). ``S``:
    the first S samples traced as one batch, as ``sample_batch`` S traces
    them."""
    dev = cam.pos.x.device
    idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    trace_fn = renderer.make_trace_fn(scene, cfg, bvh, prep=prep)
    calls = []

    def recording(o, d, mask, t_cap=None, vis_band=0.0):
        calls.append((o, d, mask, t_cap))
        return trace_fn(o, d, mask, t_cap=t_cap, vis_band=vis_band)

    base = prng_key(1234, dev)
    keys = torch.cat([pixel_keys(sample_key(base, i), idx)
                      for i in range(S)])
    o0, d0 = camera_rays(cam, idx.repeat(S), keys, lens=False)
    renderer._radiance(o0, d0, scene, recording, keys, cfg)
    names = (("primary", "subpath", "connection") if cfg.integrator == "bdpt"
             else ("primary", "bounce1"))
    return dict(zip(names, calls))


def sorted_shortlists(batch, pd, P, cfg, **kw):
    """One batch's rays (and caps) sorted as the packet engine sorts them,
    and its shortlists (``super_factor`` F: in super units; with
    ``super_slots`` too: the capped two-level cull's)."""
    o, d, mask, cap = batch
    perm = packets.sort_rays(o, d, mask, pd)
    return packets.build_shortlists(
        Vec3(*(c[perm] for c in o)), Vec3(*(c[perm] for c in d)), mask[perm],
        pd, P, cfg.max_clusters, super_list=cfg.super_list,
        t_cap=None if cap is None else cap[perm], **kw)


def agreement(got, want, rays):
    """Kernel against plain version: ids differ only on exact-t ties (under
    ID_MISMATCH_MAX of the live rays), t within T_RTOL where they agree."""
    (t_k, i_k), (t_p, i_p) = got, want
    live = rays[:, 6] > 0.5
    assert int(((i_k != i_p) & live).sum()) <= ID_MISMATCH_MAX * int(
        live.sum())
    same = (i_k == i_p) & live & (i_k >= 0)
    if bool(same.any()):
        rel = (t_k - t_p).abs()[same] / t_p.abs()[same]
        assert float(rel.max()) <= T_RTOL


def fold_checks(wrap, args, got, group, extra=(), intersector="bw",
                vis_band=0.0):
    """The counting instance returns the timed instance's hits and folds
    per tile what the plain count of the schedule (groups of ``group``
    rays) folds, where ``group`` is given. -> its counts."""
    counts = torch.empty((args[0].shape[0], k1.COUNT_COLS),
                         dtype=torch.int64, device=args[0].device)
    out = wrap(*args, *extra, counts_out=counts, intersector=intersector,
               vis_band=vis_band)
    assert torch.equal(out[0], got[0]) and torch.equal(out[1], got[1])
    if group is not None:
        assert torch.equal(counts[:, 0], k1.fold_schedule(
            *args, group, vis_band=vis_band)[2])
    return counts


# case: (scene, integrator, intersector, S)
BATCH_CASES = {
    "pt_nee": ("colonnade", "pt_nee", "bw", 1),
    "pt_nee_mt": ("colonnade", "pt_nee", "mt", 1),
    "bdpt": ("colonnade", "bdpt", "bw", 1),
    "bdpt_two_samples": ("colonnade", "bdpt", "bw", 2),
    # the reference's live configuration (kernel.cu:28-35)
    "live": ("cornell_sphere", "bdpt", "bw", 1),
}


@pytest.fixture(scope="module")
def sample_batches(dev):
    """{case: (scene, cfg, bvh, prep, P, batches)}, built on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            scene_name, integ, isect, S = BATCH_CASES[case]
            if scene_name == "colonnade":
                scene, cam = colonnade(dev), bench_camera(SIZE, dev)
            else:
                scene = procedural.to_scene(
                    procedural.cornell_with_sphere_mesh(), dev)
                cam = T.make_camera(width=SIZE, height=SIZE, device=dev)
            cfg = T.RenderConfig(width=SIZE, height=SIZE, spp=1,
                                 samples_per_call=1, integrator=integ,
                                 intersector=isect)
            bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
            prep = renderer.make_packet_prep(scene, bvh, isect)
            P = renderer.resolve_tile_size(cfg, scene.num_tris)
            cache[case] = (scene, cfg, bvh, prep, P,
                           record_batches(scene, cfg, cam, bvh, prep, S))
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_k1_equals_plain_and_k2_on_a_samples_batches(dev, sample_batches,
                                                     case):
    """On each batch of one sample, sorted and shortlisted as the packet
    engine does: K1 against its plain version on the whole batch, K2 on the
    same shortlists bit for bit, both counting instances against the plain
    count of their schedules (K1's blocks of at most 128 rays, K2's block
    per tile)."""
    scene, cfg, _, prep, P, batches = sample_batches(case)
    R, S = cfg.num_pixels, BATCH_CASES[case][3]
    if cfg.integrator == "bdpt":
        sizes = {n: b[0].x.shape[0] for n, b in batches.items()}
        assert sizes == {"primary": S * R, "subpath": 2 * S * R,
                         "connection": 4 * S * R}
        assert batches["connection"][3] is not None
    isect = cfg.intersector
    for batch in batches.values():
        sl = sorted_shortlists(batch, prep.pdata, P, cfg)
        args = (sl.ids, sl.counts, sl.entries, sl.rays, *prep.resident_pack)
        got = k1.dense_intersect_resident(*args, intersector=isect)
        agreement(got, k1.dense_intersect_resident_plain(*args), sl.rays)
        ref = k2.dense_intersect(*args, intersector=isect)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        counts = fold_checks(k1.dense_intersect_resident, args, got,
                             k1.k1_group(P), intersector=isect)
        fold_checks(k2.dense_intersect, args, got, P, intersector=isect)
        tests = needed_work(sl, got[0], prep.resident_pack,
                            scene.num_tris)[0]
        assert 0 < tests <= int(counts[:, 1].sum())


@pytest.mark.parametrize("case", ["pt_nee", "pt_nee_mt", "bdpt"])
def test_k3_on_super_shortlists_of_a_samples_batches(dev, sample_batches,
                                                     case):
    """K3 on super shortlists of SUPER_F clusters against its plain
    version, its counting instance returning its hits; with
    Moller-Trumbore on the bounce batch, K1's hits on the flat shortlists
    bit for bit."""
    scene, cfg, _, prep, P, batches = sample_batches(case)
    isect = cfg.intersector
    for name, batch in batches.items():
        sl = sorted_shortlists(batch, prep.pdata, P, cfg,
                               super_factor=SUPER_F)
        args = (sl.ids, sl.counts, sl.entries, sl.rays, *prep.resident_pack)
        got = k3.dense_intersect_super(*args, SUPER_F, intersector=isect)
        agreement(got, k3.dense_intersect_super_plain(*args, SUPER_F),
                  sl.rays)
        fold_checks(k3.dense_intersect_super, args, got, None, (SUPER_F,),
                    intersector=isect)
        if isect == "mt" and name == "bounce1":
            flat = sorted_shortlists(batch, prep.pdata, P, cfg)
            want = k1.dense_intersect_resident(
                flat.ids, flat.counts, flat.entries, flat.rays,
                *prep.resident_pack, intersector=isect)
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1])


def test_moller_trumbore_against_baldwin_weber(dev, sample_batches):
    """K1's two instances on the same rays: t within MT_BW_RTOL where both
    hit, hit/miss flips under MT_BW_FLIPS_MAX of the live rays."""
    _, cfg, _, prep, P, batches = sample_batches("pt_nee_mt")
    for batch in batches.values():
        sl = sorted_shortlists(batch, prep.pdata, P, cfg)
        head = (sl.ids, sl.counts, sl.entries, sl.rays)
        tm, im = k1.dense_intersect_resident(*head, *prep.resident_pack,
                                             intersector="mt")
        tb, ib = k1.dense_intersect_resident(
            *head, *k1.pack_clusters(prep.pdata, "bw"))
        live = sl.rays[:, 6] > 0.5
        both = live & (im >= 0) & (ib >= 0)
        assert float(((tm - tb).abs() / tb.abs())[both].max()) <= MT_BW_RTOL
        flips = int((live & ((im >= 0) != (ib >= 0))).sum())
        assert flips < MT_BW_FLIPS_MAX * int(live.sum())


def test_visibility_instances_on_the_connection_batch(dev, sample_batches):
    """BDPT's capped connection rays through the visibility instances of
    K1 and K2 (flat shortlists) and K3 (super shortlists): t the
    closest-hit instance's bit for bit, -3e38 exactly below the floor
    cap - vis_band, ids the closest hit's elsewhere; the plain visibility
    version's t and kept ids; K1's and K2's folds the plain count of their
    schedules with retirement. Then the packet engine's visibility query
    decides as its closest-hit query on the same rays."""
    scene, cfg, bvh, prep, P, batches = sample_batches("bdpt")
    band = 3.0 * EPS_VISIBILITY
    pd, pack = prep.pdata, prep.resident_pack
    batch = batches["connection"]
    flat = sorted_shortlists(batch, pd, P, cfg)
    sup = sorted_shortlists(batch, pd, P, cfg, super_factor=SUPER_F)
    retired = 0
    for wrap, plain, sl, extra, group in (
            (k1.dense_intersect_resident, k1.dense_intersect_resident_plain,
             flat, (), k1.k1_group(P)),
            (k2.dense_intersect, k2.dense_intersect_plain, flat, (), P),
            (k3.dense_intersect_super, k3.dense_intersect_super_plain, sup,
             (SUPER_F,), None)):
        args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
        closest = wrap(*args, *extra)
        vis = wrap(*args, *extra, vis_band=band)
        want = torch.where(closest[0] < sl.rays[:, 7] - band,
                           k1.MASKED_T_INIT, closest[0])
        keep = vis[0] != k1.MASKED_T_INIT
        assert torch.equal(vis[0].view(torch.int32), want.view(torch.int32))
        assert torch.equal(vis[1][keep], closest[1][keep])
        pv = plain(*args, *extra, vis_band=band)
        assert torch.equal(vis[0].view(torch.int32), pv[0].view(torch.int32))
        assert torch.equal(vis[1][keep], pv[1][keep])
        fold_checks(wrap, args, vis, group, extra, vis_band=band)
        retired += int((~keep & (sl.rays[:, 6] > 0.5)).sum())
    assert retired > 0
    o, d, mask, cap = batch
    kw = dict(fine_td=traversal.make_trace_data(scene, bvh.fine), mask=mask,
              tile_size=P, max_clusters=cfg.max_clusters, sort=True,
              resident_pack=pack, t_cap=cap)
    hc = packets.trace_packets(o, d, pd, **kw)
    hv = packets.trace_packets(o, d, pd, vis_band=band, **kw)
    ln = cap - 2.0 * EPS_VISIBILITY
    occluded = hv.t == -1.0
    assert torch.equal((hc.t - ln).abs() <= EPS_VISIBILITY,
                       (hv.t - ln).abs() <= EPS_VISIBILITY)
    assert torch.equal(hv.t[~occluded], hc.t[~occluded])


# ---- the fold kernels at the benchmark cells' sizes -------------------------

# case: (scene, integrator, image side); the benchmark cells
# colonnade.ptnee_1024 and cornell_sphere.bdpt_512 (h100_bench/configs/,
# traffic/), and BDPT over colonnade, where the cull shortlists more
CELLS = {
    "colonnade_pt_nee_1024": ("colonnade", "pt_nee", 1024),
    "colonnade_bdpt_512": ("colonnade", "bdpt", 512),
    "cornell_sphere_bdpt_512": ("cornell_sphere", "bdpt", 512),
}
# tiles spread over a batch on which the plain versions run
SAMPLE_TILES = 512


def spread_tiles(sl, n):
    """(the indices of about n tiles spread evenly over the batch, their
    shortlists)."""
    Tl = sl.ids.shape[0]
    idx = torch.unique(torch.linspace(0, Tl - 1, min(n, Tl),
                                      device=sl.ids.device).round().long())
    return idx, type(sl)(*(a[idx].contiguous() for a in sl))


def retired_as_miss(out):
    """(t, id) with the id of every ray the visibility query retired
    (t = MASKED_T_INIT) set to -2, so that ``agreement`` counts a ray
    retired by one fold and kept by the other as a differing id."""
    t, i = out
    return t, torch.where(t == k1.MASKED_T_INIT, -2, i)


@pytest.mark.parametrize("case", list(CELLS))
def test_kernels_at_a_cells_size(dev, case):
    """One sample at the cell's size (1,048,576 rays a batch at 1024^2,
    262,144 to 1,048,576 at 512^2), each batch sorted and shortlisted as
    the packet engine does. K1 over the whole batch, K2 on the same
    shortlists bit for bit, K1's counting instance returning its hits; K3
    over super shortlists of SUPER_F clusters. Each kernel's hits on
    SAMPLE_TILES tiles spread over the batch against its plain version on
    those tiles, and K1's folds there against the plain count of its
    schedule; on BDPT's capped connection batch, the visibility instances
    of K1 and K3 as well. Then one pass at that size launches K1 and the
    glue's kernels alone and renders a finite, lit image."""
    scene_name, integ, size = CELLS[case]
    if scene_name == "colonnade":
        scene, cam = colonnade(dev), bench_camera(size, dev)
    else:
        scene = procedural.to_scene(procedural.cornell_with_sphere_mesh(),
                                    dev)
        cam = T.make_camera(width=size, height=size, device=dev)
    cfg = T.RenderConfig(width=size, height=size, spp=1, samples_per_call=1,
                         integrator=integ)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
    K, C = bvh.cl_tri.shape
    assert tuple(packets.route(K, C)) == ("flat", "resident")
    prep = renderer.make_packet_prep(scene, bvh)
    P = renderer.resolve_tile_size(cfg, scene.num_tris)
    pack = prep.resident_pack
    batches = record_batches(scene, cfg, cam, bvh, prep)
    R = size * size
    assert {n: b[0].x.shape[0] for n, b in batches.items()} == (
        {"primary": R, "subpath": 2 * R, "connection": 4 * R}
        if integ == "bdpt" else {"primary": R, "bounce1": R})
    folds = ((None, k1.dense_intersect_resident,
              k1.dense_intersect_resident_plain),
             (SUPER_F, k3.dense_intersect_super,
              k3.dense_intersect_super_plain))
    for batch in batches.values():
        bands = (0.0,) if batch[3] is None else (0.0, 3.0 * EPS_VISIBILITY)
        for F, wrap, plain in folds:
            extra = (F,) if F else ()
            sl = sorted_shortlists(batch, prep.pdata, P, cfg, super_factor=F)
            idx, part = spread_tiles(sl, SAMPLE_TILES)
            args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
            pargs = (part.ids, part.counts, part.entries, part.rays, *pack)
            for band in bands:
                got = wrap(*args, *extra, vis_band=band)
                agreement(retired_as_miss((got[0][idx], got[1][idx])),
                          retired_as_miss(plain(*pargs, *extra,
                                                vis_band=band)),
                          part.rays)
                if F:
                    continue
                if not band:
                    ref = k2.dense_intersect(*args)
                    assert torch.equal(got[0], ref[0]) and \
                        torch.equal(got[1], ref[1])
                counts = fold_checks(wrap, args, got, None, vis_band=band)
                assert torch.equal(counts[idx, 0], k1.fold_schedule(
                    *pargs, k1.k1_group(P), vis_band=band)[2])
    before = kernel_counts()
    st = render(scene, cam, cfg, bvh, prep)
    launched(before, "k1")
    assert lit(st)


# ---- the routes -------------------------------------------------------------

# path: (integrator, RenderConfig knobs, route (cull, kernel), its kernel)
ROUTES = {
    "resident": ("pt_nee", {}, ("flat", "resident"), "k1"),
    "resident_mt": ("pt_nee", dict(intersector="mt"), ("flat", "resident"),
                    "k1"),
    "bdpt": ("bdpt", {}, ("flat", "resident"), "k1"),
    "stream": ("pt_nee", dict(cluster_size=STREAM_C, two_level_cull=False),
               ("flat", "stream"), "k2"),
    "super": ("pt_nee", dict(two_level_cull="super"), ("super", "super"),
              "k3"),
    "two_level": ("pt_nee", dict(cluster_size=STREAM_C, two_level_cull=True),
                  ("two_level", "stream"), "k2"),
}


@pytest.mark.parametrize("path", list(ROUTES))
def test_each_path_launches_only_its_kernel(dev, path):
    integ, kw, want, kernel = ROUTES[path]
    scene = colonnade(dev)
    cfg = T.RenderConfig(width=32, height=32, spp=2, samples_per_call=2,
                         integrator=integ, **kw)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size,
                                       cluster_size=cfg.cluster_size)
    K, C = bvh.cl_tri.shape
    assert tuple(packets.route(K, C, cfg.two_level_cull,
                               cfg.super_factor)) == want
    before = kernel_counts()
    st = render(scene, bench_camera(32, dev), cfg, bvh)
    launched(before, kernel)
    assert lit(st)


@pytest.mark.parametrize("cluster_size,kernel", [(STREAM_C, "k2"),
                                                 (256, "k1")],
                         ids=["stream", "resident"])
def test_two_level_cull_equals_the_flat_cull(dev, cluster_size, kernel):
    """The capped two-level cull, forced: with K2 at a cluster width K1
    does not take, with K1 at one it does. On a sample's batches the
    route's kernel on the two-level shortlists against its plain version
    (K1 against K2 bit for bit too), its counting instance against the
    plain count of its schedule; the trace's hits the flat cull's bit for
    bit on the same rays; and the rendered image too, each cull launching
    the route's kernel alone."""
    scene = colonnade(dev)
    cfg = T.RenderConfig(width=SIZE, height=SIZE, spp=1, samples_per_call=1,
                         integrator="pt_nee", cluster_size=cluster_size,
                         two_level_cull=True)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size,
                                       cluster_size=cluster_size)
    K, C = bvh.cl_tri.shape
    route = packets.route(K, C, True, cfg.super_factor)
    assert route == ("two_level", {"k1": "resident", "k2": "stream"}[kernel])
    prep = renderer.make_packet_prep(scene, bvh)
    P = renderer.resolve_tile_size(cfg, scene.num_tris)
    td = traversal.make_trace_data(scene, bvh.fine)
    cam = bench_camera(SIZE, dev)
    wrap = {"k1": k1.dense_intersect_resident, "k2": k2.dense_intersect}
    for batch in record_batches(scene, cfg, cam, bvh, prep).values():
        sl = sorted_shortlists(batch, prep.pdata, P, cfg,
                               super_factor=cfg.super_factor,
                               super_slots=cfg.super_slots)
        args = (sl.ids, sl.counts, sl.entries, sl.rays, *prep.resident_pack)
        got = wrap[kernel](*args)
        agreement(got, k2.dense_intersect_plain(*args), sl.rays)
        fold_checks(wrap[kernel], args, got,
                    k1.k1_group(P) if kernel == "k1" else P)
        if kernel == "k1":
            ref = k2.dense_intersect(*args)
            assert torch.equal(got[0], ref[0]) and \
                torch.equal(got[1], ref[1])
        o, d, mask, cap = batch
        kw = dict(fine_td=td, mask=mask, tile_size=P,
                  max_clusters=cfg.max_clusters, sort=True,
                  resident_pack=prep.resident_pack, t_cap=cap)
        a = packets.trace_packets(o, d, prep.pdata, two_level=True, **kw)
        b = packets.trace_packets(o, d, prep.pdata, two_level=False, **kw)
        assert torch.equal(a.tri, b.tri)
        assert torch.equal(a.t.view(torch.int32), b.t.view(torch.int32))
    imgs = {}
    for cull in (True, False):
        before = kernel_counts()
        imgs[cull] = render(scene, cam, dataclasses.replace(
            cfg, two_level_cull=cull), bvh, prep)
        launched(before, kernel)
    assert_same_bits(imgs[True], imgs[False])


# ---- the batching knobs -----------------------------------------------------

KNOBS = {
    "bdpt_vis_dropout": ("bdpt", dict(vis_dropout=True)),
    "bdpt_sample_batch2": ("bdpt", dict(sample_batch=2)),
    "pt_nee_sample_batch2": ("pt_nee", dict(sample_batch=2)),
    "pt_nee_rounds2": ("pt_nee", dict(packet_rounds=2, packet_first_round=2)),
    "pt_nee_sort_window": ("pt_nee", dict(sort_window=1024)),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_knob_renders_the_default_bits(dev, knob):
    integ, kw = KNOBS[knob]
    scene, cam = colonnade(dev), bench_camera(SIZE, dev)
    cfg = T.RenderConfig(width=SIZE, height=SIZE, spp=2, samples_per_call=2,
                         integrator=integ)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
    prep = renderer.make_packet_prep(scene, bvh)
    want = render(scene, cam, cfg, bvh, prep)
    before = kernel_counts()
    got = render(scene, cam, dataclasses.replace(cfg, **kw), bvh, prep)
    launched(before, "k1")
    assert_same_bits(got, want)
    assert lit(got)


# ---- the differentiable pass ------------------------------------------------

class TraceLog:
    """Every trace call of the differentiable pass while entered, as
    ``render_image_diff`` makes its closure: each call's hit ids and whether
    it ran in the backward (the per-sample recompute) or the forward."""

    def __init__(self):
        self.calls = []
        self.backward = False

    def __enter__(self):
        self._orig = rg.make_trace_fn

        def make(*a, **kw):
            base = self._orig(*a, **kw)

            def fn(o, d, mask, t_cap=None, vis_band=0.0):
                h = base(o, d, mask, t_cap=t_cap, vis_band=vis_band)
                self.calls.append((self.backward, h.tri.clone(),
                                   stop_gradient((o, d, mask, t_cap))))
                return h

            return fn

        rg.make_trace_fn = make
        return self

    def __exit__(self, *exc):
        rg.make_trace_fn = self._orig

    def split(self):
        """-> (forward calls, recompute calls), each [(ids, batch)]."""
        return ([c[1:] for c in self.calls if not c[0]],
                [c[1:] for c in self.calls if c[0]])


@pytest.fixture(scope="module")
def train_setups(dev):
    """size -> (scene, cam, cfg, bvh, target), built on first use: the
    bench's train step (bench.py:189-225) at size^2: colonnade subdiv 3,
    pt_nee, 1 spp, the primary hit traced, the L2 loss against a key-9
    target."""
    cache = {}

    def get(size):
        if size not in cache:
            scene, cam = colonnade(dev), bench_camera(size, dev)
            cfg = T.RenderConfig(width=size, height=size, spp=1,
                                 samples_per_call=1, integrator="pt_nee",
                                 reuse_primary_hit=False)
            bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
            with torch.no_grad():
                target = rg.render_image_diff(scene, cam, cfg,
                                              prng_key(9, dev), 1, bvh=bvh)
            cache[size] = scene, cam, cfg, bvh, target
        return cache[size]

    return get


@pytest.fixture(scope="module")
def train_setup(train_setups):
    return train_setups(SIZE)


def sgd_step(scene, target, loss_fn, log=None):
    """One SGD step (lr 1e-4, __graft_entry__.py:95) -> (loss, gradients)."""
    p = rg.targets_of(scene)
    opt = torch.optim.SGD(rg.target_leaves(p), lr=1e-4)
    loss = loss_fn(p, target)
    if log is not None:
        log.backward = True
    loss.backward()
    opt.step()
    return loss.detach(), [torch.zeros_like(t) if t.grad is None
                           else t.grad.clone() for t in rg.target_leaves(p)]


def grads_close(got, want, frac):
    for a, b in zip(got, want):
        if b.numel():
            assert float((a.to(b.device) - b).abs().max()) <= frac * float(
                b.abs().max())


@pytest.mark.parametrize("size,edge_samples", [
    (SIZE, 0), (SIZE, 1024), (TRAIN_SIZE, 0),
    (TRAIN_SIZE, TRAIN_EDGE_SAMPLES)],
    ids=["interior", "both_terms", "interior_256", "both_terms_256"])
def test_train_step_on_the_card(dev, train_setups, size, edge_samples):
    """At 1 spp nothing is recomputed: the sample keeps its graph, and K1
    is launched once for each trace call of the forward and nothing else;
    the loss and every gradient finite; a repeat's gradients within
    REPEAT_FRAC of each array's largest |g|."""
    scene, cam, cfg, bvh, target = train_setups(size)
    loss_fn = rg.make_loss_fn(scene, cam, cfg, prng_key(1234, dev), 1,
                              bvh=bvh, edge_samples=edge_samples,
                              shadow_edge_samples=edge_samples)
    sgd_step(scene, target, loss_fn)               # warm-up
    before = kernel_counts()
    with TraceLog() as log:
        loss, grads = sgd_step(scene, target, loss_fn, log)
    diff = launched(before, "k1")
    fwd, rec = log.split()
    # the last (here the only) sample keeps its graph, and the boundary
    # terms run outside any checkpoint: every ray is traced once
    assert fwd and not rec and diff["k1_launches"] == len(fwd)
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    grads_close(sgd_step(scene, target, loss_fn)[1], grads, REPEAT_FRAC)


def test_train_step_recomputes_all_but_the_last_sample(dev, train_setup):
    """At 2 spp sample 0 alone runs again in the backward: K1 launched once
    for each trace call of the forward and of that recompute, the
    recompute's calls sample 0's, their hit ids the forward's bit for
    bit."""
    scene, cam, cfg, bvh, target = train_setup
    loss_fn = rg.make_loss_fn(scene, cam, cfg, prng_key(1234, dev), 2,
                              bvh=bvh)
    sgd_step(scene, target, loss_fn)               # warm-up
    before = kernel_counts()
    with TraceLog() as log:
        sgd_step(scene, target, loss_fn, log)
    diff = launched(before, "k1")
    fwd, rec = log.split()
    assert 0 < len(rec) < len(fwd)
    assert diff["k1_launches"] == len(fwd) + len(rec)
    # sample 0 traced first in the forward
    assert all(torch.equal(a[0], b[0]) for a, b in zip(rec, fwd))


@pytest.mark.parametrize("edge_samples", [0, TRAIN_EDGE_SAMPLES],
                         ids=["interior", "both_terms"])
def test_kept_graph_peak_memory(dev, train_setups, monkeypatch,
                                edge_samples):
    """256^2 at MEMORY_SPP spp: a step's peak device memory above what it
    starts with, the last sample's graph kept, against every sample
    checkpointed. Without boundary terms within 2%; with both, at most one
    sample's graph higher (the bytes the kept graph holds after the
    forward)."""
    scene, cam, cfg, bvh, target = train_setups(TRAIN_SIZE)
    loss_fn = rg.make_loss_fn(scene, cam, cfg, prng_key(1234, dev),
                              MEMORY_SPP, bvh=bvh,
                              edge_samples=edge_samples,
                              shadow_edge_samples=edge_samples)

    def held():
        """Bytes the forward leaves allocated for the backward."""
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        loss = loss_fn(rg.targets_of(scene), target)  # noqa: F841
        torch.cuda.synchronize(dev)
        return torch.cuda.memory_allocated(dev) - base

    def peak():
        sgd_step(scene, target, loss_fn)           # warm-up
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        sgd_step(scene, target, loss_fn)
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev) - base

    kept = peak(), held()
    monkeypatch.setattr(rg, "_checkpointed", lambda s, spp: True)
    checked = peak(), held()
    graph = kept[1] - checked[1]
    assert graph > 0, (kept, checked)
    if edge_samples:
        assert kept[0] <= checked[0] + graph, (kept, checked)
    else:
        assert abs(kept[0] - checked[0]) <= 0.02 * checked[0], (kept,
                                                                checked)


def test_finite_difference_on_the_card(dev, train_setup):
    """d loss / d albedo.x of the material most seen by primary rays
    against a central difference (tests/test_diff.py:57's rule)."""
    scene, cam, cfg, bvh, target = train_setup
    loss_fn = rg.make_loss_fn(scene, cam, cfg, prng_key(1234, dev), 1,
                              bvh=bvh)
    with TraceLog() as log:
        _, grads = sgd_step(scene, target, loss_fn)
    first = log.split()[0][0][0]
    m = int(torch.bincount(scene.tri_mat[first[first >= 0].long()]).argmax())
    g = float(grads[3][m])                         # albedo.x
    p0, eps = rg.targets_of(scene), 1e-3

    def f(delta):
        ax = p0.albedo.x.detach().clone()
        ax[m] += delta
        with torch.no_grad():
            return float(loss_fn(p0._replace(
                albedo=p0.albedo._replace(x=ax)), target))

    fd = (f(eps) - f(-eps)) / (2 * eps)
    assert abs(fd - g) <= 2e-2 * max(abs(fd), abs(g), 1e-5) + 1e-5


def test_render_and_grad_card_against_cpu(dev):
    """16^2 pt_nee, both boundary terms: the loss within 1e-5 and the
    material gradients within 1e-4 of the CPU's, relative, the vertex
    gradients within 1e-3 of each array's largest |g|."""
    def small(device):
        sc = procedural.to_scene(procedural.cornell_box(with_boxes=False),
                                 device)
        c = T.RenderConfig(width=16, height=16, spp=2, samples_per_call=2,
                           integrator="pt_nee")
        cm = T.make_camera(width=16, height=16, device=device)
        bv = renderer.build_bvh_for_scene(sc, c.leaf_size)
        with torch.no_grad():
            tg = rg.render_image_diff(sc, cm, c, prng_key(99, device), 1,
                                      bvh=bv)
        return rg.render_and_grad(sc, cm, c, prng_key(0, device), 2, tg,
                                  bvh=bv, edge_samples=256,
                                  shadow_edge_samples=256)

    before = kernel_counts()
    loss_d, g_d = small(dev)
    launched(before, "k1")
    loss_c, g_c = small("cpu")
    assert abs(float(loss_d) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for a, b in zip([*g_d.albedo, *g_d.emission],
                    [*g_c.albedo, *g_c.emission]):
        assert float(((a.cpu() - b).abs() / b.abs().clamp(min=1e-30)).max()
                     ) <= 1e-4
    grads_close([*g_d.verts, *g_d.sph_center, g_d.sph_radius],
                [*g_c.verts, *g_c.sph_center, g_c.sph_radius], 1e-3)


def test_bdpt_render_and_grad_on_the_card(dev, train_setup):
    scene, cam, cfg, bvh, _ = train_setup
    bcfg = dataclasses.replace(cfg, integrator="bdpt")
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, bcfg, prng_key(9, dev), 1,
                                      bvh=bvh)
    before = kernel_counts()
    loss, g = rg.render_and_grad(scene, cam, bcfg, prng_key(1234, dev), 1,
                                 target, bvh=bvh)
    launched(before, "k1")
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(t).all()) for t in rg.target_leaves(g))


# ---- the entry points and the quirk flags -----------------------------------

def test_entry_on_the_card_against_cpu(dev):
    """``entry()``'s forward step on the card (the resident route, K1
    alone) against ``entry("cpu")``'s image under the golden rule."""
    fn, args = E.entry(device=dev)
    scene, bvh = args[0], args[1]
    K, C = bvh.cl_tri.shape
    assert packets.route(K, C).kernel == "resident"
    before = kernel_counts()
    st = fn(*args)
    launched(before, "k1")
    assert st.n == 1 and lit(st)
    cfn, cargs = E.entry(device="cpu")
    image_rule(T.finalize_image(st, E.ENTRY_CFG),
               T.finalize_image(cfn(*cargs), E.ENTRY_CFG))


# every quirk flag with each integrator that reads it, the defaults first
QUIRK_CASES = {
    "pt_nee": ("pt_nee", {}),
    "pt_nee_orthonormal_frame": ("pt_nee", dict(orthonormal_frame=True)),
    "pt_nee_light_normal_true": ("pt_nee", dict(light_normal_mode="true")),
    "pt_nee_branch_pdf_correction": ("pt_nee",
                                     dict(branch_pdf_correction=True)),
    "pt_nee_no_compensated_accum": ("pt_nee", dict(compensated_accum=False)),
    "pt_nee_jitter": ("pt_nee", dict(jitter=True)),
    "bdpt": ("bdpt", {}),
    "bdpt_orthonormal_frame": ("bdpt", dict(orthonormal_frame=True)),
    "bdpt_no_compensated_accum": ("bdpt", dict(compensated_accum=False)),
}


@pytest.fixture(scope="module")
def quirk_renders():
    """{(case, device type): (accumulators (3, R), u8 image)}, rendered on
    first use: cornell_with_sphere_mesh(subdiv=2) at 32^2, 4 spp, seed 9;
    on the card through K1 alone."""
    cache = {}

    def get(case, device):
        key = (case, torch.device(device).type)
        if key not in cache:
            integ, flags = QUIRK_CASES[case]
            before = kernel_counts()
            scene = procedural.to_scene(
                procedural.cornell_with_sphere_mesh(subdiv=2), device)
            cfg = T.RenderConfig(width=32, height=32, spp=4,
                                 samples_per_call=4, integrator=integ,
                                 **flags)
            st = T.render(scene, T.make_camera(width=32, height=32,
                                               device=device), cfg, seed=9,
                          device=device)
            if key[1] == "cuda":
                launched(before, "k1")
            cache[key] = (np.stack([c.cpu().numpy() for c in st.img]),
                          T.finalize_image(st, cfg))
        return cache[key]

    return get


@pytest.mark.parametrize("case", list(QUIRK_CASES))
def test_quirk_on_the_card_against_cpu(dev, quirk_renders, case):
    """The card's render under the golden rule of the CPU's, finite and
    lit; a flag changes the CPU's image, and the card's in the same
    pixels."""
    integ, flags = QUIRK_CASES[case]
    acc, img = quirk_renders(case, dev)
    cacc, cimg = quirk_renders(case, "cpu")
    assert np.isfinite(acc).all() and acc.max() > 0
    image_rule(img, cimg)
    if flags:
        changed = (acc != quirk_renders(integ, dev)[0]).any(0)
        cchanged = (cacc != quirk_renders(integ, "cpu")[0]).any(0)
        assert cchanged.any() and np.array_equal(changed, cchanged)
