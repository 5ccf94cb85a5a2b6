"""The port's capped two-level cull (cudapathtracer_tpu_torch/ops/packets.py,
``two_level=True``) against the JAX package's (packets.py:597-676, its XLA
engine) and against the port's brute force, on the cases of
tests/test_packets.py:test_two_level_cull_exact: camera and incoherent rays
of ``cornell_with_sphere_mesh(subdiv=2)`` at C = 16 (K2's route), with
``super_slots`` 2, 3 and 4 and F 4 and 8, with and without straggler
rounds, the ray sort, its windows and a mask, and with the caller's cap.
Then the two-level shortlist on the resident route (K1) with a
visibility-only query, against the JAX package's Pallas kernel in
interpret mode; and the auto cull past K = 2048 clusters without a
resident layout: colonnade subdiv 3 at ``cluster_size=8`` (K = 3,431)
rendered in both packages.

Hits (ids and t) equal the port's brute force and the JAX package's bit for
bit: each (ray, triangle) test rounds alike in every engine here, and U
with the fallback makes the hit exact for any shortlist. ``topk`` keeps
either of two equal entries in both packages, so the shortlists may differ
where entries tie; the hits may not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fold_cases import assert_pixels_close, jax_scene

import cudapathtracer_tpu as J
from cudapathtracer_tpu import make_camera
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.ops import packets as jpk
from cudapathtracer_tpu.ops import traversal as jtrav
from cudapathtracer_tpu.ops.rng import pixel_keys, sample_key
from cudapathtracer_tpu.ops.vecmath import Vec3 as JVec3
from cudapathtracer_tpu.render.camera import camera_rays
from cudapathtracer_tpu.render.renderer import build_bvh_for_scene

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import convert
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import packets as tpk
from cudapathtracer_tpu_torch.ops import traversal as ttrav
from cudapathtracer_tpu_torch.ops.kernels import dense as tk2
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as tk1
from cudapathtracer_tpu_torch.ops.vecmath import Vec3 as TVec3
from cudapathtracer_tpu_torch.render import renderer as tren
from cudapathtracer_tpu_torch.utils.constants import EPS_VISIBILITY


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process (the suite runs several workers on
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name -> (rays, R, tile_size, max_clusters, super_slots, F, masked, capped,
#          trace_packets knobs); every case but "ms4_f8_nonmultiple" (its two
#          tiles keep every candidate) drops some
CASES = {
    "ms2_f4_sorted": ("camera", None, 64, 8, 2, 4, False, False,
                      dict(sort=True)),
    "ms4_f4_rounds2": ("camera", None, 64, 8, 4, 4, False, False,
                       dict(sort=True, rounds=2, first_round_slots=2)),
    "ms3_f8_incoherent": ("random", None, 128, 16, 3, 8, False, False, {}),
    "ms2_f8_masked_rounds": ("camera", None, 64, 8, 2, 8, True, False,
                             dict(sort=True, rounds=2, first_round_slots=1)),
    "ms3_f4_window_rounds": ("camera", None, 64, 8, 3, 4, True, False,
                             dict(sort=True, sort_window=256, rounds=2,
                                  first_round_slots=2)),
    "ms4_f8_nonmultiple": ("camera", 100, 64, 8, 4, 8, False, False,
                           dict(sort=True)),
    "ms3_f4_t_cap": ("camera", None, 64, 8, 3, 4, False, True, {}),
    "ms2_f4_t_cap_rounds_window": ("camera", None, 64, 8, 2, 4, False, True,
                                   dict(sort=True, sort_window=128,
                                        rounds=3, first_round_slots=1)),
}


def _sub(v, n):
    return JVec3(*(c[:n] for c in v))


def _caps(t):
    """Caps straddling the hits (tests/test_packets.py:294-300): half at a
    fixed 1.5, a quarter exactly at the hit, a quarter just above it."""
    q = np.arange(t.shape[0]) % 4
    return np.where(q % 2 == 0, np.float32(1.5), np.where(
        q == 1, t, np.nextafter(t, np.float32(np.inf)))).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    js = jproc.to_scene(jproc.cornell_with_sphere_mesh(subdiv=2))
    accel = build_bvh_for_scene(js, leaf_size=4, cluster_size=16)
    jtd = jtrav.make_trace_data(js, accel.fine)
    jpd = jpk.make_packet_data(
        js, JVec3(accel.cl_lo_x, accel.cl_lo_y, accel.cl_lo_z),
        JVec3(accel.cl_hi_x, accel.cl_hi_y, accel.cl_hi_z), accel.cl_tri)
    idx = jnp.arange(32 * 32, dtype=jnp.uint32)
    keys = pixel_keys(sample_key(jax.random.PRNGKey(0), 0), idx)
    cam = camera_rays(make_camera(width=32, height=32), idx, keys,
                      jitter=False)
    ko, kd = jax.random.split(jax.random.PRNGKey(11))
    rnd = (JVec3.from_array(jax.random.uniform(ko, (512, 3))),
           JVec3.from_array(jax.random.normal(kd, (512, 3)) + 1e-3))
    rays = {"camera": cam, "random": rnd}
    ref, inputs = {}, {}
    for name, (kind, n, P, mc, ms, F, masked, capped, kw) in CASES.items():
        o, d = rays[kind]
        if n is not None:
            o, d = _sub(o, n), _sub(d, n)
        R = o.x.shape[0]
        mask = (np.arange(R) % 3) != 0 if masked else np.ones(R, bool)
        cap = None
        if capped:
            cap = _caps(np.asarray(jtrav.trace_bruteforce(o, d, js).t))
        ref[name] = jpk.trace_packets(
            o, d, jpd, fine_td=jtd, mask=jnp.asarray(mask), tile_size=P,
            max_clusters=mc, engine="xla", two_level=True, super_factor=F,
            super_slots=ms, t_cap=None if cap is None else jnp.asarray(cap),
            **kw)
        inputs[name] = (o, d, mask, cap)

    ts = tproc.to_scene(tproc.cornell_with_sphere_mesh(subdiv=2), "cpu")
    ta = convert.accel_from_jax(convert.to_numpy_dict(accel), "cpu")
    tpd = tpk.make_packet_data(
        ts, TVec3(ta.cl_lo_x, ta.cl_lo_y, ta.cl_lo_z),
        TVec3(ta.cl_hi_x, ta.cl_hi_y, ta.cl_hi_z), ta.cl_tri)
    # the fallback mask of the unsorted primary rays (same tiles in both
    # packages), from the JAX package's need-out trace
    o, d, _, _ = inputs["ms2_f4_sorted"]
    need = {F: np.asarray(jpk.trace_packets(
        o, d, jpd, tile_size=64, max_clusters=8, engine="xla",
        two_level=True, super_factor=F, super_slots=2, _need_out=True)[1])
        for F in (4, 8)}
    return dict(ref=ref, inputs=inputs, ts=ts, tpd=tpd, need=need,
                ttd=ttrav.make_trace_data(ts, ta.fine))


def _tv(v):
    return TVec3(*(torch.from_numpy(np.array(c)) for c in v))


@pytest.mark.parametrize("name", list(CASES))
def test_two_level_matches_jax_and_brute(setup, name):
    """The capped two-level cull's hits equal the JAX package's
    trace_packets(two_level=True) and the port's brute force bit for bit;
    the cull drops candidates (U finite on some tile), so the fallback
    runs, and K2's plain version folds the cluster-unit shortlists."""
    _, _, P, mc, ms, F, _, _, kw = CASES[name]
    o, d, mask, cap = setup["inputs"][name]
    o, d, mask = _tv(o), _tv(d), torch.from_numpy(mask)
    tcap = None if cap is None else torch.from_numpy(cap)
    tpd = setup["tpd"]
    assert tpk.route(tpd.num_clusters, tpd.cluster_size, True, F) == \
        ("two_level", "stream")
    calls = tk2.dense_intersect_plain.calls
    hit = tpk.trace_packets(o, d, tpd, fine_td=setup["ttd"], mask=mask,
                            tile_size=P, max_clusters=mc, two_level=True,
                            super_factor=F, super_slots=ms, t_cap=tcap, **kw)
    assert tk2.dense_intersect_plain.calls > calls
    ref = setup["ref"][name]
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(hit.t.numpy(), np.asarray(ref.t))
    brute = ttrav.trace_bruteforce(o, d, setup["ts"], mask=mask)
    if tcap is not None:
        brute = ttrav.apply_t_cap(brute, tcap)
    np.testing.assert_array_equal(hit.tri.numpy(), brute.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), brute.t.numpy())
    assert int((hit.tri >= 0).sum()) > 0
    sl = tpk.build_shortlists(o, d, mask, tpd, P, mc, super_factor=F,
                              super_slots=ms)
    assert bool(torch.isfinite(sl.U).any()) == (name != "ms4_f8_nonmultiple")
    live = sl.ids < tpd.num_clusters
    assert int(live.sum()) == int(sl.counts.sum())
    assert bool((sl.entries[:, 1:] >= sl.entries[:, :-1]).all())


@pytest.mark.parametrize("F", [4, 8])
def test_two_level_fallback_mask_matches_jax(setup, F):
    """On the primary batch, unsorted, so that both packages tile it
    alike, the rays the capped two-level cull hands to the fallback (a
    dropped candidate could still beat their hit: ``_finish``'s
    ``need_out``) are the JAX package's, ray for ray."""
    o, d, mask, _ = setup["inputs"]["ms2_f4_sorted"]
    o, d, mask = _tv(o), _tv(d), torch.from_numpy(mask)
    tpd = setup["tpd"]
    sl = tpk.build_shortlists(o, d, mask, tpd, 64, 8, super_factor=F,
                              super_slots=2)
    t, tri = tk2.dense_intersect(sl.ids, sl.counts, sl.entries, sl.rays,
                                 *tk1.pack_clusters(tpd))
    _, need = tpk._finish(o, d, t, tri, mask, sl.U, None, o.x.shape[0],
                          need_out=True)
    want = setup["need"][F]
    np.testing.assert_array_equal(need.numpy(), want)
    assert 0 < int(want.sum()) < want.size


def test_two_level_shortlist_levels(setup):
    """The shortlist's two levels: every id is a member of one of the Ms
    nearest superclusters or the sentinel K, at most min(max_clusters,
    Ms F) slots, ascending entries, and U at most the first level's
    dropped entry; a wide first level (Ms = S) with no cap on the second
    (M = K) drops nothing, so U is +inf and the shortlist holds every
    culled cluster, as the flat cull's does."""
    o, d, mask, _ = setup["inputs"]["ms2_f4_sorted"]
    o, d, mask = _tv(o), _tv(d), torch.from_numpy(mask)
    tpd = setup["tpd"]
    K, F = tpd.num_clusters, 4
    S = -(-K // F)
    sl = tpk.build_shortlists(o, d, mask, tpd, 64, 8, super_factor=F,
                              super_slots=2)
    assert sl.ids.shape[1] == min(8, 2 * F)
    assert bool(((sl.ids >= 0) & (sl.ids <= K)).all())
    sup = tpk.build_shortlists(o, d, mask, tpd, 64, 2 * F, super_factor=F,
                               super_list=2)
    for r in range(sl.ids.shape[0]):
        kept = set(sup.ids[r, :sup.counts[r]].tolist())
        assert {i // F for i in sl.ids[r, :sl.counts[r]].tolist()} <= kept
    assert bool((sl.U <= sup.U).all())
    wide = tpk.build_shortlists(o, d, mask, tpd, 64, K, super_factor=F,
                                super_slots=S)
    flat = tpk.build_shortlists(o, d, mask, tpd, 64, K)
    assert bool(torch.isinf(wide.U).all())
    np.testing.assert_array_equal(wide.counts.numpy(), flat.counts.numpy())
    for r in range(flat.ids.shape[0]):
        n = int(flat.counts[r])
        assert sorted(wide.ids[r, :n].tolist()) == \
            sorted(flat.ids[r, :n].tolist())
    np.testing.assert_array_equal(wide.entries.numpy(),
                                  flat.entries.numpy())


@pytest.fixture(scope="module")
def resident():
    """``cornell_with_sphere_mesh(subdiv=3)`` at C = 128 (K = 16, resident):
    shadow-style rays toward a light, their caps len + 2 eps, and the JAX
    package's two-level visibility query on its Pallas kernel in interpret
    mode and its two-level closest-hit query on the XLA engine."""
    sc = jax_scene(subdiv=3)
    n = 256
    rng = np.random.default_rng(5)
    ts = sc["ts"]
    lt = ts.lights[0].long()
    tgt = [float(sum(getattr(ts.verts, c)[getattr(ts, f"tri_v{k}")[lt].long()]
                     for k in range(3)) / 3.0) for c in "xyz"]
    pos = [rng.uniform(-0.9, 0.9, n).astype(np.float32),
           rng.uniform(0.05, 1.5, n).astype(np.float32),
           rng.uniform(-0.9, 0.9, n).astype(np.float32)]
    seg = [np.float32(g) - p for g, p in zip(tgt, pos)]
    ln = np.sqrt(sum(s * s for s in seg)).astype(np.float32)
    dirn = [(s / ln).astype(np.float32) for s in seg]
    vcap = (ln + np.float32(2.0 * EPS_VISIBILITY)).astype(np.float32)
    band = 3.0 * EPS_VISIBILITY
    jo, jd = JVec3(*map(jnp.asarray, pos)), JVec3(*map(jnp.asarray, dirn))
    kw = dict(fine_td=sc["jtd"], tile_size=64, max_clusters=4,
              two_level=True, super_factor=4, super_slots=2,
              t_cap=jnp.asarray(vcap))
    jvis = sc["jpk"].trace_packets(jo, jd, sc["jpd"], sort=True,
                                   engine="pallas_interpret", vis_band=band,
                                   **kw)
    jclosest = sc["jpk"].trace_packets(jo, jd, sc["jpd"], engine="xla", **kw)
    return dict(sc=sc, pos=pos, dirn=dirn, ln=ln, vcap=vcap, band=band,
                jvis=jvis, jclosest=jclosest)


@pytest.mark.parametrize("vis", [False, True])
def test_two_level_resident_route(resident, vis):
    """two_level=True on a resident scene takes the two-level cull with K1
    (the shortlist is in cluster units), with the caller's cap: the
    closest-hit query equals the JAX package's and capped brute force bit
    for bit. The visibility query (vis_band = 3 eps, sorted) reports t =
    -1.0 only where the closest hit lies below the floor len - eps, and
    the closest hit everywhere else, so its decisions |t - len| <= eps are
    the closest hit's; on the rays that neither package's visibility query
    retired, its t equals the JAX package's Pallas kernel's in interpret
    mode. Which rays retire depends on the tiles and shortlists, and the
    two packages order equal sort keys and equal entries differently."""
    sc = resident["sc"]
    tpd = sc["tpd"]
    assert tpk.route(tpd.num_clusters, tpd.cluster_size, True, 4) == \
        ("two_level", "resident")
    o = TVec3(*map(torch.from_numpy, resident["pos"]))
    d = TVec3(*map(torch.from_numpy, resident["dirn"]))
    vcap = torch.from_numpy(resident["vcap"])
    calls = tk1.dense_intersect_resident_plain.calls
    hit = tpk.trace_packets(
        o, d, tpd, fine_td=sc["ttd"], tile_size=64, max_clusters=4,
        sort=vis, two_level=True, super_factor=4, super_slots=2, t_cap=vcap,
        vis_band=resident["band"] if vis else 0.0)
    assert tk1.dense_intersect_resident_plain.calls == calls + 1
    ln, eps = resident["ln"], EPS_VISIBILITY
    closest = np.asarray(resident["jclosest"].t)
    if not vis:
        np.testing.assert_array_equal(hit.tri.numpy(),
                                      np.asarray(resident["jclosest"].tri))
        np.testing.assert_array_equal(hit.t.numpy(), closest)
        want = ttrav.apply_t_cap(ttrav.trace_bruteforce(o, d, sc["ts"]),
                                 vcap)
        np.testing.assert_array_equal(hit.tri.numpy(), want.tri.numpy())
        np.testing.assert_array_equal(hit.t.numpy(), want.t.numpy())
        return
    t, jt = hit.t.numpy(), np.asarray(resident["jvis"].t)
    live = t != -1.0
    np.testing.assert_array_equal(t[live], closest[live])
    np.testing.assert_array_equal(hit.tri.numpy()[live], np.asarray(
        resident["jclosest"].tri)[live])
    assert (closest[~live] < resident["vcap"][~live] - resident["band"]).all()
    both = live & (jt != -1.0)
    np.testing.assert_array_equal(t[both], jt[both])
    np.testing.assert_array_equal(np.abs(t - ln) <= eps,
                                  np.abs(closest - ln) <= eps)
    assert (~live).sum() > 0 and (np.abs(t - ln) <= eps).sum() > 0


AUTO_SIZE = 16
AUTO_SPP = 2
AUTO_C = 8


@pytest.fixture(scope="module")
def auto_render():
    """Colonnade subdiv 3 at ``cluster_size=8`` with the bench camera, 16^2
    pt_nee 2 spp, seed 9, in the JAX package (its auto cull: the capped
    two-level one on its XLA engine) and in the port (K2's plain
    version)."""
    cam_kw = dict(pos=(0.0, 2.0, 3.4), width=AUTO_SIZE, height=AUTO_SIZE,
                  focal_length=2.0)
    cfg_kw = dict(width=AUTO_SIZE, height=AUTO_SIZE, spp=AUTO_SPP,
                  integrator="pt_nee", samples_per_call=AUTO_SPP,
                  cluster_size=AUTO_C)
    want = J.render(jproc.to_scene(jproc.colonnade(subdiv=3)),
                    make_camera(**cam_kw), J.RenderConfig(**cfg_kw), seed=9)
    ts = tproc.to_scene(tproc.colonnade(subdiv=3), "cpu")
    bvh = tren.build_bvh_for_scene(ts, 4, cluster_size=AUTO_C)
    calls = tk2.dense_intersect_plain.calls
    got = T.render(ts, T.make_camera(device="cpu", **cam_kw),
                   T.RenderConfig(**cfg_kw), seed=9, bvh=bvh, device="cpu")
    return dict(want=want, got=got, bvh=bvh, ts=ts,
                k2_calls=tk2.dense_intersect_plain.calls - calls)


def test_auto_two_level_route_past_2048_clusters(auto_render):
    """Past K = 2048 clusters, without a resident layout (C = 8 is not a
    multiple of 128), the auto cull is the capped two-level one with K2,
    as in the JAX package; the render folds through K2's plain version."""
    K, C = auto_render["bvh"].cl_tri.shape
    assert K == 3431 and C == AUTO_C
    assert tpk.route(K, C) == ("two_level", "stream")
    assert auto_render["k2_calls"] > 0


def test_auto_two_level_render_matches_jax(auto_render):
    """The auto two-level render equals the JAX package's per pixel
    (tests/torch_fold_cases.py:assert_pixels_close) and is lit."""
    got, want = auto_render["got"], auto_render["want"]
    assert_pixels_close(got.img, want.img)
    assert got.n == want.n == AUTO_SPP
    assert float(torch.stack(list(got.img)).max()) > 0
