"""The port's packet engine (cudapathtracer_tpu_torch/ops/packets.py, the
plain engine on the CPU) against the JAX package's
trace_packets(engine="xla") and against the port's brute-force oracle, on
the cases of tests/test_packets.py: primary rays, incoherent sorted rays, a
mask, a ray count that is not a multiple of the tile, and the overflow
fallback through the fine BVH with a tiny shortlist. Then the caller's cap
(``t_cap``) and visibility-only queries (``vis_band``), against the JAX
package's capped query and its Pallas kernels in interpret mode; and the
Moller-Trumbore intersector on the resident route, against both JAX
engines.

Triangle ids match exactly. t equals the port's brute force bit for bit;
against the JAX engine it is held to rtol 1e-6 (tests/test_packets.py:202),
since XLA fuses multiply-adds differently inside its fused slot loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudapathtracer_tpu import make_camera
from cudapathtracer_tpu.models import procedural as jproc
from cudapathtracer_tpu.ops import packets as jpk
from cudapathtracer_tpu.ops import traversal as jtrav
from cudapathtracer_tpu.ops.rng import pixel_keys, sample_key
from cudapathtracer_tpu.ops.vecmath import Vec3 as JVec3
from cudapathtracer_tpu.render.camera import camera_rays
from cudapathtracer_tpu.render.renderer import build_bvh_for_scene

from cudapathtracer_tpu_torch import convert
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import packets as tpk
from cudapathtracer_tpu_torch.ops import traversal as ttrav
from cudapathtracer_tpu_torch.ops.kernels import dense as tk2
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as tk1
from cudapathtracer_tpu_torch.ops.vecmath import Vec3 as TVec3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU, and torch's default of a thread per core in each of them
    oversubscribes it (the renders here ran 10x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name -> (rays, R, tile_size, max_clusters, sort, masked)
CASES = {
    "primary": ("camera", None, 64, 8, False, False),
    "primary_sorted": ("camera", None, 64, 8, True, False),
    "incoherent_sorted": ("random", None, 128, 4, True, False),
    "masked": ("camera", None, 64, 8, True, True),
    "nonmultiple": ("camera", 100, 64, 8, False, False),
    "overflow_fallback": ("camera", None, 64, 1, True, False),
}


def _sub(v, n):
    return JVec3(*(c[:n] for c in v))


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
    k = jax.random.PRNGKey(3)
    ko, kd = jax.random.split(k)
    rnd = (JVec3.from_array(jax.random.uniform(ko, (512, 3))),
           JVec3.from_array(jax.random.normal(kd, (512, 3)) + 1e-3))
    rays = {"camera": cam, "random": rnd}
    ref, inputs = {}, {}
    for name, (kind, n, ts, mc, sort, masked) in CASES.items():
        o, d = rays[kind]
        if n is not None:
            o, d = _sub(o, n), _sub(d, n)
        R = o.x.shape[0]
        mask = (np.arange(R) % 3) != 0 if masked else np.ones(R, bool)
        ref[name] = jpk.trace_packets(
            o, d, jpd, fine_td=jtd, mask=jnp.asarray(mask), tile_size=ts,
            max_clusters=mc, engine="xla", sort=sort)
        inputs[name] = (o, d, mask)

    ts_ = tproc.to_scene(tproc.cornell_with_sphere_mesh(subdiv=2), "cpu")
    ta = convert.accel_from_jax(convert.to_numpy_dict(accel), "cpu")
    tpd = tpk.make_packet_data(
        ts_, TVec3(ta.cl_lo_x, ta.cl_lo_y, ta.cl_lo_z),
        TVec3(ta.cl_hi_x, ta.cl_hi_y, ta.cl_hi_z), ta.cl_tri)
    return dict(ref=ref, inputs=inputs, ts=ts_, tpd=tpd,
                ttd=ttrav.make_trace_data(ts_, ta.fine))


def _tv(v):
    return TVec3(*(torch.from_numpy(np.array(c)) for c in v))


@pytest.mark.parametrize("name", list(CASES))
def test_packets_match_jax_and_brute(setup, name):
    _, _, ts, mc, sort, _ = CASES[name]
    o, d, mask = setup["inputs"][name]
    o, d, mask = _tv(o), _tv(d), torch.from_numpy(mask)
    hit = tpk.trace_packets(o, d, setup["tpd"], fine_td=setup["ttd"],
                            mask=mask, tile_size=ts, max_clusters=mc,
                            sort=sort)
    ref = setup["ref"][name]
    assert hit.t.shape == mask.shape
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t), rtol=1e-6,
                               atol=1e-6)
    brute = ttrav.trace_bruteforce(o, d, setup["ts"], mask=mask)
    np.testing.assert_array_equal(hit.tri.numpy(), brute.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), brute.t.numpy())
    m = mask.numpy()
    assert (hit.tri.numpy()[~m] == -1).all()
    assert (hit.t.numpy()[~m] == 1e5).all()
    assert (hit.tri.numpy()[m] >= 0).sum() > 0


def test_overflow_fallback_is_exercised(setup):
    """With a one-cluster shortlist, some rays' best hit is not below the
    dropped-candidate bound U, so the fine-BVH fallback must run."""
    o, d, mask = setup["inputs"]["overflow_fallback"]
    o, d = _tv(o), _tv(d)
    sl = tpk.build_shortlists(o, d, torch.from_numpy(mask), setup["tpd"],
                              64, 1)
    assert torch.isfinite(sl.U).any()


def test_auto_engine_follows_the_device(setup):
    """The fold's wrapper takes the plain version for CPU tensors (and counts
    no kernel launch), and refuses a device it has no kernel for."""
    o, d, mask = setup["inputs"]["primary"]
    sl = tpk.build_shortlists(_tv(o), _tv(d), torch.from_numpy(mask),
                              setup["tpd"], 64, 8)
    args = (sl.ids, sl.counts, sl.entries, sl.rays,
            *tk1.pack_clusters(setup["tpd"]))
    calls = tk1.dense_intersect_resident_plain.calls
    launches = tk1.dense_intersect_resident.launches
    t, tri = tk1.dense_intersect_resident(*args)
    assert tk1.dense_intersect_resident_plain.calls == calls + 1
    assert tk1.dense_intersect_resident.launches == launches
    t_p, tri_p = tk1.dense_intersect_resident_plain(*args)
    np.testing.assert_array_equal(tri.numpy(), tri_p.numpy())
    np.testing.assert_array_equal(t.numpy(), t_p.numpy())
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk1.dense_intersect_resident(*(a.to("meta") for a in args))


def test_unported_regimes_raise(setup):
    """The regimes that raised before the capped two-level cull was ported
    now trace exactly: past K = 2048 clusters without the resident layout,
    the auto cull takes the capped two-level cull with K2, held against
    brute force. A scene past the resident kernel's budget (this C = 16
    fixture: C is not a multiple of 128) takes the stream route, K2, and
    is exact."""
    o, d, mask = setup["inputs"]["primary"]
    pd = setup["tpd"]
    brute = ttrav.trace_bruteforce(_tv(o), _tv(d), setup["ts"])
    # 200 copies of the clusters: K = 2,200 boxes over 11 clusters' blocks
    K = pd.num_clusters * 200
    sel = torch.arange(K) % pd.num_clusters
    many = pd._replace(
        cl_lo=pd.cl_lo.map(lambda c: c.repeat(200)),
        cl_hi=pd.cl_hi.map(lambda c: c.repeat(200)),
        **{f: getattr(pd, f).map(lambda c: torch.cat(
            [c[:-1][sel], c[-1:]])) for f in ("v0", "e1", "e2")},
        tri=torch.cat([pd.tri[:-1][sel], pd.tri[-1:]]))
    assert tpk.route(K, pd.cluster_size) == ("two_level", "stream")
    calls = tk2.dense_intersect_plain.calls
    hit = tpk.trace_packets(_tv(o), _tv(d), many, fine_td=setup["ttd"],
                            tile_size=64, max_clusters=8)
    assert tk2.dense_intersect_plain.calls == calls + 1
    np.testing.assert_array_equal(hit.tri.numpy(), brute.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), brute.t.numpy())
    assert tpk.route(pd.num_clusters, pd.cluster_size) == ("flat", "stream")
    calls = tk2.dense_intersect_plain.calls
    hit = tpk.trace_packets(_tv(o), _tv(d), pd, fine_td=setup["ttd"],
                            tile_size=64, max_clusters=8)
    assert tk2.dense_intersect_plain.calls == calls + 1
    np.testing.assert_array_equal(hit.tri.numpy(), brute.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), brute.t.numpy())


# (K, C, two_level) -> (cull, kernel). The JAX package's host build of the
# colonnade: subdiv 3 at adaptive C = 256 (K = 115), subdiv 6 at adaptive
# C = 1024 (K = 1,816), subdiv 5 at C = 256 (K = 1,842) and C = 128
# (K = 3,699), subdiv 6 at C = 512 (K = 3,700). The ids are those the
# cases had when the two-level rows raised (want None)
ROUTES = [
    ((115, 256, None), ("flat", "resident")),
    ((1816, 1024, None), ("flat", "stream")),
    ((1842, 256, "super"), ("super", "super")),
    ((1842, 256, None), ("flat", "resident")),
    ((3699, 128, None), ("super", "super")),
    ((3700, 512, None), ("two_level", "stream")),
    ((3700, 512, "super"), ("two_level", "stream")),
    ((100, 16, "super"), ("flat", "stream")),
]
ROUTE_IDS = ["args0-resident", "args1-stream", "args2-super",
             "args3-resident", "args4-super", "args5-None", "args6-None",
             "args7-stream"]


def _jax_route(K, C, two_level, F):
    """The JAX package's cull and kernel choice, from its conditions
    (cudapathtracer_tpu/ops/packets.py:531-557, :754-780)."""
    from cudapathtracer_tpu.ops.pallas.dense_resident import resident_fits

    can_resident = C % 128 == 0 and resident_fits(K, C)
    can_super = can_resident and K > 2 * F
    use_super = two_level == "super" and can_super
    if two_level == "super" and not use_super:
        two_level = None
    if two_level is None:
        if K <= 2048:
            two_level = False
        elif can_super:
            use_super = True
        else:
            two_level = True
    if use_super:
        return ("super", "super")
    return ("two_level" if two_level and K > F else "flat",
            "resident" if can_resident else "stream")


@pytest.mark.parametrize("args,want", ROUTES, ids=ROUTE_IDS)
def test_route_matches_jax(args, want):
    assert _jax_route(*args, 8) == want
    assert tpk.route(*args, 8) == want


def test_route_follows_the_budget(monkeypatch):
    """route reads the port's copy of the resident budget at call time, as
    the JAX package reads its own."""
    assert tpk.route(115, 256).kernel == "resident"
    monkeypatch.setattr(tk1, "RESIDENT_VMEM_BUDGET", 1024)
    assert tpk.route(115, 256).kernel == "stream"
    assert tpk.route(115, 256, "super", 8).kernel == "stream"


# ---- the caller's cap (t_cap) and visibility-only queries (vis_band) -----
# name -> (fixture scene, tile_size, max_clusters, sort, two_level)
CAP_CASES = {
    "stream_sorted": ("c16", 64, 8, True, None),
    "heavy_fallback": ("c16", 64, 1, False, None),
    "resident_sorted": ("c128", 64, 16, True, None),
    "super_sorted": ("c128", 64, 16, True, "super"),
}
VIS_ROUTES = ("resident", "stream", "super")


def _kw(two_level):
    return dict(two_level="super", super_factor=2) if two_level else {}


@pytest.fixture(scope="module")
def capped(setup):
    """Camera rays of two scenes: the C = 16 fixture's (the stream route)
    and tests/test_torch_dense_super.py's at C = 128 (subdiv 3, K = 16 >
    2F: the resident and super routes), with the caps of
    tests/test_packets.py:310-329 (a quarter at 1.5, a quarter exactly at
    the ray's hit) and, so that some hits survive their cap, a quarter just
    above the hit and a quarter at 4.0; shadow-style queries
    (tests/test_packets.py:442-502) toward a light;
    and the JAX package's answers: its capped XLA query, its closest-hit
    query of the shadow rays, and its Pallas kernels' visibility query in
    interpret mode on each route."""
    from cudapathtracer_tpu.ops.pallas import dense_resident as jdr
    from cudapathtracer_tpu.utils.constants import EPS_VISIBILITY
    from torch_fold_cases import jax_scene

    sc = jax_scene(subdiv=3)
    scenes = {"c16": (setup["ts"], setup["tpd"], setup["ttd"], None),
              "c128": (sc["ts"], sc["tpd"], sc["ttd"], sc)}
    # the JAX side of the C = 16 fixture, rebuilt as setup builds it
    js = jproc.to_scene(jproc.cornell_with_sphere_mesh(subdiv=2))
    acc16 = build_bvh_for_scene(js, leaf_size=4, cluster_size=16)
    jside = {"c16": (jpk.make_packet_data(
        js, JVec3(acc16.cl_lo_x, acc16.cl_lo_y, acc16.cl_lo_z),
        JVec3(acc16.cl_hi_x, acc16.cl_hi_y, acc16.cl_hi_z), acc16.cl_tri),
        jtrav.make_trace_data(js, acc16.fine)),
        "c128": (sc["jpd"], sc["jtd"])}
    o, d = (np.stack([np.asarray(c) for c in v]) for v in setup["inputs"][
        "primary"][:2])
    to, td_ = TVec3(*map(torch.from_numpy, o)), TVec3(*map(torch.from_numpy,
                                                           d))
    jo, jd = JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d))
    out = {"o": to, "d": td_, "scenes": scenes, "caps": {}, "jcap": {}}
    for key, (ts_, _, _, _) in scenes.items():
        b = ttrav.trace_bruteforce(to, td_, ts_)
        q = torch.arange(b.t.shape[0]) % 4
        caps = torch.where(q == 0, 1.5, torch.where(
            q == 1, b.t, torch.where(q == 2, torch.nextafter(
                b.t, torch.tensor(np.inf)), 4.0)))
        out["caps"][key] = caps
    for name, (key, P, mc, sort, tl) in CAP_CASES.items():
        jpd, jtd = jside[key]
        out["jcap"][name] = jpk.trace_packets(
            jo, jd, jpd, fine_td=jtd, tile_size=P, max_clusters=mc,
            engine="xla", sort=sort, t_cap=jnp.asarray(
                out["caps"][key].numpy()))

    # shadow-style queries in the C = 128 scene, from the camera rays' hits
    # to the centroid of the first light triangle: a clear segment hits the
    # light at its length (visible), a blocked one hits short of it
    h0 = ttrav.trace_bruteforce(to, td_, sc["ts"])
    t0 = torch.where(h0.tri >= 0, h0.t - 1e-3, 1.0)
    pos = TVec3(*(oc + dc * t0 for oc, dc in zip(to, td_)))
    lt = sc["ts"].lights[0].long()
    tgt = [sum(getattr(sc["ts"].verts, c)[getattr(sc["ts"], f"tri_v{k}")[
        lt].long()] for k in range(3)) / 3.0 for c in "xyz"]
    seg = TVec3(*(tgt[0] - pos.x, tgt[1] - pos.y, tgt[2] - pos.z))
    ln = torch.sqrt(seg.x ** 2 + seg.y ** 2 + seg.z ** 2)
    dirn = TVec3(*(c / ln for c in seg))
    out.update(pos=pos, dirn=dirn, ln=ln,
               vcap=ln + 2.0 * EPS_VISIBILITY, band=3.0 * EPS_VISIBILITY,
               eps=EPS_VISIBILITY)
    jpos, jdir = (JVec3(*(jnp.asarray(c.numpy()) for c in v))
                  for v in (pos, dirn))
    jvcap = jnp.asarray(out["vcap"].numpy())
    out["jclosest"] = jpk.trace_packets(
        jpos, jdir, sc["jpd"], fine_td=sc["jtd"], tile_size=64,
        engine="xla", t_cap=jvcap)
    out["jvis"] = {}
    for r in VIS_ROUTES:
        with pytest.MonkeyPatch.context() as mp:
            if r == "stream":
                mp.setattr(jdr, "RESIDENT_VMEM_BUDGET", 1024)
            out["jvis"][r] = jpk.trace_packets(
                jpos, jdir, sc["jpd"], fine_td=sc["jtd"], tile_size=64,
                engine="pallas_interpret", sort=True, t_cap=jvcap,
                vis_band=out["band"], **_kw(r == "super"))
    return out


@pytest.mark.parametrize("name", list(CAP_CASES))
def test_t_cap_matches_jax_and_capped_brute(capped, name):
    """The caller's cap: hits below it exact, hits at or beyond it the
    miss, after the fallback (packets.py:860-884), with the cap carried
    through the ray sort: ids and t equal the port's capped brute force and
    the JAX package's capped query, on the stream, resident and super
    routes and with a one-cluster shortlist (heavy fallback)."""
    key, P, mc, sort, tl = CAP_CASES[name]
    ts_, tpd, ttd, _ = capped["scenes"][key]
    caps = capped["caps"][key]
    o, d = capped["o"], capped["d"]
    hit = tpk.trace_packets(o, d, tpd, fine_td=ttd, tile_size=P,
                            max_clusters=mc, sort=sort, t_cap=caps,
                            **_kw(tl))
    want = ttrav.apply_t_cap(ttrav.trace_bruteforce(o, d, ts_), caps)
    np.testing.assert_array_equal(hit.tri.numpy(), want.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), want.t.numpy())
    jref = capped["jcap"][name]
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(jref.tri))
    np.testing.assert_array_equal(hit.t.numpy(), np.asarray(jref.t))
    q = torch.arange(caps.shape[0]) % 4
    assert bool((hit.tri[q == 1] == -1).all())
    assert int((hit.tri[q == 2] >= 0).sum()) > 100
    if name == "heavy_fallback":
        sl = tpk.build_shortlists(o, d, torch.ones_like(caps, dtype=bool),
                                  tpd, P, mc, t_cap=caps)
        assert torch.isfinite(sl.U).any()


def test_t_cap_rides_the_sort(capped):
    """Sorted and unsorted capped queries agree: the cap is permuted with
    the rays (a cap left in ray order would cap the wrong rays)."""
    ts_, tpd, ttd, _ = capped["scenes"]["c128"]
    caps = capped["caps"]["c128"]
    a, b = (tpk.trace_packets(capped["o"], capped["d"], tpd, fine_td=ttd,
                              tile_size=64, max_clusters=16, sort=s,
                              t_cap=caps) for s in (False, True))
    np.testing.assert_array_equal(a.tri.numpy(), b.tri.numpy())
    np.testing.assert_array_equal(a.t.numpy(), b.t.numpy())


@pytest.mark.parametrize("route", VIS_ROUTES)
def test_vis_band_matches_jax_kernels(capped, route, monkeypatch):
    """A visibility-only query (vis_band = 3 eps, t_cap = len + 2 eps)
    against the JAX package's Pallas kernels in interpret mode on the
    resident, stream (forced) and super routes: t equal, the occluded
    report -1.0 included; ids equal wherever t is not -1.0 (an occluded
    ray's id is whichever occluder retired it); and every decision
    |t - len| <= eps equal to the JAX package's closest-hit query's."""
    if route == "stream":
        monkeypatch.setattr(tk1, "RESIDENT_VMEM_BUDGET", 1024)
    _, tpd, ttd, _ = capped["scenes"]["c128"]
    assert tpk.route(tpd.num_clusters, tpd.cluster_size,
                     "super" if route == "super" else None, 2).kernel == route
    hv = tpk.trace_packets(capped["pos"], capped["dirn"], tpd, fine_td=ttd,
                           tile_size=64, sort=True, t_cap=capped["vcap"],
                           vis_band=capped["band"], **_kw(route == "super"))
    jv = capped["jvis"][route]
    tv_, jt = hv.t.numpy(), np.asarray(jv.t)
    np.testing.assert_array_equal(tv_, jt)
    live = tv_ != -1.0
    np.testing.assert_array_equal(hv.tri.numpy()[live],
                                  np.asarray(jv.tri)[live])
    ln, eps = capped["ln"].numpy(), capped["eps"]
    vis = np.abs(tv_ - ln) <= eps
    ref = np.abs(np.asarray(capped["jclosest"].t) - ln) <= eps
    np.testing.assert_array_equal(vis, ref)
    assert (~live).sum() > 0 and vis.sum() > 0


@pytest.mark.parametrize("engine", ["xla", "pallas_interpret"])
def test_mt_resident_route_matches_jax(capped, engine):
    """trace_packets(intersector="mt") on the resident route (C = 128,
    K = 16) with a two-cluster shortlist, so that the plain fold and the
    fine-BVH fallback both run: ids and t equal to the JAX package's
    trace_packets(intersector="mt") on its XLA engine and on its Pallas
    kernel in interpret mode, and to brute force's."""
    ts_, tpd, ttd, sc = capped["scenes"]["c128"]
    o, d = capped["o"], capped["d"]
    kw = dict(tile_size=64, max_clusters=2, sort=True, intersector="mt")
    assert tpk.route(tpd.num_clusters, tpd.cluster_size).kernel == "resident"
    calls = tk1.dense_intersect_resident_plain.calls
    hit = tpk.trace_packets(o, d, tpd, fine_td=ttd, **kw)
    assert tk1.dense_intersect_resident_plain.calls == calls + 1
    on = torch.ones_like(o.x, dtype=torch.bool)
    perm = tpk.sort_rays(o, d, on, tpd)
    sl = tpk.build_shortlists(o.map(lambda c: c[perm]),
                              d.map(lambda c: c[perm]), on, tpd, 64, 2)
    u = sl.U.repeat_interleave(64)[:o.x.shape[0]]
    assert int((hit.t[perm] >= u).sum()) > 0          # the fallback ran
    ref = sc["jpk"].trace_packets(
        JVec3(*(jnp.asarray(c.numpy()) for c in o)),
        JVec3(*(jnp.asarray(c.numpy()) for c in d)), sc["jpd"],
        fine_td=sc["jtd"], engine=engine, **kw)
    brute = ttrav.trace_bruteforce(o, d, ts_, intersector="mt")
    for want in (ref, brute):
        np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(want.tri))
        np.testing.assert_array_equal(hit.t.numpy(), np.asarray(want.t))
    assert int((hit.tri >= 0).sum()) > 100


def test_vis_band_needs_t_cap(setup):
    o, d, _ = setup["inputs"]["primary"]
    with pytest.raises(ValueError, match="t_cap"):
        tpk.trace_packets(_tv(o), _tv(d), setup["tpd"], vis_band=0.03)
