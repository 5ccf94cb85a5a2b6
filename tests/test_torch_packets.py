"""The port's packet engine (cudapathtracer_tpu_torch/ops/packets.py, the
plain engine on the CPU) against the JAX package's
trace_packets(engine="xla") and against the port's brute-force oracle, on
the cases of tests/test_packets.py: primary rays, incoherent sorted rays, a
mask, a ray count that is not a multiple of the tile, and the overflow
fallback through the fine BVH with a tiny shortlist.

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
    """Past K = 2048 clusters without the resident layout, the auto cull
    would take the capped two-level cull, which is not ported: it raises. A
    scene past the resident kernel's budget (this C = 16 fixture: C is not
    a multiple of 128) takes the stream route, K2, and is exact."""
    o, d, mask = setup["inputs"]["primary"]
    pd = setup["tpd"]
    many = pd._replace(cl_lo=pd.cl_lo.map(lambda c: c.repeat(200)),
                       cl_hi=pd.cl_hi.map(lambda c: c.repeat(200)))
    with pytest.raises(NotImplementedError, match="two_level_cull"):
        tpk.trace_packets(_tv(o), _tv(d), many)
    assert tpk.route(pd.num_clusters, pd.cluster_size) == "stream"
    calls = tk2.dense_intersect_plain.calls
    hit = tpk.trace_packets(_tv(o), _tv(d), pd, fine_td=setup["ttd"],
                            tile_size=64, max_clusters=8)
    assert tk2.dense_intersect_plain.calls == calls + 1
    brute = ttrav.trace_bruteforce(_tv(o), _tv(d), setup["ts"])
    np.testing.assert_array_equal(hit.tri.numpy(), brute.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), brute.t.numpy())


# (K, C, two_level) -> route; None: raises. The JAX package's host build of
# the colonnade: subdiv 3 at adaptive C = 256 (K = 115), subdiv 6 at
# adaptive C = 1024 (K = 1,816), subdiv 5 at C = 256 (K = 1,842) and
# C = 128 (K = 3,699), subdiv 6 at C = 512 (K = 3,700)
ROUTES = [
    ((115, 256, None), "resident"),
    ((1816, 1024, None), "stream"),
    ((1842, 256, "super"), "super"),
    ((1842, 256, None), "resident"),
    ((3699, 128, None), "super"),
    ((3700, 512, None), None),
    ((3700, 512, "super"), None),
    ((100, 16, "super"), "stream"),
]


def _jax_route(K, C, two_level, F):
    """The JAX package's kernel choice, from its conditions
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
        return "super"
    if two_level and K > F:
        return None                      # the capped two-level XLA cull
    return "resident" if can_resident else "stream"


@pytest.mark.parametrize("args,want", ROUTES)
def test_route_matches_jax(args, want):
    assert _jax_route(*args, 8) == want
    if want is None:
        with pytest.raises(NotImplementedError, match="two_level_cull"):
            tpk.route(*args, 8)
    else:
        assert tpk.route(*args, 8) == want


def test_route_follows_the_budget(monkeypatch):
    """route reads the port's copy of the resident budget at call time, as
    the JAX package reads its own."""
    assert tpk.route(115, 256) == "resident"
    monkeypatch.setattr(tk1, "RESIDENT_VMEM_BUDGET", 1024)
    assert tpk.route(115, 256) == "stream"
    assert tpk.route(115, 256, "super", 8) == "stream"
