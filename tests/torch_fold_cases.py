"""Inputs shared by the tests of the port's dense fold kernels K1, K2 and K3
(tests/test_torch_dense_*.py): rays made with numpy or the port's camera,
the port's packet data and shortlists, and the same scene on the JAX side;
and the per-pixel rule of the render tests (``assert_pixels_close``, with
``jax_normalize_rounded`` to show what its residue share admits).

The JAX package is imported only inside ``jax_scene`` and
``jax_normalize_rounded``, so the kernels' ``cuda`` cases also run where
JAX is not installed."""

import contextlib
import sys

import numpy as np
import torch

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import convert
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import packets as tpk
from cudapathtracer_tpu_torch.ops import traversal as ttrav
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as tk1
from cudapathtracer_tpu_torch.ops.vecmath import Vec3 as TVec3
from cudapathtracer_tpu_torch.render.camera import camera_rays
from cudapathtracer_tpu_torch.render.renderer import build_bvh_for_scene


def tv(v):
    return TVec3(*(torch.from_numpy(np.array(c)) for c in v))


def rays(kind, n=256):
    """(o, d, mask) numpy rays: camera rays at 16^2 or random ones."""
    if kind == "camera":
        o, d = camera_rays(T.make_camera(width=16, height=16, device="cpu"),
                           torch.arange(n), None, lens=False)
        o, d = [c.numpy() for c in o], [c.numpy() for c in d]
    else:
        rng = np.random.default_rng(3)
        o = [rng.uniform(-0.8, 0.8, n).astype(np.float32) + off
             for off in (0.0, 1.0, 0.0)]
        d = [(rng.standard_normal(n) + 1e-3).astype(np.float32)
             for _ in range(3)]
    mask = (np.arange(n) % 7) != 0
    return o, d, mask


def packet_data(accel, scene):
    return tpk.make_packet_data(
        scene, TVec3(accel.cl_lo_x, accel.cl_lo_y, accel.cl_lo_z),
        TVec3(accel.cl_hi_x, accel.cl_hi_y, accel.cl_hi_z), accel.cl_tri)


def shortlists(tpd, kind, sort, max_clusters=16, **kw):
    """Shortlists of 64-ray tiles of ``rays(kind)``, sorted as the packet
    engine sorts them when ``sort``; ``kw`` goes to build_shortlists."""
    o, d, mask = rays(kind)
    o, d, mask = tv(o), tv(d), torch.from_numpy(mask)
    if sort:
        perm = tpk.sort_rays(o, d, mask, tpd)
        o, d, mask = o.map(lambda c: c[perm]), d.map(lambda c: c[perm]), \
            mask[perm]
    return tpk.build_shortlists(o, d, mask, tpd, 64, max_clusters, **kw)


def with_mt(cases):
    """pytest params of each case (a tuple) with 'bw' and then 'mt'
    appended, the Baldwin-Weber ones under the ids they had before the
    Moller-Trumbore ones joined them."""
    import pytest

    out = []
    for c in cases:
        c = c if isinstance(c, tuple) else (c,)
        base = "-".join(str(v) for v in c)
        out.append(pytest.param(*c, "bw", id=base))
        out.append(pytest.param(*c, "mt", id=f"{base}-mt"))
    return out


SYNTHETIC_CASES = ("ties", "masked", "cap_is_hit", "negative_cap", "padding",
                   "max_float_cap", "band")
# the visibility band of BDPT's connection rays: 3 * EPS_VISIBILITY
VIS_BAND = 0.03


def synthetic_case(case, C, P, dev="cpu", tiles=4, K=6, seed=0,
                   intersector="bw"):
    """A made-up scene of K clusters of C triangles and ``tiles`` tiles of P
    rays from a seed (numpy), for the fold's corner cases:

    * ties: half the triangles repeat another one's vertices under another
      id, so hits tie at exactly the same t (the lower id must win);
    * masked: every third ray masked (its t stays at -3e38);
    * cap_is_hit: each ray's cap is the t of its closest hit (the init
      (cap, -1) must keep that tie);
    * negative_cap: half the caps negative;
    * padding: two thirds of every cluster are padding triangles;
    * max_float_cap: an extra cluster holds a triangle at z = 1e5 + 2, which
      the first P rays, cast along +z from z = 2 above the other clusters,
      hit at exactly t = 1e5 = MAX_FLOAT, with the scene's exit cap past it:
      the hit ties the init (MAX_FLOAT, -1) and must not win, and neither
      may a rejected test's (MAX_FLOAT, id);
    * band: each ray that hits gets a cap near its closest hit, from
      VIS_BAND below to twice VIS_BAND above it (``band_caps``), so that a
      visibility query (vis_band = VIS_BAND) retires some rays and keeps
      others.

    The pack is ``intersector``'s; padding and the sentinel are all-zero
    rows in either layout.

    -> (kernel inputs ids, counts, entries, rays, packed, tri, boxes on
    ``dev``; the number of triangles)."""
    rng = np.random.default_rng([seed, SYNTHETIC_CASES.index(case), C, P])
    n_real = C // 3 if case == "padding" else C
    centers = rng.uniform(-1.0, 1.0, (K, 1, 3))
    v0 = centers + rng.uniform(-0.4, 0.4, (K, n_real, 3))
    e1 = rng.uniform(-0.3, 0.3, (K, n_real, 3))
    e2 = rng.uniform(-0.3, 0.3, (K, n_real, 3))
    if case == "ties":          # the second half repeats the first
        half = n_real // 2
        for a in (v0, e1, e2):
            a[:, half:2 * half] = a[:, :half]
    if case == "max_float_cap":  # the far triangle, normal (0, 0, 4)
        far = np.zeros((1, n_real, 3))
        v0, e1, e2 = (np.concatenate([a, far]) for a in (v0, e1, e2))
        v0[K, 0] = (-1.0, -1.0, 1e5 + 2.0)
        e1[K, 0] = (2.0, 0.0, 0.0)
        e2[K, 0] = (0.0, 2.0, 0.0)
        K += 1
    T = K * n_real
    ids = rng.permutation(T).reshape(K, n_real)
    if case == "max_float_cap":
        ids[K - 1, 1:] = T      # the far cluster's one triangle; padding
    lo = (v0 + np.minimum(0.0, np.minimum(e1, e2))).min(axis=1)
    hi = (v0 + np.maximum(0.0, np.maximum(e1, e2))).max(axis=1)
    if case == "max_float_cap":
        lo[K - 1], hi[K - 1] = (-1.0, -1.0, 1e5 + 2.0), (1.0, 1.0, 1e5 + 2.0)

    def block(a, fill):         # (K, n_real, ...) -> (K+1, C, ...)
        out = np.full((K + 1, C) + a.shape[2:], fill, a.dtype)
        out[:K, :n_real] = a
        return out

    f32 = np.float32
    v = [TVec3(*(torch.from_numpy(block(a, 0.0)[..., k].astype(f32))
                 for k in range(3))) for a in (v0, e1, e2)]
    pd = tpk.PacketData(
        cl_lo=TVec3(*(torch.from_numpy(lo[:, k].astype(f32))
                      for k in range(3))),
        cl_hi=TVec3(*(torch.from_numpy(hi[:, k].astype(f32))
                      for k in range(3))),
        v0=v[0], e1=v[1], e2=v[2],
        tri=torch.from_numpy(block(ids, T).astype(np.int32)), num_tris=T)
    R = tiles * P
    o = rng.uniform(-1.5, 1.5, (R, 3))
    d = rng.uniform(-1.0, 1.0, (R, 3)) * 0.3 + centers[
        rng.integers(0, centers.shape[0], R), 0] - o
    if case == "max_float_cap":
        o[:P] = np.stack([rng.uniform(-0.4, 0.4, P), rng.uniform(-0.4, 0.4, P),
                          np.full(P, 2.0)], axis=1)
        d[:P] = (0.0, 0.0, 1.0)
    mask = (np.arange(R) % 3 != 0) if case == "masked" else np.ones(R, bool)
    sl = tpk.build_shortlists(
        TVec3(*(torch.from_numpy(o[:, k].astype(f32)) for k in range(3))),
        TVec3(*(torch.from_numpy(d[:, k].astype(f32)) for k in range(3))),
        torch.from_numpy(mask), pd, P, K)
    pack = tk1.pack_clusters(pd, intersector)
    rays = sl.rays.clone()
    if case == "cap_is_hit":
        t, tri = tk1.plain_fold(sl.ids, sl.counts, sl.entries, rays, *pack)
        rays[:, 7] = torch.where(tri >= 0, t, rays[:, 7])
    elif case == "negative_cap":
        neg = torch.from_numpy(-rng.uniform(0.0, 0.5, rays[:, 7].shape)
                               .astype(f32))
        rays[:, 7] = torch.where(torch.arange(P) % 2 == 0, neg, rays[:, 7])
    args = (sl.ids, sl.counts, sl.entries, rays.contiguous(), *pack)
    if case == "band":
        args = band_caps(args, rng)
    return tuple(a.to(dev) for a in args), T


def band_caps(args, rng, fold=tk1.plain_fold):
    """Kernel inputs with each hitting ray's cap (row 7) moved near its
    closest hit t (by ``fold``, the plain version of the inputs' kernel):
    t + VIS_BAND * u, u from {-1, 0, 1, 2} or uniform in [-1, 2], so the
    floor cap - VIS_BAND lies above t (retire) or near or below it (keep;
    a cap of t itself keeps the init (t, -1))."""
    ids, counts, entries, rays, packed, tri, boxes = args
    t, best = fold(*args)
    shape = tuple(t.shape)
    u = np.where(rng.random(shape) < 0.5, rng.integers(-1, 3, shape),
                 rng.uniform(-1.0, 2.0, shape)).astype(np.float32)
    cap = t + np.float32(VIS_BAND) * torch.from_numpy(u).to(t.device)
    rays = rays.clone()
    rays[:, 7] = torch.where(best >= 0, cap, rays[:, 7])
    return (ids, counts, entries, rays.contiguous(), packed, tri, boxes)


def vis_case(case, C, P, dev="cpu", fold=tk1.plain_fold, F=None,
             intersector="bw"):
    """Inputs for a visibility query: a synthetic case, or ("colonnade")
    colonnade subdiv 3 with band caps (in super units of F with ``F``, and
    then ``fold`` K3's plain version), with ``intersector``'s pack."""
    if case == "colonnade":
        sl, pack, _ = colonnade_case(C, torch.device(dev), super_factor=F,
                                     tile_size=P, intersector=intersector)
        return band_caps((sl.ids, sl.counts, sl.entries, sl.rays, *pack),
                         np.random.default_rng(11), fold)
    return synthetic_case(case, C, P, dev, intersector=intersector)[0]


def check_vis(args, got, fold=tk1.plain_fold, group=None):
    """A visibility query's (t, id) ``got`` against the plain version
    ``fold``: t bit for bit, -3e38 exactly where the closest hit lies below
    the floor cap - VIS_BAND (and on masked lanes), ids equal elsewhere;
    with ``group``, equal in full to the plain count of that schedule (K1's
    or K2's), retired ids included. -> the number of retired live rays."""
    def host(a):
        return a.cpu().numpy()

    t, tri = got
    pt, ptri = fold(*args, vis_band=VIS_BAND)
    ct, ctri = fold(*args)
    rays = args[3]
    live = rays[:, 6] > 0.5
    below = ct < rays[:, 7] - np.float32(VIS_BAND)
    np.testing.assert_array_equal(
        host(pt), host(torch.where(below, tk1.MASKED_T_INIT, ct)))
    np.testing.assert_array_equal(host(t).view(np.int32),
                                  host(pt).view(np.int32))
    keep = pt != tk1.MASKED_T_INIT
    np.testing.assert_array_equal(host(tri[keep]), host(ptri[keep]))
    np.testing.assert_array_equal(host(ptri), host(ctri))
    if group is not None:
        st, stri, _ = tk1.fold_schedule(*args, group, vis_band=VIS_BAND)
        np.testing.assert_array_equal(host(t).view(np.int32),
                                      host(st).view(np.int32))
        np.testing.assert_array_equal(host(tri), host(stri))
    return int((below & live).sum())


def colonnade_case(cluster_size, dev, super_factor=None, tile_size=128,
                   intersector="bw"):
    """32^2 sorted camera rays (every 7th masked) of colonnade subdiv 3 at
    cluster width ``cluster_size``, tiled by ``tile_size``: (shortlists,
    ``intersector``'s pack) on ``dev``, in super units with
    ``super_factor``, and the triangle count."""
    ts = tproc.to_scene(tproc.colonnade(subdiv=3), "cpu")
    tpd = packet_data(
        build_bvh_for_scene(ts, 4, cluster_size=cluster_size), ts)
    cam = T.make_camera(pos=(0.0, 2.0, 3.4), width=32, height=32,
                        focal_length=2.0, device="cpu")
    o, d = camera_rays(cam, torch.arange(32 * 32), None, lens=False)
    mask = torch.arange(32 * 32) % 7 != 0
    perm = tpk.sort_rays(o, d, mask, tpd)
    sl = tpk.build_shortlists(o.map(lambda c: c[perm]),
                              d.map(lambda c: c[perm]), mask[perm], tpd,
                              tile_size, 4095, super_factor=super_factor)
    sl = type(sl)(*(a.to(dev) for a in sl))
    pack = tuple(a.to(dev) for a in tk1.pack_clusters(tpd, intersector))
    return sl, pack, ts.num_tris


def jax_scene(subdiv):
    """cornell_with_sphere_mesh(subdiv) at C = 128 in both packages: the
    port's packet data, trace data and packs beside the JAX package's (the
    Baldwin-Weber ones, and the Moller-Trumbore ones under ``*_mt``), with
    the JAX modules the tests call."""
    import jax.numpy as jnp

    from cudapathtracer_tpu.models import procedural as jproc
    from cudapathtracer_tpu.ops import packets as jpk
    from cudapathtracer_tpu.ops import traversal as jtrav
    from cudapathtracer_tpu.ops.pallas import dense as jd
    from cudapathtracer_tpu.ops.pallas import dense_resident as jdr
    from cudapathtracer_tpu.ops.vecmath import Vec3 as JVec3
    from cudapathtracer_tpu.render.renderer import build_bvh_for_scene

    js = jproc.to_scene(jproc.cornell_with_sphere_mesh(subdiv=subdiv))
    accel = build_bvh_for_scene(js, leaf_size=4, cluster_size=128)
    jpd = jpk.make_packet_data(
        js, JVec3(accel.cl_lo_x, accel.cl_lo_y, accel.cl_lo_z),
        JVec3(accel.cl_hi_x, accel.cl_hi_y, accel.cl_hi_z), accel.cl_tri)
    ta = convert.accel_from_jax(convert.to_numpy_dict(accel), "cpu")
    ts = tproc.to_scene(tproc.cornell_with_sphere_mesh(subdiv=subdiv), "cpu")
    tpd = packet_data(ta, ts)
    return dict(js=js, jpd=jpd, jtd=jtrav.make_trace_data(js, accel.fine),
                ts=ts, tpd=tpd, ttd=ttrav.make_trace_data(ts, ta.fine),
                pack=tk1.pack_clusters(tpd),
                jpack=jdr.pack_clusters_resident_bw(jpd),
                pack_mt=tk1.pack_clusters(tpd, "mt"),
                jpack_mt=jdr.pack_clusters_resident(jpd),
                jboxes=jdr.pack_cluster_boxes(jpd), jd=jd, jdr=jdr,
                jpk=jpk, jnp=jnp, JVec3=JVec3)


# the per-pixel rule of the port's renders against the JAX package's
PIXEL_RTOL = 3e-6
PIXEL_ATOL = 1e-7
# the host-dependent residue it admits: a share of the values, and its bound
PIXEL_RESIDUE_SHARE = 0.01
PIXEL_RESIDUE_RTOL = 1e-4
# the share of pixels a Moller-Trumbore render may flip on a seam
MT_SEAM_FLIP_SHARE = 0.01


def assert_pixels_close(got, want, seam_flip_share=0.0):
    """A port render's per-pixel accumulators ``got`` (Vec3 of tensors)
    against the JAX package's ``want``: every value within rtol 3e-6 (atol
    1e-7), except at most 1% of the values, which must stay within rtol
    1e-4 but on at most ``seam_flip_share`` of the pixels.

    The exception admits one gap and nothing more: XLA:CPU computes the
    normalize of the camera's and the samplers' directions (1 / sqrt,
    render/camera.py, ops/sampling.py) as the CPU's ``vrsqrtps`` estimate
    refined by one Newton step, and that estimate's bits differ between
    processors, so on some hosts a few directions come out an ulp from the
    correctly rounded ones the port computes. Where a path then cancels,
    the ulp grows: on an AVX-512 Xeon, pixel 22 (Morton) of the 16^2
    ``cornell_with_sphere_mesh(subdiv=2)`` BDPT render (seed 9, 2 spp) has
    its camera direction 1 ulp off in each component, its first hit 1 ulp
    off in y, and the light connection from there (y extent 0.0186) weighs
    1.35e-5 relative more in all three channels. With Moller-Trumbore
    (``seam_flip_share`` = MT_SEAM_FLIP_SHARE) the same ulp can also flip a
    ray's hit on the seam between two triangles, where MT's rounding can
    reject both (tests/test_packets.py:364-376): on that host, pixel 162 of
    every 16^2 pt_nee MT render (seed 9). With the JAX package's normalize
    made correctly rounded, both renders agree with the port's to rtol
    2.2e-7."""
    n = off = 0
    far = None
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        gap = np.abs(a - b)
        off += int((gap > PIXEL_ATOL + PIXEL_RTOL * np.abs(b)).sum())
        f = gap > PIXEL_ATOL + PIXEL_RESIDUE_RTOL * np.abs(b)
        far = f if far is None else far | f
        n += a.size
    assert off <= PIXEL_RESIDUE_SHARE * n, (
        f"{off} of {n} values differ by more than rtol {PIXEL_RTOL}")
    assert int(far.sum()) <= seam_flip_share * far.size, (
        f"pixels {np.flatnonzero(far).tolist()} differ by more than rtol "
        f"{PIXEL_RESIDUE_RTOL}")


@contextlib.contextmanager
def jax_normalize_rounded():
    """The JAX package's ``normalized`` made correctly rounded while
    entered, as the port's is (``vecmath.rsqrt``: 1 / sqrt of the float32
    |a|^2 in float64, rounded once), through ``jax.pure_callback``, in
    every module of the package that imported it. It removes the residue
    ``assert_pixels_close`` admits: XLA:CPU's rsqrt estimate. JAX's
    caches are cleared on entry and on exit, so that no trace made with
    the patch outlives it and none made without it is reused."""
    import jax
    import jax.numpy as jnp

    from cudapathtracer_tpu.ops import vecmath as jv

    original = jv.normalized

    def rsqrt(n2):
        return (1.0 / np.sqrt(np.asarray(n2, np.float64))).astype(np.float32)

    def normalized(a):
        n2 = jv.dot(a, a)
        return a * jax.pure_callback(
            rsqrt, jax.ShapeDtypeStruct(n2.shape, jnp.float32), n2)

    patched = [m for name, m in list(sys.modules.items())
               if name.startswith("cudapathtracer_tpu.")
               and getattr(m, "normalized", None) is original]
    for m in patched:
        m.normalized = normalized
    jax.clear_caches()
    try:
        yield
    finally:
        for m in patched:
            m.normalized = original
        jax.clear_caches()
