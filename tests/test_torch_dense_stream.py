"""K2, the stream kernel (cudapathtracer_tpu_torch/ops/kernels/dense.py),
and the packet engine's stream route.

Its plain version is held against the JAX package's Pallas kernel
dense_intersect(..., bw=True, interpret=True) on identical shortlists, at
C = 128 as in tests/test_packets.py:206-248: triangle ids exactly, t to
rtol 1e-6 / atol 1e-6 (tests/test_packets.py:247). trace_packets, forced
onto the stream route by shrinking the port's copy of the resident budget
(as tests/test_packets.py:240 shrinks the JAX package's), equals brute force
and the JAX package's trace_packets(engine="pallas_interpret") exactly.

The CUDA kernel runs only on a card: its cases are marked ``cuda`` and skip
elsewhere. The JAX package is imported only by the cases that compare
against it, so the CUDA cases also run where JAX is not installed:
``python -m pytest -o addopts="" --noconftest -m cuda
tests/test_torch_dense_stream.py``."""

import numpy as np
import pytest
import torch
from torch_fold_cases import jax_scene, packet_data, rays, shortlists, tv

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import packets as tpk
from cudapathtracer_tpu_torch.ops import traversal as ttrav
from cudapathtracer_tpu_torch.ops.kernels import dense as tk2
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as tk1
from cudapathtracer_tpu_torch.render import renderer as tren
from cudapathtracer_tpu_torch.render.camera import camera_rays


@pytest.fixture(scope="module")
def scene():
    return jax_scene(subdiv=2)


@pytest.mark.parametrize("kind,sort", [("camera", False), ("camera", True),
                                       ("random", True)])
def test_plain_matches_pallas_interpret(scene, kind, sort):
    sl = shortlists(scene["tpd"], kind, sort)
    assert int(sl.counts.max()) >= 2
    t, tri = tk2.dense_intersect_plain(sl.ids, sl.counts, sl.entries,
                                       sl.rays, *scene["pack"])
    jnp = scene["jnp"]
    jt, jtri = scene["jd"].dense_intersect(
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


@pytest.mark.parametrize("masked", [False, True])
def test_trace_packets_stream_route(scene, monkeypatch, masked):
    """The stream route, forced on a resident-eligible scene, equals brute
    force and the JAX package's DMA-kernel route exactly."""
    jnp, JVec3 = scene["jnp"], scene["JVec3"]
    o, d, mask = rays("camera")
    if not masked:
        mask = np.ones_like(mask)
    kw = dict(tile_size=64, max_clusters=4, sort=True)
    monkeypatch.setattr(tk1, "RESIDENT_VMEM_BUDGET", 1024)
    tpd = scene["tpd"]
    assert tpk.route(tpd.num_clusters, tpd.cluster_size) == "stream"
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
                                   mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(hit.tri.numpy(), brute.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), brute.t.numpy())
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(hit.t.numpy(), np.asarray(ref.t))
    assert (hit.tri.numpy() >= 0).sum() > 100


@pytest.mark.cuda
@pytest.mark.parametrize("cluster_size", [128, 512, 1024])
def test_cuda_kernel_matches_plain_and_k1(cluster_size):
    """On a card: K2 equals its plain version and K1 bit for bit, at
    cluster widths of one to four 256-triangle chunks, and the wrapper
    counts the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    ts = tproc.to_scene(tproc.colonnade(subdiv=3), "cpu")
    tpd = packet_data(
        tren.build_bvh_for_scene(ts, 4, cluster_size=cluster_size), ts)
    cam = T.make_camera(pos=(0.0, 2.0, 3.4), width=32, height=32,
                        focal_length=2.0, device="cpu")
    o, d = camera_rays(cam, torch.arange(32 * 32), None, lens=False)
    mask = torch.arange(32 * 32) % 7 != 0
    perm = tpk.sort_rays(o, d, mask, tpd)
    sl = tpk.build_shortlists(o.map(lambda c: c[perm]),
                              d.map(lambda c: c[perm]), mask[perm], tpd,
                              128, 4095)
    args = [a.to(dev) for a in (sl.ids, sl.counts, sl.entries, sl.rays,
                                *tk1.pack_clusters(tpd))]
    n = tk2.dense_intersect.launches
    t, tri = tk2.dense_intersect(*args)
    torch.cuda.synchronize()
    assert tk2.dense_intersect.launches == n + 1
    for want in (tk2.dense_intersect_plain(*args),
                 tk1.dense_intersect_resident(*args)):
        np.testing.assert_array_equal(tri.cpu().numpy(), want[1].cpu().numpy())
        np.testing.assert_array_equal(t.cpu().numpy(), want[0].cpu().numpy())
    assert (tri >= 0).sum() > 100
