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
from torch_fold_cases import colonnade_case, jax_scene, packet_data, shortlists

from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as tdr
from cudapathtracer_tpu_torch.ops.kernels.work import needed_work
from cudapathtracer_tpu_torch.render import renderer as tren


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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_cuda_kernel_matches_plain(kind):
    """On a card: K1 and its plain version agree bit for bit, and the
    wrapper counts the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
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
    folds at most the listed slots and issues at least the tests the rays
    need, in whole warps of C tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    sl, pack, num_tris = colonnade_case(cluster_size, torch.device("cuda"))
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    t, tri = tdr.dense_intersect_resident(*args)
    counts = torch.empty((sl.ids.shape[0], 2), dtype=torch.int64,
                         device="cuda")
    tc, tric = tdr.dense_intersect_resident(*args, counts_out=counts)
    torch.cuda.synchronize()
    assert torch.equal(t, tc) and torch.equal(tri, tric)
    assert bool((counts[:, 0] <= sl.counts).all())
    assert bool((counts[:, 1] % (32 * cluster_size) == 0).all())
    assert needed_work(sl, t, pack, num_tris)[0] <= int(counts[:, 1].sum())
