"""The port's batching knobs against the JAX package's and against the
port's own defaults: the packet engine's straggler rounds
(``trace_packets(rounds=)``, ``first_round_slots``) and windowed ray sort
(``sort_window``) on the cases of tests/test_packets.py:251-350, whose hits
equal brute force's and the JAX package's bit for bit; and the renderer's
``sample_batch``, whose image equals the one-sample-at-a-time image bit for
bit (pt_nee and BDPT, the whole image and a tile through ``idx=``) and the
JAX package's ``sample_batch`` render per pixel
(tests/torch_fold_cases.py:assert_pixels_close)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fold_cases import assert_pixels_close

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
from cudapathtracer_tpu_torch.ops.rng import prng_key
from cudapathtracer_tpu_torch.ops.vecmath import Vec3 as TVec3
from cudapathtracer_tpu_torch.render import renderer as tren


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test process (the suite runs several workers on
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name -> (R, masked, capped, trace_packets knobs): tests/test_packets.py's
# test_windowed_sort_exact (:251), test_t_cap_exact (:309) and
# test_multi_round_splitting_exact (:331)
CASES = {
    "window": (None, False, False, dict(sort_window=256)),
    "window_rounds2": (None, False, False,
                       dict(sort_window=256, rounds=2,
                            first_round_slots=2)),
    "window_masked_nonmultiple": (924, True, False, dict(sort_window=256)),
    "rounds2": (None, False, False, dict(rounds=2, first_round_slots=2)),
    "rounds2_masked_first1": (None, True, False,
                              dict(rounds=2, first_round_slots=1)),
    "rounds3_masked_window": (924, True, False,
                              dict(rounds=3, first_round_slots=1,
                                   sort_window=128)),
    "t_cap_rounds2": (None, False, True, dict(rounds=2,
                                              first_round_slots=2)),
    "t_cap_window_rounds2": (None, False, True,
                             dict(rounds=2, first_round_slots=1,
                                  sort_window=512)),
}


@pytest.fixture(scope="module")
def setup():
    """tests/test_packets.py's fixture: cornell_with_sphere_mesh(subdiv=2)
    at C = 16, 32^2 camera rays; the JAX package's sorted XLA trace of each
    case (tile 64, max_clusters 8), and its brute force."""
    js = jproc.to_scene(jproc.cornell_with_sphere_mesh(subdiv=2))
    accel = build_bvh_for_scene(js, leaf_size=4, cluster_size=16)
    jtd = jtrav.make_trace_data(js, accel.fine)
    jpd = jpk.make_packet_data(
        js, JVec3(accel.cl_lo_x, accel.cl_lo_y, accel.cl_lo_z),
        JVec3(accel.cl_hi_x, accel.cl_hi_y, accel.cl_hi_z), accel.cl_tri)
    idx = jnp.arange(32 * 32, dtype=jnp.uint32)
    keys = pixel_keys(sample_key(jax.random.PRNGKey(0), 0), idx)
    o, d = camera_rays(make_camera(width=32, height=32), idx, keys,
                       jitter=False)
    t_all = np.asarray(jtrav.trace_bruteforce(o, d, js).t)
    ref, inputs = {}, {}
    for name, (n, masked, capped, kw) in CASES.items():
        R = 1024 if n is None else n
        oo, dd = (JVec3(*(c[:R] for c in v)) for v in (o, d))
        mask = (np.arange(R) % 3) != 0 if masked else np.ones(R, bool)
        cap = None
        if capped:
            # half at a fixed 1.5, half exactly at the hit
            cap = np.where(np.arange(R) % 2 == 0, np.float32(1.5),
                           t_all[:R]).astype(np.float32)
        ref[name] = jpk.trace_packets(
            oo, dd, jpd, fine_td=jtd, mask=jnp.asarray(mask), tile_size=64,
            max_clusters=8, engine="xla", sort=True,
            t_cap=None if cap is None else jnp.asarray(cap), **kw)
        inputs[name] = (oo, dd, mask, cap)
    ts = tproc.to_scene(tproc.cornell_with_sphere_mesh(subdiv=2), "cpu")
    ta = convert.accel_from_jax(convert.to_numpy_dict(accel), "cpu")
    tpd = tpk.make_packet_data(
        ts, TVec3(ta.cl_lo_x, ta.cl_lo_y, ta.cl_lo_z),
        TVec3(ta.cl_hi_x, ta.cl_hi_y, ta.cl_hi_z), ta.cl_tri)
    return dict(ref=ref, inputs=inputs, ts=ts, tpd=tpd,
                ttd=ttrav.make_trace_data(ts, ta.fine))


def _tv(v):
    return TVec3(*(torch.from_numpy(np.array(c)) for c in v))


def _trace(setup, name, **kw):
    o, d, mask, cap = setup["inputs"][name]
    return tpk.trace_packets(
        _tv(o), _tv(d), setup["tpd"], fine_td=setup["ttd"],
        mask=torch.from_numpy(mask), tile_size=64, max_clusters=8, sort=True,
        t_cap=None if cap is None else torch.from_numpy(cap), **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_rounds_and_windows_match_jax_and_brute(setup, name):
    """Straggler rounds and windowed sorts: hits equal the JAX package's
    trace_packets with the same knobs and the port's (capped) brute force
    bit for bit, and the default one-round globally sorted trace's."""
    hit = _trace(setup, name, **CASES[name][3])
    ref = setup["ref"][name]
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(hit.t.numpy(), np.asarray(ref.t))
    o, d, mask, cap = setup["inputs"][name]
    brute = ttrav.trace_bruteforce(_tv(o), _tv(d), setup["ts"],
                                   mask=torch.from_numpy(mask))
    if cap is not None:
        brute = ttrav.apply_t_cap(brute, torch.from_numpy(cap))
    np.testing.assert_array_equal(hit.tri.numpy(), brute.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), brute.t.numpy())
    base = _trace(setup, name)
    np.testing.assert_array_equal(hit.tri.numpy(), base.tri.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), base.t.numpy())


def test_rounds_hand_on_only_stragglers(setup, monkeypatch):
    """Each round but the last traces with the budget (first_round_slots,
    4x per round, at most max_clusters) and no fallback; the next round's
    mask is the previous round's ``need``, a subset of its mask, and the
    last round gets the full shortlist and the fallback."""
    seen = []
    orig = tpk._sorted_round

    def spy(o, d, mask, t_cap, window, max_clusters, fine_td, need_out,
            tile):
        out = orig(o, d, mask, t_cap, window, max_clusters, fine_td,
                   need_out, tile)
        seen.append((mask.clone(), max_clusters, fine_td is None, need_out,
                     out[1].clone() if need_out else None))
        return out

    monkeypatch.setattr(tpk, "_sorted_round", spy)
    _trace(setup, "rounds2_masked_first1", rounds=3, first_round_slots=1)
    assert [s[1:4] for s in seen] == [(1, True, True), (4, True, True),
                                      (8, False, False)]
    for (m0, *_, need), (m1, *_) in zip(seen, seen[1:]):
        assert torch.equal(need, m1)
        assert not bool((need & ~m0).any())
    assert 0 < int(seen[-1][0].sum()) < int(seen[0][0].sum())


def test_window_perm():
    """window_perm sorts each window of W on its own, the last one padded
    with the max key (a masked lane's), so pad and masked lanes land at
    their window's end; W = R is the global sort."""
    rng = np.random.default_rng(4)
    R, W = 1000, 256
    key = torch.from_numpy(rng.integers(0, 50, R).astype(np.int32))
    key[::7] = 0x7FFFFFFF
    perm = tpk.window_perm(key, W)
    Rw = 1024
    assert perm.shape == (Rw,)
    assert sorted(perm.tolist()) == list(range(Rw))
    padded = torch.cat([key, key.new_full((Rw - R,), 0x7FFFFFFF)])
    for w in range(Rw // W):
        seg = perm[w * W:(w + 1) * W]
        assert bool(((seg >= w * W) & (seg < (w + 1) * W)).all())
        ks = padded[seg]
        assert bool((ks[1:] >= ks[:-1]).all())
    glob = tpk.window_perm(key, R)
    assert torch.equal(key[glob], torch.sort(key).values)


@pytest.mark.parametrize("window,applies", [(256, True), (96, False),
                                            (1024, False), (0, False)])
def test_window_only_where_it_applies(setup, monkeypatch, window, applies):
    """The window takes effect only where W > 0, W % tile_size == 0 and
    R > W (JAX packets.py:418-419); else the sort is global. Hits are
    the same either way."""
    widths = []
    orig = tpk.window_perm

    def spy(key, W):
        widths.append(W)
        return orig(key, W)

    monkeypatch.setattr(tpk, "window_perm", spy)
    hit = _trace(setup, "window", sort_window=window)
    assert widths == [window if applies else 1024]
    base = setup["ref"]["window"]
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(base.tri))


# ---- sample_batch -----------------------------------------------------------
SB_SIZE = 16
SB_SPP = 5
SB_S = 4


def _sb_cfg(pkg, integrator, S, **kw):
    return pkg.RenderConfig(width=SB_SIZE, height=SB_SIZE, spp=SB_SPP,
                            integrator=integrator, samples_per_call=SB_SPP,
                            sample_batch=S, **kw)


@pytest.fixture(scope="module")
def sb_scene():
    scene = tproc.to_scene(tproc.cornell_with_sphere_mesh(subdiv=1), "cpu")
    return scene, tren.build_bvh_for_scene(scene, 4)


@pytest.mark.parametrize("integrator", ["pt_nee", "bdpt"])
@pytest.mark.parametrize("tile", [False, True])
def test_sample_batch_equals_one_sample_at_a_time(sb_scene, integrator,
                                                  tile):
    """S = 4 over 5 samples (one group of 4, then one alone) renders the
    S = 1 image bit for bit, the whole image and a Morton tile through
    ``idx=``, with the primary hit reused."""
    scene, bvh = sb_scene
    cam = T.make_camera(width=SB_SIZE, height=SB_SIZE, device="cpu")
    idx = torch.arange(64, 192) if tile else None
    n = None if idx is None else idx.shape[0]
    imgs = []
    for S in (1, SB_S):
        cfg = _sb_cfg(T, integrator, S, reuse_primary_hit=True)
        st = tren.render_batch(scene, bvh, cam, cfg, prng_key(7, "cpu"),
                               T.init_accum(cfg, device="cpu",
                                            num_pixels=n), SB_SPP, idx=idx)
        assert st.n == SB_SPP
        imgs.append(torch.stack(list(st.img) + list(st.comp)))
    assert torch.equal(imgs[0].view(torch.int32), imgs[1].view(torch.int32))
    assert float(imgs[0].max()) > 0


def test_sample_batch_groups(sb_scene, monkeypatch):
    """5 samples at S = 4 make two radiance calls, over 4 R and then R
    rays, keyed on the samples' global indices in order."""
    scene, bvh = sb_scene
    sizes = []
    orig = tren._radiance

    def spy(o, d, *a, **kw):
        sizes.append(o.x.shape[0])
        return orig(o, d, *a, **kw)

    monkeypatch.setattr(tren, "_radiance", spy)
    cfg = _sb_cfg(T, "pt_nee", SB_S)
    T.render(scene, T.make_camera(width=SB_SIZE, height=SB_SIZE,
                                  device="cpu"), cfg, seed=3, bvh=bvh,
             device="cpu")
    R = SB_SIZE * SB_SIZE
    assert sizes == [SB_S * R, R]


@pytest.fixture(scope="module")
def jax_sample_batch():
    """The JAX package's sample_batch = 4 renders of the same scene, 16^2, 5
    spp, seed 9, pt_nee and BDPT."""
    js = jproc.to_scene(jproc.cornell_with_sphere_mesh(subdiv=1))
    cam = make_camera(width=SB_SIZE, height=SB_SIZE)
    return {i: J.render(js, cam, _sb_cfg(J, i, SB_S), seed=9)
            for i in ("pt_nee", "bdpt")}


@pytest.mark.parametrize("integrator", ["pt_nee", "bdpt"])
def test_sample_batch_matches_jax(sb_scene, jax_sample_batch, integrator):
    """sample_batch = 4 renders the JAX package's sample_batch = 4 image per
    pixel (the render tests' rule)."""
    scene, bvh = sb_scene
    got = T.render(scene, T.make_camera(width=SB_SIZE, height=SB_SIZE,
                                        device="cpu"),
                   _sb_cfg(T, integrator, SB_S), seed=9, bvh=bvh,
                   device="cpu")
    want = jax_sample_batch[integrator]
    assert got.n == int(want.n) == SB_SPP
    assert_pixels_close(got.img, want.img)
