"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's three render paths (PT+NEE through the packet engine and
its CUDA kernels K1, K2 and K3) at the JAX bench's sizes and checks them:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: K1, K2, K3 (nvcc, sm_90a) and the native BVH builder, all
   started together, timed;
3. K1 against its plain version at the headline shapes (the primary batch
   and a sorted bounce batch of a real pt_nee sample): differing ids, the
   largest relative and absolute t gaps, both times, and K1's bound;
4. fallback: 64x64 primary rays of the headline scene through the packet
   engine with a one-cluster shortlist, so the fine-BVH fallback runs on
   the card; the hits must equal brute force's;
5. golden: a 64x64, 16 spp Cornell render on the card against
   tests/goldens/cornell_pt_nee_64_spp16.ppm, under the golden tests' rule;
6. headline (resident route, K1): colonnade subdiv 3 (20,884 triangles),
   1024x1024, 3 bounces: one warm-up window, then HEADLINE_WINDOWS timed
   windows of 4 spp each. The rate is that of all timed windows together;
7. stream route (K2): colonnade subdiv 6 (1,311,124 triangles, adaptive
   C = 1024, flat cull). K2 against its plain version on SAMPLE_TILES tiles
   spread over the primary and a sorted bounce batch, K2 against K1 bit for
   bit on the full batches with both timed, one sample's trace calls, and
   PATH_WINDOWS timed 1024^2 windows of PATH_SPP spp after a warm-up;
8. super route (K3): colonnade subdiv 5 (328,084 triangles), C = 256,
   two_level_cull="super", super_factor 8, super_list 255: the same steps,
   with K1 on the flat shortlists of the same rays beside K3.

Each render path runs with every kernel's launch count and every plain
version's call count set to 0 just before its timed windows and read just
after; the path's kernel must have launched and nothing else may have run.
A kernel's bound is the larger of the bytes its inputs need over the card's
memory rate and the float32 operations of the ray-triangle tests they need
over its float32 rate (``needed_work``). Each phase prints lines of its own;
any failure raises. The line before the last is a JSON summary of the
kernels, the last line the device record.

Run: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "goldens", "cornell_pt_nee_64_spp16.ppm")
HEADLINE_SIZE = 1024
HEADLINE_SPP = 4
HEADLINE_WINDOWS = 5
PATH_SPP = 2
PATH_WINDOWS = 5
SAMPLE_TILES = 512
FALLBACK_SIZE = 64
# kernel vs plain: ids may differ only on exact-t ties, as the JAX
# package's own engines do
ID_MISMATCH_MAX = 1e-5
T_RTOL = 1e-6
# one H100 SXM (its data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations of one Baldwin-Weber ray-triangle test, an FMA as 2
OPS_PER_TEST = 35


def check_golden(img, path, tol=2, max_frac=0.005):
    """tests/test_goldens.py:_check's rule on an (H, W, 3) u8 image before
    the writer's x flip: under 0.5% of channels may differ by more than 2."""
    from cudapathtracer_tpu_torch.utils.ppm import read_ppm

    gold = read_ppm(path).astype(np.int32)
    img = img[:, ::-1].astype(np.int32)
    if img.shape != gold.shape:
        raise AssertionError(f"golden shape {gold.shape}, got {img.shape}")
    frac = float((np.abs(img - gold) > tol).mean())
    if frac >= max_frac:
        raise AssertionError(f"{frac:.4%} of channels differ by more than "
                             f"{tol} from {os.path.basename(path)}")
    return frac


def cuda_ms(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn):
    """(result, ms) of one synchronized run of ``fn()``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def agreement(label, got, want, rays):
    """Differing ids among live rays and the t gaps where ids agree; raises
    past ID_MISMATCH_MAX or T_RTOL. -> (differing, max_abs_dt)."""
    (t_k, i_k), (t_p, i_p) = got, want
    live = rays[:, 6] > 0.5
    differ = int(((i_k != i_p) & live).sum())
    n_live = int(live.sum())
    same = (i_k == i_p) & live & (i_k >= 0)
    gap = (t_k - t_p).abs()[same]
    rel = gap / t_p.abs()[same]
    max_abs = float(gap.max()) if gap.numel() else 0.0
    max_rel = float(rel.max()) if rel.numel() else 0.0
    print(f"{label}: live_rays={n_live} differing_ids={differ} "
          f"max_rel_dt={max_rel:.3g} max_abs_dt={max_abs:.3g}")
    if differ > ID_MISMATCH_MAX * n_live:
        raise AssertionError(f"{label}: {differ} of {n_live} ids differ")
    if max_rel > T_RTOL:
        raise AssertionError(f"{label}: t differs by {max_rel} relative")
    return differ, max_abs


def needed_work(sl, t_final, pack, num_tris, F=None):
    """What these inputs need of a kernel, as a lower bound: the
    ray-triangle tests (each live ray against each real triangle of each
    listed cluster, or member of a listed super, whose box the ray enters
    at or before its final t) and the bytes (the rays, counts, listed ids
    and entries, the rows, ids and box of each cluster a needed test
    touches, and the outputs). -> (tests, touched clusters, bytes)."""
    packed, tri, boxes = pack
    K1, _, C = packed.shape
    K = K1 - 1
    real = (tri < num_tris).sum(dim=1)                  # (K+1,)
    Tl, M = sl.ids.shape
    P = sl.rays.shape[2]
    live = sl.rays[:, 6] > 0.5
    o = sl.rays[:, 0:3]
    d = sl.rays[:, 3:6]
    inv = 1.0 / torch.where(d.abs() < 1e-30,
                            torch.where(d < 0, -1e-30, 1e-30), d)
    n_max = int(sl.counts.max()) if Tl else 0
    width = n_max * (F or 1)
    tests = 0
    touched = torch.zeros(K1, dtype=torch.bool, device=packed.device)
    step = max(1, (1 << 24) // max(1, width * P))
    for a in range(0, Tl if n_max else 0, step):
        b = min(Tl, a + step)
        ids = sl.ids[a:b, :n_max].long()
        ok = (torch.arange(n_max, device=ids.device)[None, :]
              < sl.counts[a:b, None])
        if F is not None:
            j = torch.arange(F, device=ids.device)
            ids = torch.clamp(ids[:, :, None] * F + j, max=K).flatten(1)
            ok = ok.repeat_interleave(F, dim=1)
        bx = boxes[ids]                                 # (n, width, 6)
        lo = [(bx[:, :, k, None] - o[a:b, None, k]) * inv[a:b, None, k]
              for k in range(3)]
        hi = [(bx[:, :, 3 + k, None] - o[a:b, None, k]) * inv[a:b, None, k]
              for k in range(3)]
        tmin = torch.maximum(torch.maximum(torch.minimum(lo[0], hi[0]),
                                           torch.minimum(lo[1], hi[1])),
                             torch.minimum(lo[2], hi[2]))
        tmax = torch.minimum(torch.minimum(torch.maximum(lo[0], hi[0]),
                                           torch.maximum(lo[1], hi[1])),
                             torch.maximum(lo[2], hi[2]))
        need = ((tmin <= tmax) & (tmax >= 0) & (tmin <= t_final[a:b, None])
                & live[a:b, None] & ok[:, :, None])     # (n, width, P)
        per_cluster = need.sum(dim=2)
        tests += int((per_cluster * real[ids]).sum())
        touched[ids[per_cluster > 0]] = True
        del lo, hi, tmin, tmax, need
    n_touched = int(touched[:K].sum())
    nbytes = (sl.rays.numel() * 4 + Tl * 4 + int(sl.counts.sum()) * 8
              + n_touched * ((12 + 1) * C * 4 + 6 * 4) + Tl * P * 8)
    return tests, n_touched, nbytes


def bound(tests, nbytes):
    """(bound ms, "bytes" or "operations") on one H100."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = tests * OPS_PER_TEST / PEAK_F32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def sample_tiles(sl, n):
    """The shortlists of about n tiles spread evenly over the batch."""
    Tl = sl.ids.shape[0]
    idx = torch.unique(torch.linspace(0, Tl - 1, min(n, Tl),
                                      device=sl.ids.device).round().long())
    return type(sl)(*(a[idx].contiguous() for a in sl))


def record_batches(scene, trace_fn, cam, cfg, base_key):
    """The primary and first bounce batches of one pt_nee sample, as the
    renderer's trace closure receives them."""
    from cudapathtracer_tpu_torch.integrators.pt_nee import radiance_pt_nee
    from cudapathtracer_tpu_torch.ops.rng import pixel_keys, sample_key
    from cudapathtracer_tpu_torch.render.camera import camera_rays

    dev = cam.pos.x.device
    idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    calls = []

    def recording(o, d, mask):
        calls.append((o, d, mask))
        return trace_fn(o, d, mask)

    keys = pixel_keys(sample_key(base_key, 0), idx)
    o0, d0 = camera_rays(cam, idx, keys, lens=False)
    radiance_pt_nee(o0, d0, scene, recording, keys)
    return {"primary": calls[0], "bounce1": calls[1]}


def sorted_shortlists(batch, pd, P, cfg, super_factor=None):
    """Sort one batch's rays as the packet engine does and build its
    shortlists (in super units with ``super_factor``)."""
    from cudapathtracer_tpu_torch.ops import packets
    from cudapathtracer_tpu_torch.ops.vecmath import Vec3

    o, d, mask = batch
    perm = packets.sort_rays(o, d, mask, pd)
    return packets.build_shortlists(
        Vec3(o.x[perm], o.y[perm], o.z[perm]),
        Vec3(d.x[perm], d.y[perm], d.z[perm]), mask[perm], pd, P,
        cfg.max_clusters, super_factor=super_factor,
        super_list=cfg.super_list)


def trace_breakdown(label, scene, trace_fn, cam, cfg, base_key):
    """One sample (primary trace included) with every trace call timed
    between synchronizes, against the sample's wall time."""
    from cudapathtracer_tpu_torch.integrators.pt_nee import radiance_pt_nee
    from cudapathtracer_tpu_torch.ops.rng import pixel_keys, sample_key
    from cudapathtracer_tpu_torch.render.camera import camera_rays

    dev = cam.pos.x.device
    idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    trace_ms = []

    def timed(o, d, mask):
        h, ms = host_ms(lambda: trace_fn(o, d, mask))
        trace_ms.append(ms)
        return h

    def one_sample():
        keys = pixel_keys(sample_key(base_key, 0), idx)
        o0, d0 = camera_rays(cam, idx, keys, lens=False)
        primary = timed(o0, d0, torch.ones(idx.shape, dtype=torch.bool,
                                           device=dev))
        return radiance_pt_nee(o0, d0, scene, timed, keys,
                               primary_hit=primary)

    _, wall = host_ms(one_sample)
    print(f"{label}: sample trace_calls={len(trace_ms)} trace_ms="
          f"{[round(m, 3) for m in trace_ms]} trace_total_ms="
          f"{sum(trace_ms):.3f} sample_wall_ms={wall:.3f} (synchronize "
          "after every trace call)")


def render_windows(label, kernels, expect, run, cfg, spp, windows):
    """One warm-up window, then ``windows`` timed ones with every count at
    0 before them; the image must be finite and lit, ``expect`` must have
    launched and nothing else may have run. -> launches of ``expect``."""
    run()
    torch.cuda.synchronize()
    for _, wrapper, plain in kernels.values():
        wrapper.launches = 0
        plain.calls = 0
    walls = []
    for _ in range(windows):
        t0 = time.perf_counter()
        st = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {n: w.launches for n, (_, w, _) in kernels.items()}
    plain_calls = sum(p.calls for _, _, p in kernels.values())
    img = np.stack([c.cpu().numpy() for c in st.img], axis=1)
    finite = bool(np.isfinite(img).all())
    rays = cfg.num_pixels * spp * (cfg.num_bounces + 1)
    dt = sum(walls)
    print(f"{label}: {cfg.width}x{cfg.height} spp={spp} "
          f"bounces={cfg.num_bounces} windows={windows} "
          f"window_seconds={[round(w, 4) for w in walls]} "
          f"mrays_per_s={rays * windows / dt / 1e6:.3f} "
          f"window_mrays_per_s_min={rays / max(walls) / 1e6:.3f} "
          f"max={rays / min(walls) / 1e6:.3f} image_max={img.max():.4f} "
          f"finite={finite} "
          + " ".join(f"{n}_launches={v}" for n, v in launches.items())
          + f" launches_per_sample={launches[expect] / (windows * spp):.2f}"
          f" plain_calls={plain_calls}")
    if img.shape != (cfg.num_pixels, 3) or not finite or img.max() <= 0:
        raise AssertionError(f"{label}: image is not finite and lit")
    others = sum(v for n, v in launches.items() if n != expect)
    if launches[expect] <= 0 or others or plain_calls:
        raise AssertionError(f"{label}: the path did not run through "
                             f"{expect} alone")
    return launches[expect]


def kernel_entry(name, source, replaces, launches, max_abs, ms, plain_ms,
                 bnd, tiles, plain_tiles):
    return {"name": name, "route": "cuda",
            "source": f"cudapathtracer_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "tiles": tiles, "plain_tiles": plain_tiles}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {smi}")

    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch.accel import native
    from cudapathtracer_tpu_torch.models import procedural
    from cudapathtracer_tpu_torch.ops import packets, traversal
    from cudapathtracer_tpu_torch.ops.kernels import dense as k2
    from cudapathtracer_tpu_torch.ops.kernels import dense_resident as k1
    from cudapathtracer_tpu_torch.ops.kernels import dense_super as k3
    from cudapathtracer_tpu_torch.ops.rng import (pixel_keys, prng_key,
                                                  sample_key)
    from cudapathtracer_tpu_torch.render import renderer
    from cudapathtracer_tpu_torch.render.camera import camera_rays

    kernels = {
        "k1": (k1.build, k1.dense_intersect_resident,
               k1.dense_intersect_resident_plain),
        "k2": (k2.build, k2.dense_intersect, k2.dense_intersect_plain),
        "k3": (k3.build, k3.dense_intersect_super,
               k3.dense_intersect_super_plain),
    }

    # ---- 2. build: every nvcc and the BVH builder at once ------------------
    def timed_build(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        futs = {n: pool.submit(timed_build, b)
                for n, (b, _, _) in kernels.items()}
        futs["bvh_builder"] = pool.submit(timed_build, native.load)
        build_s = {n: f.result() for n, f in futs.items()}
    print("build: " + " ".join(f"{n}_s={s:.2f}" for n, s in build_s.items())
          + f" wall_s={time.perf_counter() - t0:.2f}")

    base_key = prng_key(1234, dev)

    def setup(label, subdiv, spp, **cfg_kw):
        size = HEADLINE_SIZE
        scene = procedural.to_scene(procedural.colonnade(subdiv=subdiv), dev)
        cfg = cpt.RenderConfig(width=size, height=size, spp=spp,
                               integrator="pt_nee", samples_per_call=spp,
                               reuse_primary_hit=True, **cfg_kw)
        t0 = time.perf_counter()
        bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size,
                                           cluster_size=cfg.cluster_size)
        prep = renderer.make_packet_prep(scene, bvh)
        torch.cuda.synchronize()
        t_accel = time.perf_counter() - t0
        cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                              focal_length=2.0, device=dev)
        pd = prep.pdata
        P = renderer.resolve_tile_size(cfg, scene.num_tris)
        kern = packets.route(pd.num_clusters, pd.cluster_size,
                             cfg.two_level_cull, cfg.super_factor)
        print(f"{label}: scene tris={scene.num_tris} clusters="
              f"{pd.num_clusters} C={pd.cluster_size} P={P} route={kern} "
              f"accel_s={t_accel:.2f}")
        trace_fn = renderer.make_trace_fn(scene, cfg, bvh, prep=prep)

        def window():
            return cpt.render_batch(scene, bvh, cam, cfg, base_key,
                                    cpt.init_accum(cfg, device=dev), spp,
                                    prep=prep)

        return scene, cfg, bvh, prep, cam, P, kern, trace_fn, window

    # ---- headline scene ----------------------------------------------------
    (scene, cfg, bvh, prep, cam, P, kern, trace_fn,
     window) = setup("headline", 3, HEADLINE_SPP)
    pd = prep.pdata
    if kern != "resident":
        raise AssertionError(f"headline route {kern}, expected resident")

    # ---- 3. K1 vs plain at the headline shapes -----------------------------
    batches = record_batches(scene, trace_fn, cam, cfg, base_key)
    max_abs = 0.0
    for name, batch in batches.items():
        sl = sorted_shortlists(batch, pd, P, cfg)
        args = (sl.ids, sl.counts, sl.entries, sl.rays, *prep.resident_pack)
        got = k1.dense_intersect_resident(*args)
        k1_ms = cuda_ms(lambda: k1.dense_intersect_resident(*args), 5)
        want, k1_plain_ms = host_ms(
            lambda: k1.dense_intersect_resident_plain(*args))
        _, gap = agreement(f"kernel[{name}] k1 vs plain", got, want, sl.rays)
        max_abs = max(max_abs, gap)
        tests, touched, nbytes = needed_work(sl, got[0], prep.resident_pack,
                                             scene.num_tris)
        k1_bound = bound(tests, nbytes)
        k1_tiles = sl.ids.shape[0]
        print(f"kernel[{name}]: tiles={k1_tiles} slots={sl.ids.shape[1]} "
              f"mean_count={float(sl.counts.float().mean()):.2f} "
              f"k1_ms={k1_ms:.4f} plain_ms={k1_plain_ms:.1f} tests={tests} "
              f"clusters_touched={touched} bytes={nbytes} "
              f"bound_ms={k1_bound[0]:.4f} bound_by={k1_bound[1]}")
    k1_max_abs = max_abs      # the JSON line keeps the bounce batch's times

    # ---- 4. fine-BVH fallback on the card ----------------------------------
    fs = FALLBACK_SIZE
    fidx = torch.arange(fs * fs, dtype=torch.int64, device=dev)
    fcam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=fs, height=fs,
                           focal_length=2.0, device=dev)
    fo, fd = camera_rays(fcam, fidx, pixel_keys(sample_key(base_key, 0),
                                                fidx), lens=False)
    fmask = torch.ones(fs * fs, dtype=torch.bool, device=dev)
    hit = packets.trace_packets(
        fo, fd, pd, fine_td=traversal.make_trace_data(scene, bvh.fine),
        mask=fmask, tile_size=P, max_clusters=1,
        resident_pack=prep.resident_pack)
    brute = traversal.trace_bruteforce(fo, fd, scene)
    # unsorted, so the tiles are those of build_shortlists in ray order; a
    # ray took the fallback exactly when its final t is not below U
    u = packets.build_shortlists(fo, fd, fmask, pd, P, 1).U
    n_fb = int((hit.t >= u.repeat_interleave(P)[:fs * fs]).sum())
    id_bad = int((hit.tri != brute.tri).sum())
    t_bad = int((hit.t != brute.t).sum())
    print(f"fallback: rays={fs * fs} max_clusters=1 fallback_rays={n_fb} "
          f"id_mismatches={id_bad} t_mismatches={t_bad}")
    if n_fb == 0 or id_bad or t_bad:
        raise AssertionError("the fallback did not run, or its hits differ "
                             "from brute force")

    # ---- 5. golden on the card ---------------------------------------------
    gcfg = cpt.RenderConfig(width=64, height=64, spp=16,
                            integrator="pt_nee", samples_per_call=16)
    gst = cpt.render(procedural.to_scene(procedural.cornell_box(), dev),
                     cpt.make_camera(width=64, height=64, device=dev), gcfg,
                     seed=1234, device=dev)
    frac = check_golden(cpt.finalize_image(gst, gcfg), GOLDEN)
    print(f"golden: cornell_pt_nee_64_spp16 channels_off_by_more_than_2="
          f"{frac:.4%} (limit 0.5%)")

    # ---- 6. headline -------------------------------------------------------
    k1_launches = render_windows("headline", kernels, "k1", window, cfg,
                                 HEADLINE_SPP, HEADLINE_WINDOWS)
    entries = [kernel_entry(
        "dense_resident", "dense_resident.cu",
        "cudapathtracer_tpu/ops/pallas/dense_resident.py:999", k1_launches,
        k1_max_abs, k1_ms, k1_plain_ms, k1_bound, k1_tiles, k1_tiles)]
    del scene, bvh, prep, trace_fn, window, batches

    # ---- 7. / 8. the stream and super routes -------------------------------
    for label, subdiv, cfg_kw, want, name, source, replaces in (
            ("stream", 6, {}, "k2", "dense", "dense.cu",
             "cudapathtracer_tpu/ops/pallas/dense.py:343"),
            ("super", 5, dict(cluster_size=256, two_level_cull="super",
                              super_factor=8, super_list=255), "k3",
             "dense_super", "dense_super.cu",
             "cudapathtracer_tpu/ops/pallas/dense_resident.py:913")):
        (scene, cfg, bvh, prep, cam, P, kern, trace_fn,
         window) = setup(label, subdiv, PATH_SPP, **cfg_kw)
        pd = prep.pdata
        if kern != label:
            raise AssertionError(f"{label} path took the {kern} route")
        F = cfg.super_factor if label == "super" else None
        _, wrapper, plain = kernels[want]
        extra = (F,) if F else ()
        batches = record_batches(scene, trace_fn, cam, cfg, base_key)
        max_abs = 0.0
        for bname, batch in batches.items():
            sl, sl_ms = host_ms(lambda: sorted_shortlists(
                batch, pd, P, cfg, super_factor=F))
            args = (sl.ids, sl.counts, sl.entries, sl.rays,
                    *prep.resident_pack)
            got = wrapper(*args, *extra)
            ms = cuda_ms(lambda: wrapper(*args, *extra), 3)
            # K1 beside it on the same rays: the same shortlists on the
            # stream route, the flat ones on the super route
            flat = sorted_shortlists(batch, pd, P, cfg) if F else sl
            fargs = (flat.ids, flat.counts, flat.entries, flat.rays,
                     *prep.resident_pack)
            ref = k1.dense_intersect_resident(*fargs)
            k1_full_ms = cuda_ms(lambda: k1.dense_intersect_resident(*fargs),
                                 3)
            same = (torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1]))
            n_diff = int((got[1] != ref[1]).sum())
            print(f"kernel[{label}/{bname}]: {want} vs k1 on all "
                  f"{sl.ids.shape[0]} tiles: bit_identical={same} "
                  f"differing_ids={n_diff} {want}_ms={ms:.4f} "
                  f"k1_ms={k1_full_ms:.4f} (k1 on the "
                  f"{'flat' if F else 'same'} shortlists)")
            # K2 folds exactly K1's slots in K1's order; K3 and K1 fold
            # different lists, each exact against the plain fold
            if label == "stream" and not same:
                raise AssertionError(f"{want} and K1 differ on {label}")
            part = sample_tiles(sl, SAMPLE_TILES)
            pargs = (part.ids, part.counts, part.entries, part.rays,
                     *prep.resident_pack)
            want_p, plain_ms = host_ms(lambda: plain(*pargs, *extra))
            _, gap = agreement(
                f"kernel[{label}/{bname}] {want} vs plain on "
                f"{part.ids.shape[0]} sampled tiles",
                wrapper(*pargs, *extra), want_p, part.rays)
            max_abs = max(max_abs, gap)
            tests, touched, nbytes = needed_work(
                sl, got[0], prep.resident_pack, scene.num_tris, F)
            bnd = bound(tests, nbytes)
            print(f"kernel[{label}/{bname}]: tiles={sl.ids.shape[0]} "
                  f"slots={sl.ids.shape[1]} "
                  f"mean_count={float(sl.counts.float().mean()):.2f} "
                  f"{want}_ms={ms:.4f} plain_ms={plain_ms:.1f} "
                  f"(on {part.ids.shape[0]} tiles) sort_cull_topk_ms="
                  f"{sl_ms:.3f} tests={tests} "
                  f"clusters_touched={touched} bytes={nbytes} "
                  f"bound_ms={bnd[0]:.4f} bound_by={bnd[1]}")
        trace_breakdown(label, scene, trace_fn, cam, cfg, base_key)
        launches = render_windows(label, kernels, want, window, cfg,
                                  PATH_SPP, PATH_WINDOWS)
        entries.append(kernel_entry(name, source, replaces, launches,
                                    max_abs, ms, plain_ms, bnd,
                                    sl.ids.shape[0], part.ids.shape[0]))
        del scene, bvh, prep, trace_fn, window, batches, sl, flat, part
        torch.cuda.empty_cache()

    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
