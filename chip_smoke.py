"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's main path (a PT+NEE render through the packet engine and
its CUDA kernel K1) at the bench's headline size and checks it:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: K1 (nvcc, sm_90a) and the native BVH builder, timed;
3. K1 against its plain PyTorch version at the headline shapes (the primary
   batch and a sorted bounce batch of a real pt_nee sample): differing ids,
   the largest relative and absolute t gaps, and both times;
4. fallback: 64x64 primary rays of the headline scene through the packet
   engine with a one-cluster shortlist, so the fine-BVH fallback runs on
   the card; the hits must equal brute force's;
5. golden: a 64x64, 16 spp Cornell render on the card against
   tests/goldens/cornell_pt_nee_64_spp16.ppm, under the golden tests' rule;
6. headline: colonnade subdiv 3 (20,884 triangles), 1024x1024, 3 bounces:
   one warm-up window, then HEADLINE_WINDOWS timed windows of 4 spp each,
   with K1's launch count over the timed windows. The rate is that of all
   timed windows together; each window's seconds are printed too.

Each phase prints one line; any failure raises. The line before the last is
a JSON summary of the kernels, the last line the device record.

Run: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "goldens", "cornell_pt_nee_64_spp16.ppm")
HEADLINE_SIZE = 1024
HEADLINE_SPP = 4
HEADLINE_WINDOWS = 5
FALLBACK_SIZE = 64
# K1 vs plain: ids may differ only on exact-t ties (CLAUDE.md:71-72)
ID_MISMATCH_MAX = 1e-5
T_RTOL = 1e-6


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


def compare_kernel(name, sl, pack, K1, plain):
    """K1 vs its plain version on one batch's shortlists."""
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    t_k, i_k = K1(*args)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: K1(*args), 5)
    t0 = time.perf_counter()
    t_p, i_p = plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    live = sl.rays[:, 6] > 0.5
    differ = int(((i_k != i_p) & live).sum())
    n_live = int(live.sum())
    same = (i_k == i_p) & live & (i_k >= 0)
    gap = (t_k - t_p).abs()[same]
    rel = gap / t_p.abs()[same]
    max_abs = float(gap.max()) if gap.numel() else 0.0
    max_rel = float(rel.max()) if rel.numel() else 0.0
    print(f"kernel[{name}]: tiles={sl.ids.shape[0]} slots={sl.ids.shape[1]} "
          f"live_rays={n_live} mean_count={float(sl.counts.float().mean()):.2f}"
          f" differing_ids={differ} max_rel_dt={max_rel:.3g} "
          f"max_abs_dt={max_abs:.3g} k1_ms={ms:.4f} plain_ms={plain_ms:.1f}")
    if differ > ID_MISMATCH_MAX * n_live:
        raise AssertionError(f"{differ} of {n_live} ids differ")
    if max_rel > T_RTOL:
        raise AssertionError(f"t differs by {max_rel} relative")
    return max_abs, ms, plain_ms


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
          f"{torch.version.cuda}")

    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch.accel import native
    from cudapathtracer_tpu_torch.integrators.pt_nee import radiance_pt_nee
    from cudapathtracer_tpu_torch.models import procedural
    from cudapathtracer_tpu_torch.ops import packets, traversal
    from cudapathtracer_tpu_torch.ops.kernels import dense_resident as k1
    from cudapathtracer_tpu_torch.ops.rng import (pixel_keys, prng_key,
                                                  sample_key)
    from cudapathtracer_tpu_torch.ops.vecmath import Vec3
    from cudapathtracer_tpu_torch.render import renderer
    from cudapathtracer_tpu_torch.render.camera import camera_rays

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    k1.build()
    t_k1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load()
    t_bvh = time.perf_counter() - t0
    print(f"build: k1_s={t_k1:.2f} bvh_builder_s={t_bvh:.2f}")

    # ---- headline scene ----------------------------------------------------
    size = HEADLINE_SIZE
    scene = procedural.to_scene(procedural.colonnade(subdiv=3), dev)
    cfg = cpt.RenderConfig(width=size, height=size, spp=HEADLINE_SPP,
                           integrator="pt_nee",
                           samples_per_call=HEADLINE_SPP,
                           reuse_primary_hit=True)
    t0 = time.perf_counter()
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
    prep = renderer.make_packet_prep(scene, bvh)
    torch.cuda.synchronize()
    t_accel = time.perf_counter() - t0
    cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                          focal_length=2.0, device=dev)
    pd = prep.pdata
    P = renderer.resolve_tile_size(cfg, scene.num_tris)
    print(f"scene: tris={scene.num_tris} clusters={pd.num_clusters} "
          f"C={pd.cluster_size} P={P} accel_s={t_accel:.2f}")

    # ---- 3. K1 vs plain at the headline shapes -----------------------------
    base_key = prng_key(1234, dev)
    idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    trace_fn = renderer.make_trace_fn(scene, cfg, bvh, prep=prep)
    calls = []

    def recording(o, d, mask):
        calls.append((o, d, mask))
        return trace_fn(o, d, mask)

    keys = pixel_keys(sample_key(base_key, 0), idx)
    o0, d0 = camera_rays(cam, idx, keys, lens=False)
    radiance_pt_nee(o0, d0, scene, recording, keys)
    batches = {"primary": calls[0], "bounce1": calls[1]}
    results = []
    for name, (o, d, mask) in batches.items():
        perm = packets.sort_rays(o, d, mask, pd)
        o = Vec3(o.x[perm], o.y[perm], o.z[perm])
        d = Vec3(d.x[perm], d.y[perm], d.z[perm])
        sl = packets.build_shortlists(o, d, mask[perm], pd, P,
                                      cfg.max_clusters)
        results.append(compare_kernel(
            name, sl, prep.resident_pack, k1.dense_intersect_resident,
            k1.dense_intersect_resident_plain))
    max_abs = max(r[0] for r in results)
    k1_ms, plain_ms = results[1][1], results[1][2]

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
    def window():
        return cpt.render_batch(scene, bvh, cam, cfg, base_key,
                                cpt.init_accum(cfg, device=dev),
                                HEADLINE_SPP, prep=prep)

    window()
    torch.cuda.synchronize()
    k1.dense_intersect_resident.launches = 0
    k1.dense_intersect_resident_plain.calls = 0
    walls = []
    for _ in range(HEADLINE_WINDOWS):
        t0 = time.perf_counter()
        st = window()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = k1.dense_intersect_resident.launches
    plain_calls = k1.dense_intersect_resident_plain.calls
    img = np.stack([c.cpu().numpy() for c in st.img], axis=1)
    finite = bool(np.isfinite(img).all())
    rays = cfg.num_pixels * HEADLINE_SPP * (cfg.num_bounces + 1)
    dt = sum(walls)
    print(f"headline: {size}x{size} spp={HEADLINE_SPP} "
          f"bounces={cfg.num_bounces} windows={HEADLINE_WINDOWS} "
          f"window_seconds={[round(w, 4) for w in walls]} "
          f"mrays_per_s={rays * HEADLINE_WINDOWS / dt / 1e6:.3f} "
          f"window_mrays_per_s_min={rays / max(walls) / 1e6:.3f} "
          f"max={rays / min(walls) / 1e6:.3f} image_max={img.max():.4f} "
          f"finite={finite} k1_launches={launches} "
          f"plain_calls={plain_calls}")
    if img.shape != (cfg.num_pixels, 3) or not finite or img.max() <= 0:
        raise AssertionError("headline image is not finite and lit")
    if launches <= 0 or plain_calls != 0:
        raise AssertionError("the main path did not run through K1 alone")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "dense_resident",
        "route": "cuda",
        "source": "cudapathtracer_tpu_torch/csrc/dense_resident.cu",
        "replaces": "cudapathtracer_tpu/ops/pallas/dense_resident.py:999",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
