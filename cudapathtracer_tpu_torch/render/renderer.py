"""Progressive renderer: accel build, sample loop, Kahan accumulation, output.

Counterpart of ``cudapathtracer_tpu/render/renderer.py``. The JAX package
runs a batch of samples as one jitted ``fori_loop``; here it is a Python
loop over samples, each keyed on its global index ``state.n + i``, so a
render resumed from a saved state equals an uninterrupted one. The
accumulator is float32 with Kahan-compensated running-mean updates in the
JAX package's operation order (the reference accumulates in double,
color.h:6).

Everything lives on one device: ``to_scene``, ``make_camera``,
``init_accum`` and ``render`` each take ``device``, the card ("cuda")
unless the caller names another; without a card they raise. The packet
engine follows the tensors: it runs the CUDA kernel on CUDA tensors
and the kernel's plain PyTorch version on CPU tensors. ``cfg.traversal``
picks the engine, as in the JAX package: the packet engine ('packets'),
the fine-BVH walk ('bvh') or brute force ('brute'); each tests triangles
with ``cfg.intersector``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..accel.bvh import Accel, FlatBVH
from ..accel.native import build_bvh_native
from ..integrators.bdpt import BDPTParams, radiance_bdpt
from ..integrators.pt_nee import PTParams, radiance_pt_nee
from ..ops import packets, traversal
from ..ops.kernels.dense_resident import pack_clusters
from ..ops.rng import pixel_keys, prng_key, sample_key
from ..ops.vecmath import Vec3
from ..utils.color import finalize as color_finalize
from ..utils.color import quantize_u8
from ..utils.config import RenderConfig, check_supported
from ..utils.constants import MAX_BVH_DEPTH
from ..utils.morton import morton_to_scanline_perm
from .camera import Camera, camera_rays


class AccumState(NamedTuple):
    """Resumable accumulation state (Morton pixel order)."""

    img: Vec3        # (R,) running mean
    comp: Vec3       # (R,) Kahan compensation (zeros if disabled)
    n: int           # samples accumulated so far


def init_accum(cfg: RenderConfig, *, device="cuda",
               num_pixels: int | None = None) -> AccumState:
    """An empty state of the whole image, or of a tile of ``num_pixels``
    (``render_batch(idx=)``)."""
    r = cfg.num_pixels if num_pixels is None else int(num_pixels)
    return AccumState(img=Vec3.zeros((r,), device),
                      comp=Vec3.zeros((r,), device), n=0)


def _accum_update(state: AccumState, sample: Vec3,
                  compensated: bool) -> AccumState:
    """Running mean (kernel.cu:551-552), optionally Kahan-compensated."""
    n = state.n + 1
    nf = np.float32(n)
    if not compensated:
        # the factors in float32 arithmetic, as the JAX package forms them
        keep = float((nf - np.float32(1.0)) / nf)
        img = state.img * keep + sample * float(np.float32(1.0) / nf)
        return AccumState(img=img, comp=state.comp, n=n)
    nf = float(nf)

    def kahan(mean, comp, s):
        delta = (s - mean) / nf
        y = delta - comp
        t = mean + y
        return t, (t - mean) - y

    ix, cx = kahan(state.img.x, state.comp.x, sample.x)
    iy, cy = kahan(state.img.y, state.comp.y, sample.y)
    iz, cz = kahan(state.img.z, state.comp.z, sample.z)
    return AccumState(img=Vec3(ix, iy, iz), comp=Vec3(cx, cy, cz), n=n)


class PacketPrep(NamedTuple):
    """Scene-constant packet precompute, built once per render: the cluster
    blocks and the kernels' scene layout for one intersector
    (ops/kernels/dense_resident.py)."""

    pdata: packets.PacketData
    resident_pack: tuple


def resolve_tile_size(cfg: RenderConfig, num_tris: int) -> int:
    """cfg.tile_size, or the JAX package's auto default: P = 256 up to
    C = 512, P = 128 beyond (measured on a TPU; not yet re-measured on the
    H100)."""
    if cfg.tile_size is not None:
        return int(cfg.tile_size)
    c = cfg.cluster_size or adaptive_cluster_size(num_tris)
    return 256 if c <= 512 else 128


def make_packet_prep(scene, bvh: Accel,
                     intersector: str = "bw") -> PacketPrep:
    pdata = packets.make_packet_data(
        scene, Vec3(bvh.cl_lo_x, bvh.cl_lo_y, bvh.cl_lo_z),
        Vec3(bvh.cl_hi_x, bvh.cl_hi_y, bvh.cl_hi_z), bvh.cl_tri)
    return PacketPrep(pdata=pdata,
                      resident_pack=pack_clusters(pdata, intersector))


def make_trace_fn(scene, cfg: RenderConfig, bvh: Accel | None,
                  prep: PacketPrep | None = None):
    """The trace closure the integrators consume: (o, d, mask, t_cap=None,
    vis_band=0.0) -> Hit by ``cfg.traversal`` with ``cfg.intersector``,
    and the scene's analytic spheres folded over the triangle hit
    (renderer.py:141-236).

    'packets': the packet engine with the fine BVH as its fallback; a
    visibility trace (``vis_band`` > 0, BDPT's connection rays) is tiled by
    ``cfg.tile_size_vis`` where given, and keeps its band only with
    ``cfg.vis_dropout``. 'bvh' (the fine-BVH walk) and 'brute' (which
    needs no ``bvh``) answer the closest hit, capped by ``t_cap``, and
    ignore ``vis_band``: the closest hit decides a visibility query
    alike. The search data (the fine ``TraceData`` and, without ``prep``,
    the packet prep) is built here from the scene's current vertices,
    detached: every engine is (ops/traversal.py)."""
    with torch.no_grad():
        return _make_trace_fn(scene, cfg, bvh, prep)


def _make_trace_fn(scene, cfg, bvh, prep):
    if cfg.traversal == "brute":
        def base(o, d, mask, t_cap=None, vis_band=0.0):
            h = traversal.trace_bruteforce(o, d, scene, mask=mask,
                                           intersector=cfg.intersector)
            return h if t_cap is None else traversal.apply_t_cap(h, t_cap)
    elif cfg.traversal == "bvh":
        td = traversal.make_trace_data(scene, bvh.fine)

        def base(o, d, mask, t_cap=None, vis_band=0.0):
            h = traversal.trace(o, d, td, mask=mask,
                                intersector=cfg.intersector)
            return h if t_cap is None else traversal.apply_t_cap(h, t_cap)
    else:
        td = traversal.make_trace_data(scene, bvh.fine)
        if prep is None:
            prep = make_packet_prep(scene, bvh, cfg.intersector)
        ts_base = resolve_tile_size(cfg, scene.num_tris)

        def base(o, d, mask, t_cap=None, vis_band=0.0):
            # the tile size keys on the call site, with or without the
            # dropout
            ts = (cfg.tile_size_vis
                  if vis_band > 0.0 and cfg.tile_size_vis is not None
                  else ts_base)
            if not cfg.vis_dropout:
                vis_band = 0.0
            return packets.trace_packets(
                o, d, prep.pdata, fine_td=td, mask=mask, tile_size=ts,
                max_clusters=cfg.max_clusters, sort=cfg.packet_sort,
                two_level=cfg.two_level_cull, super_factor=cfg.super_factor,
                super_list=cfg.super_list, resident_pack=prep.resident_pack,
                t_cap=t_cap, vis_band=vis_band, intersector=cfg.intersector)

    if scene.num_spheres == 0:
        return base

    def trace_fn(o, d, mask, t_cap=None, vis_band=0.0):
        h = base(o, d, mask, t_cap=t_cap, vis_band=vis_band)
        h = traversal.trace_spheres(o, d, scene, h.t, h.tri, mask=mask)
        # sphere hits beyond the cap are misses too
        return h if t_cap is None else traversal.apply_t_cap(h, t_cap)

    return trace_fn


def _radiance(o, d, scene, trace_fn, keys, cfg: RenderConfig,
              primary_hit=None) -> Vec3:
    """The integrator ``cfg.integrator`` names (renderer.py:239-252)."""
    if cfg.integrator == "pt_nee":
        params = PTParams(num_bounces=cfg.num_bounces,
                          orthonormal_frame=cfg.orthonormal_frame,
                          light_normal_mode=cfg.light_normal_mode,
                          branch_pdf_correction=cfg.branch_pdf_correction)
        return radiance_pt_nee(o, d, scene, trace_fn, keys, params,
                               primary_hit=primary_hit)
    return radiance_bdpt(o, d, scene, trace_fn, keys,
                         BDPTParams(orthonormal_frame=cfg.orthonormal_frame),
                         primary_hit=primary_hit)


def render_batch(scene, bvh: Accel | None, cam: Camera, cfg: RenderConfig,
                 base_key, state: AccumState, num_samples: int,
                 prep: PacketPrep | None = None, idx=None) -> AccumState:
    """Render ``num_samples`` progressive samples into ``state``; sample i
    draws its randoms from the global index ``state.n + i``.

    ``idx``: the Morton pixel indices this call covers (default: the whole
    image), with ``state`` of as many pixels. The randoms key on the pixel
    index, not on its position, so tiles rendered apart equal the whole
    image's pixels (JAX renderer.py:255-273)."""
    check_supported(cfg)
    dev = cam.pos.x.device
    trace_fn = make_trace_fn(scene, cfg, bvh, prep=prep)
    if idx is None:
        idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    if state.img.x.shape != idx.shape:
        raise ValueError(f"state holds {tuple(state.img.x.shape)} pixels, "
                         f"idx {tuple(idx.shape)}")
    if cfg.reuse_primary_hit and float(cam.radius) != 0.0:
        raise ValueError("cfg.reuse_primary_hit requires a pinhole camera "
                         "(radius=0)")

    primary = None
    if cfg.reuse_primary_hit and not cfg.jitter:
        # pinhole, no jitter: every sample's primary rays are identical
        keys0 = pixel_keys(sample_key(base_key, state.n), idx)
        o0, d0 = camera_rays(cam, idx, keys0, jitter=False, lens=False)
        primary = trace_fn(o0, d0, torch.ones(idx.shape, dtype=torch.bool,
                                              device=dev))

    for i in range(num_samples):
        keys = pixel_keys(sample_key(base_key, state.n), idx)
        o, d = camera_rays(cam, idx, keys, jitter=cfg.jitter,
                           lens=not cfg.reuse_primary_hit)
        sample = _radiance(o, d, scene, trace_fn, keys, cfg,
                           primary_hit=primary)
        state = _accum_update(state, sample, cfg.compensated_accum)
    return state


def render(scene, cam: Camera, cfg: RenderConfig, seed: int = 1234,
           bvh: Accel | None = None, state: AccumState | None = None,
           progress_cb=None, *, idx=None, device="cuda") -> AccumState:
    """Full progressive render on ``device``: build the accel structure if
    needed (host, like the reference's buildBVH, kernel.cu:601), then render
    ``cfg.spp`` samples in ``cfg.samples_per_call`` chunks, calling
    ``progress_cb(done, state)`` after each chunk (the CLI's progress lines
    and checkpoints). A pinhole camera without jitter turns on
    ``reuse_primary_hit``. Brute force (``cfg.traversal == 'brute'``) builds
    no accel structure. ``idx``: the Morton pixel indices to render
    (default: the whole image), as ``render_batch`` takes them; a new
    ``state`` then holds as many pixels (a rank's range, parallel/)."""
    check_supported(cfg)
    device = torch.device(device)
    for name, t in (("scene", scene.tri_v0), ("camera", cam.radius)):
        if t.device.type != device.type:
            raise ValueError(f"{name} lives on {t.device}, not {device}")
    if bvh is None and cfg.traversal != "brute":
        bvh = build_bvh_for_scene(scene, cfg.leaf_size,
                                  cluster_size=cfg.cluster_size)
    prep = (make_packet_prep(scene, bvh, cfg.intersector)
            if cfg.traversal == "packets" else None)
    if state is None:
        state = init_accum(cfg, device=device, num_pixels=None
                           if idx is None else idx.shape[0])
    if (not cfg.reuse_primary_hit and not cfg.jitter
            and float(cam.radius) == 0.0):
        cfg = dataclasses.replace(cfg, reuse_primary_hit=True)
    base_key = prng_key(seed, device)
    done = state.n
    while done < cfg.spp:
        todo = min(cfg.samples_per_call, cfg.spp - done)
        state = render_batch(scene, bvh, cam, cfg, base_key, state, todo,
                             prep=prep, idx=idx)
        done += todo
        if progress_cb is not None:
            progress_cb(done, state)
    return state


def _build_flat_host(verts, tris, leaf_size: int):
    """One flat BVH as host arrays (lo (N,3), hi (N,3), skip, leaf,
    leaf_tri) from the native builder. A failed build raises."""
    d, depth = build_bvh_native(verts, tris, leaf_size)
    if depth >= MAX_BVH_DEPTH:
        # the reference's fatal guard (kernel.cu:627-631)
        raise RuntimeError(f"BVH depth {depth} >= {MAX_BVH_DEPTH}")
    return (d["node_lo"], d["node_hi"], d["node_skip"], d["node_leaf"],
            d["leaf_tri"])


def _repack_clusters(cl_lo, cl_hi, cl_tri, num_tris: int, C: int):
    """Greedily merge preorder-consecutive under-full SAH leaves into full
    clusters of at most C triangles (whole leaves only)."""
    counts = (cl_tri < num_tris).sum(axis=1)
    K = cl_tri.shape[0]
    groups = []
    start, acc = 0, 0
    for k in range(K):
        if acc + counts[k] > C and acc > 0:
            groups.append((start, k))
            start, acc = k, 0
        acc += counts[k]
    groups.append((start, K))

    lo = np.empty((len(groups), 3), np.float32)
    hi = np.empty((len(groups), 3), np.float32)
    tri = np.full((len(groups), C), num_tris, np.int32)
    for g, (a, b) in enumerate(groups):
        lo[g] = cl_lo[a:b].min(axis=0)
        hi[g] = cl_hi[a:b].max(axis=0)
        ids = cl_tri[a:b].reshape(-1)
        ids = ids[ids < num_tris]
        tri[g, : ids.shape[0]] = ids
    return lo, hi, tri


def adaptive_cluster_size(num_tris: int) -> int:
    """Default cluster width: ~T/160 in multiples of 128, clamped to
    [256, 1024] (the JAX package's rule, tuned on a TPU)."""
    c = max(256, round(num_tris / 160))
    return min(1024, 128 * max(2, round(c / 128)))


def build_bvh_for_scene(scene, leaf_size: int = 4,
                        cluster_size: int | None = None) -> Accel:
    """Host accel build from the scene's host geometry: the fine per-ray BVH
    (``leaf_size``) plus the cluster level (``cluster_size``), uploaded to
    the scene's device."""
    verts, tris = scene.host_verts, scene.host_tris
    dev = scene.device
    if cluster_size is None:
        cluster_size = adaptive_cluster_size(tris.shape[0])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    lo, hi, skip, leaf, leaf_tri = _build_flat_host(verts, tris, leaf_size)
    fine = FlatBVH(*(t(lo[:, i]) for i in range(3)),
                   *(t(hi[:, i]) for i in range(3)),
                   node_skip=t(skip), node_leaf=t(leaf), leaf_tri=t(leaf_tri))
    c_lo, c_hi, _, c_leaf, c_ltri = _build_flat_host(verts, tris,
                                                     cluster_size)
    sel = np.flatnonzero(c_leaf >= 0)
    sel = sel[np.argsort(c_leaf[sel])]
    cl_lo, cl_hi, cl_tri = _repack_clusters(
        c_lo[sel], c_hi[sel], c_ltri, tris.shape[0], cluster_size)
    return Accel(fine, *(t(cl_lo[:, i]) for i in range(3)),
                 *(t(cl_hi[:, i]) for i in range(3)), cl_tri=t(cl_tri))


def finalize_image(state: AccumState, cfg: RenderConfig):
    """Morton de-swizzle, Reinhard + gamma, truncating u8 -> (H, W, 3) numpy
    (kernel.cu:764-778), before the PPM writer's x flip."""
    perm = morton_to_scanline_perm(cfg.width, cfg.height, state.img.x.device)
    img = Vec3(state.img.x[perm], state.img.y[perm], state.img.z[perm])
    u8 = quantize_u8(color_finalize(img))
    return u8.cpu().numpy().reshape(cfg.height, cfg.width, 3)


def write_render(path, state: AccumState, cfg: RenderConfig):
    """Tonemapped image to disk, x-flipped like the reference writer; the
    format by extension: .png through utils/png.py, else a P3 PPM."""
    img = finalize_image(state, cfg)
    if str(path).lower().endswith(".png"):
        from ..utils.png import write_png

        write_png(path, img, flip_x=True)
    else:
        from ..utils.ppm import write_ppm

        write_ppm(path, img, flip_x=True)
