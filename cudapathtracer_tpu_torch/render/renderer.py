"""Progressive renderer: accel build, sample loop, Kahan accumulation, output.

Counterpart of ``cudapathtracer_tpu/render/renderer.py``. The JAX package
runs a batch of samples as one jitted ``fori_loop``; here it is a Python
loop over samples, each keyed on its global index ``state.n + i``, so a
render resumed from a saved state equals an uninterrupted one. The
accumulator is float32 with Kahan-compensated running-mean updates in the
JAX package's operation order (the reference accumulates in double,
color.h:6).

Everything lives on one device, named explicitly: ``to_scene``,
``make_camera``, ``init_accum`` and ``render`` each take ``device``. The
packet engine follows the tensors: it runs the CUDA kernel on CUDA tensors
and the kernel's plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..accel.bvh import Accel, FlatBVH
from ..accel.native import build_bvh_native
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


def init_accum(cfg: RenderConfig, *, device) -> AccumState:
    r = cfg.num_pixels
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
    blocks and the kernels' scene layout (ops/kernels/dense_resident.py)."""

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


def make_packet_prep(scene, bvh: Accel) -> PacketPrep:
    pdata = packets.make_packet_data(
        scene, Vec3(bvh.cl_lo_x, bvh.cl_lo_y, bvh.cl_lo_z),
        Vec3(bvh.cl_hi_x, bvh.cl_hi_y, bvh.cl_hi_z), bvh.cl_tri)
    return PacketPrep(pdata=pdata, resident_pack=pack_clusters(pdata))


def make_trace_fn(scene, cfg: RenderConfig, bvh: Accel,
                  prep: PacketPrep | None = None):
    """The trace closure the integrator consumes: (o, d, mask) -> Hit,
    through the packet engine with the fine BVH as its fallback, and the
    scene's analytic spheres folded over the triangle hit."""
    td = traversal.make_trace_data(scene, bvh.fine)
    if prep is None:
        prep = make_packet_prep(scene, bvh)
    ts = resolve_tile_size(cfg, scene.num_tris)

    def trace_fn(o, d, mask):
        h = packets.trace_packets(
            o, d, prep.pdata, fine_td=td, mask=mask, tile_size=ts,
            max_clusters=cfg.max_clusters, sort=cfg.packet_sort,
            two_level=cfg.two_level_cull, super_factor=cfg.super_factor,
            super_list=cfg.super_list, resident_pack=prep.resident_pack)
        if scene.num_spheres == 0:
            return h
        return traversal.trace_spheres(o, d, scene, h.t, h.tri, mask=mask)

    return trace_fn


def render_batch(scene, bvh: Accel, cam: Camera, cfg: RenderConfig,
                 base_key, state: AccumState, num_samples: int,
                 prep: PacketPrep | None = None) -> AccumState:
    """Render ``num_samples`` progressive samples of every pixel into
    ``state``; sample i draws its randoms from the global index
    ``state.n + i``."""
    check_supported(cfg)
    dev = cam.pos.x.device
    trace_fn = make_trace_fn(scene, cfg, bvh, prep=prep)
    idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    params = PTParams(num_bounces=cfg.num_bounces,
                      orthonormal_frame=cfg.orthonormal_frame,
                      light_normal_mode=cfg.light_normal_mode,
                      branch_pdf_correction=cfg.branch_pdf_correction)
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
        sample = radiance_pt_nee(o, d, scene, trace_fn, keys, params,
                                 primary_hit=primary)
        state = _accum_update(state, sample, cfg.compensated_accum)
    return state


def render(scene, cam: Camera, cfg: RenderConfig, seed: int = 1234,
           bvh: Accel | None = None, state: AccumState | None = None, *,
           device) -> AccumState:
    """Full progressive render on ``device``: build the accel structure if
    needed (host, like the reference's buildBVH, kernel.cu:601), then render
    ``cfg.spp`` samples in ``cfg.samples_per_call`` chunks. A pinhole camera
    without jitter turns on ``reuse_primary_hit``."""
    check_supported(cfg)
    device = torch.device(device)
    for name, t in (("scene", scene.tri_v0), ("camera", cam.radius)):
        if t.device.type != device.type:
            raise ValueError(f"{name} lives on {t.device}, not {device}")
    if bvh is None:
        bvh = build_bvh_for_scene(scene, cfg.leaf_size,
                                  cluster_size=cfg.cluster_size)
    prep = make_packet_prep(scene, bvh)
    if state is None:
        state = init_accum(cfg, device=device)
    if (not cfg.reuse_primary_hit and not cfg.jitter
            and float(cam.radius) == 0.0):
        cfg = dataclasses.replace(cfg, reuse_primary_hit=True)
    base_key = prng_key(seed, device)
    done = state.n
    while done < cfg.spp:
        todo = min(cfg.samples_per_call, cfg.spp - done)
        state = render_batch(scene, bvh, cam, cfg, base_key, state, todo,
                             prep=prep)
        done += todo
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
    """Tonemapped image to a P3 PPM (x-flipped like the reference writer)."""
    if not str(path).lower().endswith(".ppm"):
        raise NotImplementedError("the port writes .ppm only")
    from ..utils.ppm import write_ppm

    write_ppm(path, finalize_image(state, cfg), flip_x=True)
