"""K1: dense closest-hit over each ray tile's cluster shortlist.

The CUDA kernel (``csrc/dense_resident.cu``) replaces the Pallas TPU kernel
``cudapathtracer_tpu/ops/pallas/dense_resident.py:dense_intersect_resident``;
the note at the top of the CUDA source says what bounds it on the card and
what its design does about that. Beside it:

* ``pack_clusters`` lays the scene out for both versions: BW rows
  (K+1, 12, C) f32 [n.xyz, v0.xyz, m1.xyz, m2.xyz], triangle ids (K+1, C)
  i32 and cluster boxes (K+1, 6) f32. Row K is the sentinel: all-zero
  triangles (rejected by the parallel test) and a far-away point box.
* ``dense_intersect_resident_plain``, the plain PyTorch version: the
  ungated dense fold of every slot below each tile's count, in the kernel's
  formulas, operation order and fused multiply-adds (ops/vecmath.py). Box
  gates and the early exit skip only work that cannot change a hit, so the
  two agree bit for bit.
* ``dense_intersect_resident``, the wrapper: it launches the kernel for
  CUDA tensors (and raises if the build or the launch fails) and takes the
  plain version only for tensors on the CPU. ``launches`` counts kernel
  launches; ``dense_intersect_resident_plain.calls`` counts plain calls.
* What K2 (``dense.py``) and K3 (``dense_super.py``) share with K1: the
  uncounted plain fold ``plain_fold``, the input checks, the build
  (``load_fold_kernel``) and the launch (``launch_fold``).

Inputs, for Tl tiles of P rays and a shortlist of M slots:
ids (Tl, M) i32 cluster ids ascending by entry, with K past each count;
counts (Tl,) i32; entries (Tl, M) f32 (+inf past the count); rays (Tl, 8, P)
f32, rows o.xyz, d.xyz, lane mask, search cap. Output: t (Tl, P) f32 and
tri (Tl, P) i32 (-1 where nothing beat the cap; masked lanes hold -3e38).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import torch

from ...ops.intersect import bw_precompute
from ...ops.vecmath import Vec3, dot, fma3
from ...utils.build import PACKAGE_DIR, build_and_load
from ...utils.constants import EPS_PARALLEL, MAX_FLOAT

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "dense_resident.cu")
HEADER = os.path.join(PACKAGE_DIR, "csrc", "bw_fold.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
ROWS = 12
MASKED_T_INIT = -3.0e38
_FAR_BOX = 1.0e7

# The JAX package's VMEM budget for its resident kernel
# (dense_resident.py:58, 67-69). Past it the JAX package switches to its
# DMA kernel, K2; the port keeps the same rule (ops/packets.route), so a
# configuration takes the same kernel in both packages.
RESIDENT_VMEM_BUDGET = 72 * 1024 * 1024


def resident_fits(num_clusters: int, cluster_size: int) -> bool:
    return (num_clusters + 1) * 16 * cluster_size * 4 <= RESIDENT_VMEM_BUDGET


def pack_clusters(pd):
    """PacketData -> (packed (K+1, 12, C) f32, tri (K+1, C) i32,
    boxes (K+1, 6) f32)."""
    n, m1, m2 = bw_precompute(pd.e1, pd.e2)
    packed = torch.stack([n.x, n.y, n.z, pd.v0.x, pd.v0.y, pd.v0.z,
                          m1.x, m1.y, m1.z, m2.x, m2.y, m2.z], dim=1)
    far = torch.full((1,), _FAR_BOX, dtype=torch.float32,
                     device=pd.tri.device)
    boxes = torch.stack([torch.cat([c, far]) for c in (
        pd.cl_lo.x, pd.cl_lo.y, pd.cl_lo.z,
        pd.cl_hi.x, pd.cl_hi.y, pd.cl_hi.z)], dim=1)
    return (packed.contiguous(), pd.tri.to(torch.int32).contiguous(),
            boxes.contiguous())


def _check_inputs(ids, counts, entries, rays, packed, tri, boxes):
    Tl, M = ids.shape
    K1, rows, C = packed.shape
    P = rays.shape[2]
    dev = rays.device
    expect = (
        (ids, (Tl, M), torch.int32), (counts, (Tl,), torch.int32),
        (entries, (Tl, M), torch.float32), (rays, (Tl, 8, P), torch.float32),
        (packed, (K1, ROWS, C), torch.float32), (tri, (K1, C), torch.int32),
        (boxes, (K1, 6), torch.float32),
    )
    for a, shape, dtype in expect:
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"expected {dtype} {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"inputs on {a.device} and {dev}")
        if not a.is_contiguous():
            raise ValueError("inputs must be contiguous")
    return Tl, M, P, C


def plain_fold(ids, counts, entries, rays, packed, tri, boxes,
               chunk_elems: int = 1 << 24):
    """The plain fold, uncounted: fold every slot s < count of every tile,
    ungated, in blocks of tiles of at most ``chunk_elems`` (ray, triangle)
    pairs. The fold keeps the lexicographic minimum of (t, id) from the
    init (cap, -1), which is what the kernel's sequential
    ``ts < t or (ts == t and id < best)`` computes. ``entries`` and
    ``boxes`` only steer the kernel's skipping, so they are unused here."""
    Tl, M, P, C = _check_inputs(ids, counts, entries, rays, packed, tri,
                                boxes)
    o = [rays[:, i, :, None] for i in range(6)]       # (Tl, P, 1)
    live = rays[:, 6] > 0.5
    t_best = torch.where(live, torch.clamp(rays[:, 7], max=MAX_FLOAT),
                         MASKED_T_INIT)
    tri_best = torch.full((Tl, P), -1, dtype=torch.int32, device=rays.device)
    step = max(1, chunk_elems // (P * C))
    n_slots = int(counts.max()) if Tl else 0
    for s in range(n_slots):
        act = torch.nonzero(counts > s).flatten()
        for a0 in range(0, act.numel(), step):
            tiles = act[a0:a0 + step]
            sid = ids[tiles, s].long()
            cl = packed[sid][:, :, None, :]               # (n, 12, 1, C)
            ox, oy, oz, dx, dy, dz = (v[tiles] for v in o)
            n = Vec3(cl[:, 0], cl[:, 1], cl[:, 2])
            sx = Vec3(ox - cl[:, 3], oy - cl[:, 4], oz - cl[:, 5])
            d = Vec3(dx, dy, dz)
            nd = dot(d, n)
            parallel = torch.abs(nd) < EPS_PARALLEL
            inv = 1.0 / nd
            t = -dot(sx, n) * inv
            w = fma3(d, t, sx)
            bu = dot(Vec3(cl[:, 6], cl[:, 7], cl[:, 8]), w)
            bv = dot(Vec3(cl[:, 9], cl[:, 10], cl[:, 11]), w)
            bw = 1.0 - bu - bv
            reject = (parallel | (bu < 0.0) | (bv < 0.0) | (bw < 0.0)
                      | (t <= 0.0))
            ts = torch.where(reject, MAX_FLOAT, t)        # (n, P, C)
            t_new = torch.amin(ts, dim=2)
            ids_c = tri[sid][:, None, :]
            id_new = torch.amin(
                torch.where(ts == t_new[..., None], ids_c, 0x7FFFFFFF),
                dim=2).to(torch.int32)
            tb, ib = t_best[tiles], tri_best[tiles]
            better = (t_new < tb) | ((t_new == tb) & (id_new < ib))
            t_best[tiles] = torch.where(better, t_new, tb)
            tri_best[tiles] = torch.where(better, id_new, ib)
    return t_best, tri_best


def dense_intersect_resident_plain(ids, counts, entries, rays, packed, tri,
                                   boxes):
    """K1's plain PyTorch version (``plain_fold``), counted."""
    dense_intersect_resident_plain.calls += 1
    return plain_fold(ids, counts, entries, rays, packed, tri, boxes)


dense_intersect_resident_plain.calls = 0


def load_fold_kernel(lib_name: str, source: str, symbol: str, n_ints: int):
    """Build ``source`` (with bw_fold.cuh) into ``build/lib_name`` and bind
    ``symbol(9 pointers, n_ints ints, stream) -> cudaError_t``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = build_and_load(lib_name, [source], [nvcc] + NVCC_FLAGS,
                         headers=[HEADER])
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    return fn


def launch_fold(load, name, ids, counts, entries, rays, packed, tri, boxes,
                extra=()):
    """Check the inputs, launch ``load()``'s kernel with (pointers, Tl, M,
    P, C, *extra) on the current stream and return (t, tri); raise if the
    launch fails."""
    Tl, M, P, C = _check_inputs(ids, counts, entries, rays, packed, tri,
                                boxes)
    if P % 32 != 0 or not 0 < P <= 1024:
        raise ValueError(f"tile size {P} must be a multiple of 32 <= 1024")
    t = torch.empty((Tl, P), dtype=torch.float32, device=rays.device)
    tri_out = torch.empty((Tl, P), dtype=torch.int32, device=rays.device)
    if Tl == 0:
        return t, tri_out
    fn = load()
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = fn(ids.data_ptr(), counts.data_ptr(), entries.data_ptr(),
                 rays.data_ptr(), packed.data_ptr(), tri.data_ptr(),
                 boxes.data_ptr(), t.data_ptr(), tri_out.data_ptr(),
                 Tl, M, P, C, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return t, tri_out


def is_cpu(rays):
    """True for CPU tensors (take the plain version), False for CUDA ones
    (launch the kernel); any other device raises."""
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {rays.device}")
    return rays.device.type == "cpu"


@functools.cache
def _load_kernel():
    return load_fold_kernel("libdense_resident.so", SOURCE,
                            "dense_resident_launch", 4)


def build():
    """Build and load the kernel library (it is otherwise built at the
    first launch)."""
    _load_kernel()


def dense_intersect_resident(ids, counts, entries, rays, packed, tri, boxes):
    """K1 on CUDA tensors; the plain version for tensors on the CPU."""
    if is_cpu(rays):
        return dense_intersect_resident_plain(ids, counts, entries, rays,
                                              packed, tri, boxes)
    out = launch_fold(_load_kernel, "dense_resident", ids, counts, entries,
                      rays, packed, tri, boxes)
    dense_intersect_resident.launches += 1
    return out


dense_intersect_resident.launches = 0
