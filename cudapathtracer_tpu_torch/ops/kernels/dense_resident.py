"""K1: dense closest-hit over each ray tile's cluster shortlist.

The CUDA kernel (``csrc/dense_resident.cu``) replaces the Pallas TPU kernel
``cudapathtracer_tpu/ops/pallas/dense_resident.py:dense_intersect_resident``;
the note at the top of the CUDA source says what bounds it on the card and
what its design does about that. Beside it:

* ``pack_clusters`` lays the scene out for both versions, for the
  intersector the caller names: Baldwin-Weber rows (K+1, 12, C) f32
  [n.xyz, v0.xyz, m1.xyz, m2.xyz] ('bw') or Moller-Trumbore rows
  (K+1, 9, C) f32 [v0.xyz, e1.xyz, e2.xyz] ('mt', the JAX package's
  ``pack_clusters_resident``), triangle ids (K+1, C) i32 and cluster boxes
  (K+1, 6) f32. Row K is the sentinel: all-zero triangles (rejected by the
  parallel test of either intersector) and a far-away point box. Every
  kernel and plain version tests triangles by the pack's row count, and
  the wrappers raise where it is not the intersector asked for.
* ``dense_intersect_resident_plain``, the plain PyTorch version: the
  ungated dense fold of every slot below each tile's count, in the kernel's
  formulas, operation order and fused multiply-adds (ops/vecmath.py). Box
  gates and the early exit skip only work that cannot change a hit, so the
  two agree bit for bit.
* ``dense_intersect_resident``, the wrapper: it launches the kernel for
  CUDA tensors (and raises if the build or the launch fails) and takes the
  plain version only for tensors on the CPU. ``launches`` counts kernel
  launches; ``dense_intersect_resident_plain.calls`` counts plain calls.
  Given ``counts_out`` (Tl, COUNT_COLS) int64 on the card, it launches the
  kernel's counting instance instead, which also writes per tile the
  clusters folded (summed over the blocks of the tile that fold them), the
  lane tests issued (a lane test is one test body run by one lane, its
  result used or not) and the clock cycles of each phase of the fold
  (``PHASES``); the main path never passes it.
* ``fold_schedule``, a plain count of a gated schedule: the clusters that
  groups of rays fold when each group takes its own exit vote and gates
  with its own rays' t (a group of P rays is K2's block per tile,
  ``k1_group(P)`` rays K1's blocks), for holding a counting instance's
  first column.
* What K2 (``dense.py``) and K3 (``dense_super.py``) share with K1: the
  uncounted plain fold ``plain_fold``, the kernels' gate ``box_gate``, the
  input checks (``check_inputs``), the build (``load_fold_kernel``) and
  the launch (``launch_fold``), and the gated fold's closest-hit key
  (``fold_key``, ``unpack_key``; for tests).

Inputs, for Tl tiles of P rays and a shortlist of M slots:
ids (Tl, M) i32 cluster ids ascending by entry, with K past each count;
counts (Tl,) i32; entries (Tl, M) f32 (+inf past the count); rays (Tl, 8, P)
f32, rows o.xyz, d.xyz, lane mask, search cap. Output: t (Tl, P) f32 and
tri (Tl, P) i32 (-1 where nothing beat the cap; masked lanes hold -3e38).

Every kernel and plain version takes ``vis_band`` (a float, 0 by default).
Above 0 the query asks for visibility only (BDPT's connection rays, the JAX
package's ``_vis_drop``, dense_resident.py:330-347): a ray whose closest
hit lies below its floor ``cap - vis_band`` is occluded whatever else its
shortlist holds, so the kernels retire it as soon as a fold takes its t
below the floor (``csrc/gated_fold.cuh``). Its t becomes -3e38, and its id
is the occluder found then, which depends on the schedule. The t that comes
out is the same for every schedule: -3e38 exactly on the lanes whose
closest hit lies below the floor, the closest hit elsewhere. The plain
versions fold to the closest hit and then set t to -3e38 there.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import torch

from ...ops.intersect import bw_precompute, ray_triangle
from ...ops.vecmath import Vec3, dot, fma3
from ...utils.build import PACKAGE_DIR, build_and_load
from ...utils.constants import EPS_PARALLEL, MAX_FLOAT

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "dense_resident.cu")
HEADERS = [os.path.join(PACKAGE_DIR, "csrc", h)
           for h in ("bw_fold.cuh", "gated_fold.cuh")]
# -Xptxas -v: the build log keeps each kernel's registers and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]
# The gated fold builds with at most 64 registers a thread, so an SM holds
# 1024 of its threads; uncapped, K3 takes 82 and fits 2 blocks of 256. On
# one H100 80GB HBM3 (700 W) the cap made K3 1.3-1.7x, K2 1.06-1.08x and K1
# 1.2-1.3x faster at chip_smoke.py's shapes, for 16-88 bytes of stack
# (tools/tune_gated_fold.py).
GATED_FOLD_FLAGS = ["-maxrregcount=64"]
# K1 folds a tile in blocks of at most this many rays (csrc/
# dense_resident.cu:kBlockRays), each with its own votes and gates.
K1_BLOCK_RAYS = 128


def k1_group(P: int) -> int:
    """The rays of one K1 block on tiles of P rays, which vote and gate
    together (``fold_schedule``'s group): min(K1_BLOCK_RAYS, P), halved
    until it divides P."""
    b = min(K1_BLOCK_RAYS, P)
    while P % b:
        b //= 2
    return b


# the pack's rows per intersector (csrc/gated_fold.cuh: BW, MT)
ROWS = {"bw": 12, "mt": 9}


def intersector_of(packed) -> str:
    """'bw' or 'mt', by the pack's rows."""
    return "mt" if packed.shape[1] == ROWS["mt"] else "bw"


# A counting instance's columns per tile: clusters (K3: members) folded,
# lane tests issued, then the clock64() cycles of each phase of the fold,
# summed over the tile's warps (csrc/gated_fold.cuh).
PHASES = ("gate_vote", "list", "wait", "tests", "merge")
COUNT_COLS = 2 + len(PHASES)
MASKED_T_INIT = -3.0e38
_FAR_BOX = 1.0e7

# The JAX package's VMEM budget for its resident kernel
# (dense_resident.py:58, 67-69). Past it the JAX package switches to its
# DMA kernel, K2; the port keeps the same rule (ops/packets.route), so a
# configuration takes the same kernel in both packages.
RESIDENT_VMEM_BUDGET = 72 * 1024 * 1024


def resident_fits(num_clusters: int, cluster_size: int) -> bool:
    return (num_clusters + 1) * 16 * cluster_size * 4 <= RESIDENT_VMEM_BUDGET


def pack_clusters(pd, intersector: str = "bw"):
    """PacketData -> (packed (K+1, ROWS[intersector], C) f32, tri (K+1, C)
    i32, boxes (K+1, 6) f32)."""
    if intersector == "mt":
        rows = (*pd.v0, *pd.e1, *pd.e2)
    elif intersector == "bw":
        n, m1, m2 = bw_precompute(pd.e1, pd.e2)
        rows = (*n, *pd.v0, *m1, *m2)
    else:
        raise ValueError(f"intersector {intersector!r}: 'bw' or 'mt'")
    packed = torch.stack(rows, dim=1)
    far = torch.full((1,), _FAR_BOX, dtype=torch.float32,
                     device=pd.tri.device)
    boxes = torch.stack([torch.cat([c, far]) for c in (
        pd.cl_lo.x, pd.cl_lo.y, pd.cl_lo.z,
        pd.cl_hi.x, pd.cl_hi.y, pd.cl_hi.z)], dim=1)
    return (packed.contiguous(), pd.tri.to(torch.int32).contiguous(),
            boxes.contiguous())


def check_inputs(ids, counts, entries, rays, packed, tri, boxes,
                 intersector=None):
    """Shapes, types, device and layout of a fold's inputs; the pack's rows
    must be one intersector's, and ``intersector``'s where it is named."""
    Tl, M = ids.shape
    K1, rows, C = packed.shape
    P = rays.shape[2]
    dev = rays.device
    if rows not in ROWS.values() or (intersector is not None
                                     and rows != ROWS[intersector]):
        raise ValueError(f"a pack of {rows} rows, not the "
                         f"{intersector or 'bw or mt'} layout "
                         f"({ROWS.get(intersector, ROWS)} rows)")
    expect = (
        (ids, (Tl, M), torch.int32), (counts, (Tl,), torch.int32),
        (entries, (Tl, M), torch.float32), (rays, (Tl, 8, P), torch.float32),
        (packed, (K1, rows, C), torch.float32), (tri, (K1, C), torch.int32),
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
               vis_band: float = 0.0, chunk_elems: int = 1 << 24):
    """The plain fold, uncounted: fold every slot s < count of every tile,
    ungated, in blocks of tiles of at most ``chunk_elems`` (ray, triangle)
    pairs. The fold keeps the lexicographic minimum of (t, id) from the
    init (cap, -1), which is what the kernel's sequential
    ``ts < t or (ts == t and id < best)`` computes; with ``vis_band`` > 0,
    t is then -3e38 where it lies below ``cap - vis_band``. ``entries`` and
    ``boxes`` only steer the kernel's skipping, so they are unused here."""
    return _fold(ids, counts, entries, rays, packed, tri, boxes,
                 chunk_elems, vis_band=vis_band)[:2]


def _init(rays):
    """The fold's init (t, id) (Tl, P): min(cap, MAX_FLOAT) and -1 for live
    lanes, -3e38 for masked ones."""
    live = rays[:, 6] > 0.5
    t = torch.where(live, torch.clamp(rays[:, 7], max=MAX_FLOAT),
                    MASKED_T_INIT)
    return t, torch.full(t.shape, -1, dtype=torch.int32, device=rays.device)


def _slot_hits(rays, packed, tri, sid):
    """Each ray's closest (t, id) over the C triangles of one cluster per
    tile, by the pack's intersector: rays (n, 8, P), cluster ids sid (n,)
    -> (n, P) each, misses at (MAX_FLOAT, lowest id). The tests are the
    kernels' (``csrc/bw_fold.cuh``: ``bw_test``, ``mt_test``) in their
    formulas, operation order and fused multiply-adds; MT's is
    ``intersect.ray_triangle``, whose guard on 1/a changes no unrejected
    lane."""
    o = [rays[:, i, :, None] for i in range(6)]       # (n, P, 1)
    cl = packed[sid][:, :, None, :]                   # (n, rows, 1, C)
    d = Vec3(o[3], o[4], o[5])
    if intersector_of(packed) == "mt":
        v0, e1, e2 = (Vec3(cl[:, k], cl[:, k + 1], cl[:, k + 2])
                      for k in (0, 3, 6))
        t = ray_triangle(Vec3(o[0], o[1], o[2]), d, v0, e1, e2)
        ts = torch.where(t <= 0.0, MAX_FLOAT, t)      # (n, P, C)
    else:
        n = Vec3(cl[:, 0], cl[:, 1], cl[:, 2])
        sx = Vec3(o[0] - cl[:, 3], o[1] - cl[:, 4], o[2] - cl[:, 5])
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
    id_new = torch.amin(
        torch.where(ts == t_new[..., None], tri[sid][:, None, :], 0x7FFFFFFF),
        dim=2).to(torch.int32)
    return t_new, id_new


def guarded_inv(d):
    """1 / d with |d| raised to at least 1e-30 (``bw_fold.cuh:
    guarded_inv``)."""
    return 1.0 / torch.where(d.abs() < 1e-30,
                             torch.where(d < 0, -1e-30, 1e-30), d)


def box_gate(bx, o, inv, t):
    """The kernels' box gate (``csrc/bw_fold.cuh:box_gate``) in the same
    float32 operations, without the lane mask: boxes ``bx`` (..., 6)
    [lo.xyz, hi.xyz], broadcast by the caller against the rays' origins
    ``o`` and guarded inverse directions ``inv`` (3 tensors each) and their
    t."""
    lo = [(bx[..., k, None] - o[k]) * inv[k] for k in range(3)]
    hi = [(bx[..., 3 + k, None] - o[k]) * inv[k] for k in range(3)]
    tmin = torch.maximum(torch.maximum(torch.minimum(lo[0], hi[0]),
                                       torch.minimum(lo[1], hi[1])),
                         torch.minimum(lo[2], hi[2]))
    tmax = torch.minimum(torch.minimum(torch.maximum(lo[0], hi[0]),
                                       torch.maximum(lo[1], hi[1])),
                         torch.maximum(lo[2], hi[2]))
    return (tmin <= tmax) & (tmax >= 0) & (tmin <= t)


def _retire(t, rays, vis_band):
    """Visibility mode: t -> -3e38 where it lies below the floor
    ``cap - vis_band`` (identity for vis_band = 0)."""
    if vis_band <= 0.0:
        return t
    return torch.where(t < rays[:, 7] - vis_band, MASKED_T_INIT, t)


def _fold(ids, counts, entries, rays, packed, tri, boxes, chunk_elems,
          group=None, vis_band=0.0):
    """plain_fold, or with ``group`` the gated schedule of ``fold_schedule``
    -> (t, id, folds per tile or None)."""
    Tl, M, P, C = check_inputs(ids, counts, entries, rays, packed, tri,
                               boxes)
    if vis_band < 0.0:
        raise ValueError(f"vis_band {vis_band} must not be negative")
    t_best, tri_best = _init(rays)
    folds = None
    if group is not None:
        if group < 1 or P % group:
            raise ValueError(f"group {group} must divide the tile size {P}")
        live = rays[:, 6] > 0.5
        inv = guarded_inv(rays[:, 3:6])
        alive = torch.ones((Tl, P // group), dtype=torch.bool,
                           device=rays.device)
        folds = torch.zeros(Tl, dtype=torch.int64, device=rays.device)
    step = max(1, chunk_elems // (P * C))
    n_slots = int(counts.max()) if Tl else 0
    for s in range(n_slots):
        act = torch.nonzero(counts > s).flatten()
        for a0 in range(0, act.numel(), step):
            tiles = act[a0:a0 + step]
            sid = ids[tiles, s].long()
            tb, ib = t_best[tiles], tri_best[tiles]
            t_new, id_new = _slot_hits(rays[tiles], packed, tri, sid)
            better = (t_new < tb) | ((t_new == tb) & (id_new < ib))
            if group is not None:
                # the group's exit vote (sticky: a group that ends stays
                # ended), then each ray's gate at its t before the slot
                lv = live[tiles]
                vote = (lv & (tb >= entries[tiles, s, None])).reshape(
                    -1, P // group, group).any(dim=2)
                al = alive[tiles] & vote
                alive[tiles] = al
                gate = (lv & al.repeat_interleave(group, dim=1)
                        & box_gate(boxes[sid], [rays[tiles, k]
                                                for k in range(3)],
                                   [inv[tiles, k] for k in range(3)], tb))
                folds[tiles] += gate.reshape(-1, P // group, group).any(
                    dim=2).sum(dim=1)
                better &= gate
            t_new = torch.where(better, t_new, tb)
            if group is not None and vis_band > 0.0:
                # a ray that folded the slot retires once its t is below
                # the floor: it gates and votes no more
                t_new = torch.where(gate, _retire(t_new, rays[tiles],
                                                  vis_band), t_new)
            t_best[tiles] = t_new
            tri_best[tiles] = torch.where(better, id_new, ib)
    return _retire(t_best, rays, vis_band), tri_best, folds


def fold_schedule(ids, counts, entries, rays, packed, tri, boxes, group,
                  vis_band: float = 0.0, chunk_elems: int = 1 << 24):
    """A plain count of the kernels' gated schedule, for groups of ``group``
    consecutive rays of each tile (P: K2's block per tile; ``k1_group(P)``:
    K1's blocks of at most K1_BLOCK_RAYS rays). Slot by slot, a group ends
    at the first slot whose entry no live ray of it reaches (with its t
    before the slot); otherwise each of its rays folds the slot's cluster if
    it passes the cluster's box gate at that t, and the group folds the
    cluster if any of its rays does. With ``vis_band`` > 0 a ray that folds
    the slot and ends below its floor retires (t = -3e38), as in the
    kernels. -> (t, id, clusters folded per tile summed over the groups
    (Tl,) int64). The gate skips only clusters that cannot improve a hit,
    so t is ``plain_fold``'s, and so is the id of every ray that did not
    retire."""
    return _fold(ids, counts, entries, rays, packed, tri, boxes, chunk_elems,
                 group, vis_band)


def dense_intersect_resident_plain(ids, counts, entries, rays, packed, tri,
                                   boxes, vis_band: float = 0.0):
    """K1's plain PyTorch version (``plain_fold``), counted."""
    dense_intersect_resident_plain.calls += 1
    return plain_fold(ids, counts, entries, rays, packed, tri, boxes,
                      vis_band)


dense_intersect_resident_plain.calls = 0


def fold_key(t, tri_id):
    """The gated fold's closest-hit key (``csrc/gated_fold.cuh:fold_key``)
    as int64, for tests: (t's float32 bits, the low 31 flipped for negative
    t) * 2^32 + (id + 1), whose order is the lexicographic order of
    (t, id)."""
    b = t.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    hi = b ^ ((b >> 31) & 0x7FFFFFFF)
    return hi * (1 << 32) + ((tri_id.to(torch.int64) + 1) & 0xFFFFFFFF)


def unpack_key(key):
    """``fold_key``'s inverse: int64 keys -> (t f32, id i32)."""
    hi = key >> 32
    bits = (hi ^ ((hi >> 31) & 0x7FFFFFFF)).to(torch.int32)
    return bits.view(torch.float32), ((key & 0xFFFFFFFF) - 1).to(torch.int32)


def load_fold_kernel(lib_name: str, source: str, symbol: str, n_ints: int,
                     flags=(), headers=HEADERS):
    """Build ``source`` (which includes ``headers``; NVCC_FLAGS and
    ``flags``) into ``build/lib_name`` and bind ``symbol(10 pointers, n_ints
    ints (the pack's rows last), the vis band (float), stream) ->
    cudaError_t``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = build_and_load(lib_name, [source], [nvcc] + NVCC_FLAGS + list(flags),
                         headers=headers)
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * n_ints
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def launch_fold(load, name, ids, counts, entries, rays, packed, tri, boxes,
                extra=(), counts_out=None, vis_band=0.0, intersector="bw"):
    """Check the inputs (a pack of ``intersector``'s rows), launch
    ``load()``'s kernel with (pointers, Tl, M, P, C, *extra, the pack's
    rows, vis_band) on the current stream and return (t, tri); raise if the
    launch fails. The rows pick the kernel's triangle test (12: BW, 9: MT).
    With ``counts_out`` (Tl, COUNT_COLS) int64, zero it and launch the
    counting instance; with ``vis_band`` > 0 the kernel's visibility
    instance runs."""
    Tl, M, P, C = check_inputs(ids, counts, entries, rays, packed, tri,
                               boxes, intersector)
    if P % 32 != 0 or not 0 < P <= 1024:
        raise ValueError(f"tile size {P} must be a multiple of 32 <= 1024")
    if vis_band < 0.0:
        raise ValueError(f"vis_band {vis_band} must not be negative")
    if counts_out is not None:
        if (tuple(counts_out.shape) != (Tl, COUNT_COLS)
                or counts_out.dtype != torch.int64
                or counts_out.device != rays.device
                or not counts_out.is_contiguous()):
            raise ValueError(f"counts_out must be contiguous int64 (Tl, "
                             f"{COUNT_COLS}) on {rays.device}")
        counts_out.zero_()
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
                 None if counts_out is None else counts_out.data_ptr(),
                 Tl, M, P, C, *extra, packed.shape[1], float(vis_band),
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return t, tri_out


def is_cpu(rays, counts_out=None):
    """True for CPU tensors (take the plain version), False for CUDA ones
    (launch the kernel); any other device raises, and so does a
    ``counts_out`` on the CPU: only a kernel has a schedule to count."""
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {rays.device}")
    if rays.device.type == "cpu" and counts_out is not None:
        raise ValueError("counts_out counts a CUDA kernel's work; the plain "
                         "version has none")
    return rays.device.type == "cpu"


@functools.cache
def _load_kernel():
    return load_fold_kernel("libdense_resident.so", SOURCE,
                            "dense_resident_launch", 6,
                            flags=GATED_FOLD_FLAGS)


def build():
    """Build and load the kernel library (it is otherwise built at the
    first launch)."""
    _load_kernel()


def dense_intersect_resident(ids, counts, entries, rays, packed, tri, boxes,
                             counts_out=None, vis_band: float = 0.0,
                             intersector: str = "bw"):
    """K1 on CUDA tensors (its counting instance given ``counts_out``, its
    visibility instance given ``vis_band`` > 0, its triangle test the
    ``intersector``'s, whose pack it needs); the plain version for tensors
    on the CPU."""
    if is_cpu(rays, counts_out):
        check_inputs(ids, counts, entries, rays, packed, tri, boxes,
                     intersector)
        return dense_intersect_resident_plain(ids, counts, entries, rays,
                                              packed, tri, boxes, vis_band)
    out = launch_fold(_load_kernel, "dense_resident", ids, counts, entries,
                      rays, packed, tri, boxes, extra=(packed.shape[0] - 1,),
                      counts_out=counts_out, vis_band=vis_band,
                      intersector=intersector)
    dense_intersect_resident.launches += 1
    return out


dense_intersect_resident.launches = 0
