"""Binned-SAH BVH build, its threaded flat encoding, and the containers of
the packet engine's cluster level.

Counterpart of ``cudapathtracer_tpu/accel/bvh.py``, with the containers'
fields as torch tensors. The build is the JAX package's numpy twin of the
native builder (csrc/bvh_builder.cpp, accel/native.py), copied: top-down
recursion, centroids binned into a 3x3x3 grid (the reference's gridDim,
BVH.h:166), all 3 axes x 3 slice planes scored by the binned SAH in double
precision (BVH.h:196, 246-248), centroid-cell partitioning (BVH.h:295-313)
and an arbitrary halving for degenerate splits (BVH.h:263-288), with the
reference's grid-fill bug (BVH.h:190) fixed and leaves of up to
``leaf_size`` triangles. It builds the native builder's tree bit for bit,
far slower on large scenes; render/renderer.py uses it when asked
(``build_bvh_for_scene(use_native=False)``).

FlatBVH: N nodes in DFS preorder. An interior node hit continues to i+1, a
miss jumps to ``node_skip[i]`` (N = done); a leaf tests its ``leaf_tri``
block (padded with T, a degenerate sentinel) and jumps to its skip.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.constants import MAX_BVH_DEPTH

GRID_DIM = 3  # the reference's gridDim (BVH.h:166)


class FlatBVH(NamedTuple):
    node_lo_x: torch.Tensor
    node_lo_y: torch.Tensor
    node_lo_z: torch.Tensor
    node_hi_x: torch.Tensor
    node_hi_y: torch.Tensor
    node_hi_z: torch.Tensor
    node_skip: torch.Tensor   # (N,) i32
    node_leaf: torch.Tensor   # (N,) i32, -1 = interior
    leaf_tri: torch.Tensor    # (NL, L) i32, pad = num_tris

    @property
    def num_nodes(self):
        return self.node_skip.shape[0]

    @property
    def num_leaves(self):
        return self.leaf_tri.shape[0]

    @property
    def leaf_size(self):
        return self.leaf_tri.shape[1]


class BVHMeta(NamedTuple):
    """Host metadata of a build."""

    depth: int
    num_tris: int


class Accel(NamedTuple):
    """The fine per-ray BVH plus the coarse cluster level: (K,) cluster
    boxes and the (K, C) triangle blocks (padded with T)."""

    fine: FlatBVH
    cl_lo_x: torch.Tensor
    cl_lo_y: torch.Tensor
    cl_lo_z: torch.Tensor
    cl_hi_x: torch.Tensor
    cl_hi_y: torch.Tensor
    cl_hi_z: torch.Tensor
    cl_tri: torch.Tensor      # (K, C) i32


# ---------------------------------------------------------------------------
# refit: the boxes about moved vertices, the topology kept
# ---------------------------------------------------------------------------

def _tri_boxes(verts, tris):
    """(T + 1, 3) lo and hi of each triangle's vertices, the last row the
    padding sentinel's empty box (+inf, -inf)."""
    corners = [torch.stack([c[t.long()] for c in verts], 1) for t in tris]
    lo = torch.minimum(torch.minimum(corners[0], corners[1]), corners[2])
    hi = torch.maximum(torch.maximum(corners[0], corners[1]), corners[2])
    inf = lo.new_full((1, 3), float("inf"))
    return torch.cat([lo, inf]), torch.cat([hi, -inf])


def _range_boxes(lo, hi, first, end):
    """min(lo[first:end]) and max(hi[first:end]) for each range, by a
    sparse table over the rows (every range holds one row at least)."""
    n = lo.shape[0]
    los, his, w = [lo], [hi], 1
    while 2 * w <= n:
        a, b = los[-1], his[-1]
        pad = n - (a.shape[0] - w)
        los.append(torch.cat([torch.minimum(a[:-w], a[w:]),
                              lo.new_full((pad, 3), float("inf"))]))
        his.append(torch.cat([torch.maximum(b[:-w], b[w:]),
                              hi.new_full((pad, 3), float("-inf"))]))
        w *= 2
    table_lo, table_hi = torch.stack(los), torch.stack(his)  # (levels, n, 3)
    k = torch.floor(torch.log2((end - first).double())).long()
    tail = end - torch.pow(2, k)
    return (torch.minimum(table_lo[k, first], table_lo[k, tail]),
            torch.maximum(table_hi[k, first], table_hi[k, tail]))


def refit(accel: Accel, verts, tris) -> Accel:
    """``accel`` with every box (the fine nodes' and the clusters') the
    exact bounds of its triangles at the vertices ``verts`` (Vec3 of (V,)),
    its topology (which triangles each node and cluster holds) kept; ``tris``:
    the (T,) vertex ids of the triangles' three corners. At the vertices it
    was built from, the boxes are the build's, value for value. A traversal
    through a refit tree finds every triangle wherever its vertices moved;
    only its speed depends on how far they moved."""
    tlo, thi = _tri_boxes(verts, tris)
    fine = accel.fine
    llo = tlo[fine.leaf_tri.long()].amin(1)   # (NL, 3) the leaves' boxes
    lhi = thi[fine.leaf_tri.long()].amax(1)
    # in preorder a node's subtree is the nodes [i, node_skip[i]): its
    # leaves are a run of consecutive leaf ids
    is_leaf = (fine.node_leaf >= 0).to(torch.int64)
    before = torch.cat([is_leaf.new_zeros(1), torch.cumsum(is_leaf, 0)])
    nlo, nhi = _range_boxes(llo, lhi, before[:-1],
                            before[fine.node_skip.long()])
    clo = tlo[accel.cl_tri.long()].amin(1)
    chi = thi[accel.cl_tri.long()].amax(1)
    return accel._replace(
        fine=fine._replace(**_columns("node_lo", nlo),
                           **_columns("node_hi", nhi)),
        **_columns("cl_lo", clo), **_columns("cl_hi", chi))


def _columns(prefix, box):
    """{prefix_x, prefix_y, prefix_z}: the (N, 3) boxes' columns."""
    return {f"{prefix}_{a}": box[:, i].contiguous()
            for i, a in enumerate("xyz")}


# ---------------------------------------------------------------------------
# host-side build tree
# ---------------------------------------------------------------------------

@dataclass
class _Node:
    lo: np.ndarray
    hi: np.ndarray
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    tri_ids: Optional[np.ndarray] = None  # leaf payload
    depth: int = 1

    @property
    def is_leaf(self):
        return self.tri_ids is not None


def _surface(lo, hi):
    d = hi - lo
    return 2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2])


def _build_recurse(lo, hi, centers, ids, leaf_size):
    """lo / hi / centers: (n, 3) triangle boxes and centroids of the ids
    (n,)."""
    n = ids.shape[0]
    blo, bhi = lo.min(axis=0), hi.max(axis=0)
    if n <= leaf_size:
        return _Node(blo, bhi, tri_ids=ids, depth=1)
    total_w = _surface(blo.astype(np.float64), bhi.astype(np.float64))

    # the centroids' cells of the 3x3x3 grid over the working set's box
    dim_units = (bhi - blo) / GRID_DIM
    safe_units = np.where(dim_units == 0, 1.0, dim_units)
    cell = np.clip(((centers - blo) / safe_units).astype(np.int64), 0,
                   GRID_DIM - 1)
    flat = (cell[:, 0] * GRID_DIM + cell[:, 1]) * GRID_DIM + cell[:, 2]
    counts = np.bincount(flat, minlength=GRID_DIM**3).reshape(
        GRID_DIM, GRID_DIM, GRID_DIM)
    glo = np.full((GRID_DIM**3, 3), np.inf)
    ghi = np.full((GRID_DIM**3, 3), -np.inf)
    np.minimum.at(glo, flat, lo)
    np.maximum.at(ghi, flat, hi)
    glo = glo.reshape(GRID_DIM, GRID_DIM, GRID_DIM, 3)
    ghi = ghi.reshape(GRID_DIM, GRID_DIM, GRID_DIM, 3)

    def side_weight(sel, cnt):
        if cnt == 0:
            return 0.0        # an empty side adds cnt * w = 0
        m = counts[sel].reshape(-1) > 0
        return _surface(glo[sel].reshape(-1, 3)[m].min(axis=0),
                        ghi[sel].reshape(-1, 3)[m].max(axis=0))

    best = None  # (score, axis, slice, countL, countR)
    for axis in range(3):
        for sl in range(GRID_DIM):
            sel_l = [slice(None)] * 3
            sel_l[axis] = slice(0, sl)
            sel_r = [slice(None)] * 3
            sel_r[axis] = slice(sl, GRID_DIM)
            sel_l, sel_r = tuple(sel_l), tuple(sel_r)
            cl = int(counts[sel_l].sum())
            cr = int(counts[sel_r].sum())
            # the score in double precision, as the native builder and the
            # reference form it: float32 would tie-break into another tree
            score = (float(cl) * float(side_weight(sel_l, cl))
                     / float(total_w)
                     + float(cr) * float(side_weight(sel_r, cr))
                     / float(total_w))
            if best is None or score < best[0]:
                best = (score, axis, sl, cl, cr)

    _, axis, sl, cl, cr = best
    if cl == 0 or cr == 0:
        # degenerate split: arbitrary halving (BVH.h:263-288)
        left_sel = np.zeros(n, bool)
        left_sel[:n // 2] = True
    else:
        left_sel = cell[:, axis] < sl
    ln = _build_recurse(lo[left_sel], hi[left_sel], centers[left_sel],
                        ids[left_sel], leaf_size)
    rn = _build_recurse(lo[~left_sel], hi[~left_sel], centers[~left_sel],
                        ids[~left_sel], leaf_size)
    return _Node(blo, bhi, left=ln, right=rn,
                 depth=max(ln.depth, rn.depth) + 1)


def _subtree_size(node: _Node) -> int:
    """Flat nodes in this subtree (memoized on the node)."""
    sz = getattr(node, "_size", None)
    if sz is None:
        sz = 1 if node.is_leaf else (1 + _subtree_size(node.left)
                                     + _subtree_size(node.right))
        node._size = sz
    return sz


def _flatten_threaded(root: _Node, num_tris: int, leaf_size: int):
    """The tree in preorder with skip links -> host arrays (lo (N, 3), hi
    (N, 3), skip (N,), leaf id (N,), leaf_tri (NL, leaf_size))."""
    nodes, skips, leaf_blocks = [], [], []

    def rec(node: _Node, skip_to: int):
        idx = len(nodes)
        skips.append(skip_to)
        if node.is_leaf:
            block = np.full(leaf_size, num_tris, np.int32)
            block[: node.tri_ids.shape[0]] = node.tri_ids
            nodes.append((node.lo, node.hi, len(leaf_blocks)))
            leaf_blocks.append(block)
        else:
            nodes.append((node.lo, node.hi, -1))
            # the right child follows the whole left subtree, so every skip
            # is final when emitted
            right_idx = idx + 1 + _subtree_size(node.left)
            rec(node.left, skip_to=right_idx)
            assert len(nodes) == right_idx
            rec(node.right, skip_to=skip_to)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10 * (root.depth + 50)))
    try:
        total = _subtree_size(root)
        rec(root, skip_to=total)  # the root's miss ends the traversal
    finally:
        sys.setrecursionlimit(old)
    assert len(nodes) == total

    lo = np.stack([nd[0] for nd in nodes]).astype(np.float32)
    hi = np.stack([nd[1] for nd in nodes]).astype(np.float32)
    leaf_id = np.array([nd[2] for nd in nodes], np.int32)
    skip = np.array(skips, np.int32)
    leaf_tri = (np.stack(leaf_blocks) if leaf_blocks
                else np.zeros((0, leaf_size), np.int32))
    return lo, hi, skip, leaf_id, leaf_tri


def build_flat_host(verts, tri_indices, leaf_size: int = 4):
    """The numpy twin's build from host arrays, verts (V, 3) f32 and
    tri_indices (T, 3) -> (lo (N, 3), hi (N, 3), skip, leaf id, leaf_tri,
    depth), host arrays. Raises past MAX_BVH_DEPTH, as the reference does
    (kernel.cu:627-631)."""
    verts = np.asarray(verts, np.float32)
    tri_indices = np.asarray(tri_indices, np.int64)
    T = tri_indices.shape[0]
    if T < 1:
        raise ValueError("empty scene")
    v0, v1, v2 = (verts[tri_indices[:, k]] for k in range(3))
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        root = _build_recurse(lo, hi, 0.5 * (lo + hi),
                              np.arange(T, dtype=np.int32), leaf_size)
    finally:
        sys.setrecursionlimit(old)
    if root.depth >= MAX_BVH_DEPTH:
        raise RuntimeError(f"BVH depth {root.depth} >= {MAX_BVH_DEPTH}")
    return (*_flatten_threaded(root, T, leaf_size), root.depth)


def build_bvh(verts, tri_indices, leaf_size: int = 4, device="cuda"):
    """The numpy twin's FlatBVH on ``device`` and its BVHMeta (JAX
    accel/bvh.py:build_bvh)."""
    lo, hi, skip, leaf_id, leaf_tri, depth = build_flat_host(
        verts, tri_indices, leaf_size)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    flat = FlatBVH(*(t(lo[:, i]) for i in range(3)),
                   *(t(hi[:, i]) for i in range(3)), node_skip=t(skip),
                   node_leaf=t(leaf_id), leaf_tri=t(leaf_tri))
    return flat, BVHMeta(depth=depth, num_tris=int(np.shape(tri_indices)[0]))


def as_fine(bvh) -> FlatBVH:
    """Accept either an Accel bundle or a bare FlatBVH."""
    return bvh.fine if isinstance(bvh, Accel) else bvh


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def clusters_from_flat(coarse: FlatBVH):
    """Host arrays (cl_lo (K, 3), cl_hi (K, 3), cl_tri (K, C)) of a coarse
    FlatBVH's leaves, in leaf-id order."""
    nl = _host(coarse.node_leaf)
    sel = np.flatnonzero(nl >= 0)
    sel = sel[np.argsort(nl[sel])]  # preorder assignment: already sorted
    lo = np.stack([_host(c)[sel] for c in coarse[0:3]], axis=1)
    hi = np.stack([_host(c)[sel] for c in coarse[3:6]], axis=1)
    return lo, hi, _host(coarse.leaf_tri)


def validate(flat: FlatBVH, meta: BVHMeta):
    """Structural invariants: every triangle in exactly one leaf slot, skip
    links strictly forward and within the node count, leaf ids unique and
    one per leaf block. Raises AssertionError, else True."""
    leaf_tri = _host(flat.leaf_tri)
    tri_seen = leaf_tri[leaf_tri < meta.num_tris]
    assert tri_seen.size == meta.num_tris, (tri_seen.size, meta.num_tris)
    assert np.unique(tri_seen).size == meta.num_tris
    skip = _host(flat.node_skip)
    n = skip.shape[0]
    assert np.all(skip > np.arange(n)), "skip links must move forward"
    assert np.all(skip <= n)
    leaf_id = _host(flat.node_leaf)
    lids = leaf_id[leaf_id >= 0]
    assert np.unique(lids).size == lids.size
    assert lids.size == leaf_tri.shape[0]
    return True
