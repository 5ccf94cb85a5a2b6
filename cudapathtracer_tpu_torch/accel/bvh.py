"""Acceleration structure containers: the threaded flat BVH and the cluster
level of the packet engine.

Counterparts of ``FlatBVH`` and ``Accel`` in
``cudapathtracer_tpu/accel/bvh.py``, with the same fields as torch tensors.
The build itself is host code in render/renderer.py (the native builder,
accel/native.py); the JAX package's numpy twin builder is not ported.

FlatBVH: N nodes in DFS preorder. An interior node hit continues to i+1, a
miss jumps to ``node_skip[i]`` (N = done); a leaf tests its ``leaf_tri``
block (padded with T, a degenerate sentinel) and jumps to its skip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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

