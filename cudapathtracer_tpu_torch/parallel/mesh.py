"""The tile mesh: ranks over cards, the Morton pixel axis split among them.

Counterpart of ``cudapathtracer_tpu/parallel/mesh.py``. The JAX package
builds a 1-D device mesh whose ``tiles`` axis shards the pixel arrays, and
``shard_map`` hands device i the contiguous Morton range
[i R / W, (i + 1) R / W) of the R pixels. Here a rank is one process with
one device, started by ``torchrun`` (``python -m torch.distributed.run``)
or by ``torch.multiprocessing.spawn``, and it owns the same contiguous
range, so a checkpoint's shard offsets mean the same in both packages. The
scene, the BVH and the camera are replicated: every rank builds them from
the same inputs (the native BVH build is deterministic).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist


class TileMesh(NamedTuple):
    """One rank's view of the mesh: its index, the number of ranks and its
    device; its collectives run over the default process group. The
    forward render needs no group, so a mesh of any rank can be made by
    hand to render that rank's range alone."""

    rank: int
    world: int
    device: torch.device


def _rank_device(device, local_rank: int) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev}: no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
    return dev


def initialize_distributed(backend=None, init_method=None, world_size=None,
                           rank=None, device=None, timeout=None) -> TileMesh:
    """Form the default process group and return this rank's mesh.

    Given nothing, it reads torchrun's environment: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``
    (rendezvous ``env://``). Without that environment and with one rank it
    forms a real one-rank group on an in-memory store (``dist.HashStore``),
    whose collectives run as in a larger group. Several ranks without
    torchrun need ``init_method`` (e.g. ``tcp://localhost:<port>``),
    ``world_size`` and ``rank``.

    ``device``: the rank's device, the card ``cuda:{LOCAL_RANK}`` unless
    named ("cuda" without an index means that card too; ``LOCAL_RANK``
    defaults to the rank). ``backend``: NCCL for a CUDA device, gloo for
    the CPU, unless the caller names one; gloo also takes CUDA tensors (it
    stages them through the host), which lets two ranks share one card,
    where NCCL refuses ("Duplicate GPU"). A failed initialization raises;
    the backend is never switched. ``timeout``: a ``timedelta`` for the
    rendezvous and the collectives (default: torch's)."""
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    dev = _rank_device(device, int(env.get("LOCAL_RANK", rank)))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, world_size=world_size, rank=rank,
              timeout=timeout)
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is not None:
        dist.init_process_group(init_method=init_method, **kw)
    elif world_size == 1:
        dist.init_process_group(store=dist.HashStore(), **kw)
    else:
        raise ValueError(f"a group of {world_size} ranks needs init_method "
                         "or torchrun's MASTER_ADDR and MASTER_PORT")
    return make_tile_mesh(dev)


def make_tile_mesh(device) -> TileMesh:
    """The mesh of the initialized default process group for this rank's
    ``device``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first")
    return TileMesh(rank=dist.get_rank(), world=dist.get_world_size(),
                    device=torch.device(device))


def tile_range(num_pixels: int, mesh: TileMesh) -> tuple[int, int]:
    """The rank's Morton range [start, stop): the split ``shard_map`` makes
    of the ``tiles`` axis. The pixels must divide evenly."""
    if num_pixels % mesh.world:
        raise ValueError(f"{num_pixels} pixels do not split over "
                         f"{mesh.world} ranks")
    r = num_pixels // mesh.world
    return mesh.rank * r, (mesh.rank + 1) * r


def _map_pixels(fn, x):
    """``fn`` over a tensor, or over every tensor of a NamedTuple (Vec3,
    AccumState); other values (AccumState.n) are replicated and pass
    through."""
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map_pixels(fn, v) for v in x))
    return x


def shard_pixels(mesh: TileMesh, x):
    """The rank's range of a pixel-axis tensor (or of each tensor of a
    Vec3 or AccumState)."""
    return _map_pixels(lambda t: t[slice(*tile_range(t.shape[0], mesh))], x)


def gather_pixels(mesh: TileMesh, x):
    """The whole image from the ranks' ranges: ``all_gather`` of each
    tensor over the ranks, concatenated in rank order. Every rank
    must call it with tensors of one shape and dtype."""
    def gather(t):
        parts = [torch.empty_like(t) for _ in range(mesh.world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    return _map_pixels(gather, x)
