"""Checkpoint / resume of progressive renders.

Counterpart of ``cudapathtracer_tpu/utils/checkpoint.py:save_checkpoint``
and ``load_checkpoint``, in the same format, so that a render saved by
either package resumes in the other. The accumulation scheme is the whole
loop state (a running mean, its Kahan compensation and the sample count,
kernel.cu:552), plus the base seed: every random draw is a function of
(seed, sample index, pixel index, site), so a resumed render equals the
uninterrupted one bit for bit.

Format: one .npz, saved to a temporary name and renamed into place, so a
crash never leaves a half-written checkpoint. Its members, each the dtype
and shape the JAX package writes: ``version`` (int64), ``img_x`` ...
``comp_z`` (R,) float32 in Morton order, ``n`` a 0-d int32 (the JAX
``AccumState.n``; the port's is a Python int), ``seed`` int64, and with a
config ``width``, ``height`` (``np.asarray`` of a Python int) and
``integrator`` (a numpy unicode scalar).

Sharded checkpoints (JAX checkpoint.py:96-224): each rank of a tile-sharded
render (parallel/) atomically writes ``<path>.p{rank}of{world}.npz`` with
the members ``version``, ``sharded``, ``process_index``,
``process_count``, ``n`` (0-d int32), ``seed``, ``num_pixels``, with a
config ``width``, ``height``, ``integrator``, and per accumulator leaf
``{leaf}_nshards`` and each shard i's flat values ``{leaf}_s{i}`` and
global Morton offset ``{leaf}_o{i}``, in the JAX package's dtypes. A port
rank writes one shard, its range; its loader takes any shards of its file
that tile its range exactly, so a single-process JAX save over several
devices resumes in a one-rank port, and a port save loads in the JAX
package on a mesh of one device per process.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..ops.vecmath import Vec3
from ..parallel.mesh import tile_range
from ..render.renderer import AccumState

_FORMAT_VERSION = 1


def save_checkpoint(path, state: AccumState, seed: int, cfg=None):
    """Atomic save. ``cfg`` (RenderConfig) is stored for shape validation."""
    payload = dict(
        version=_FORMAT_VERSION,
        img_x=state.img.x.cpu().numpy(),
        img_y=state.img.y.cpu().numpy(),
        img_z=state.img.z.cpu().numpy(),
        comp_x=state.comp.x.cpu().numpy(),
        comp_y=state.comp.y.cpu().numpy(),
        comp_z=state.comp.z.cpu().numpy(),
        n=np.asarray(state.n, np.int32),
        seed=np.asarray(seed, np.int64),
    )
    _write(path, payload, cfg)


def _write(path, payload: dict, cfg):
    """``payload`` (with ``cfg``'s size and integrator) saved to a
    temporary name and renamed onto ``path``."""
    if cfg is not None:
        payload["width"] = np.asarray(cfg.width)
        payload["height"] = np.asarray(cfg.height)
        payload["integrator"] = np.asarray(cfg.integrator)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _check_header(z, cfg):
    """The format version and, given ``cfg``, the image size and the
    integrator; raised, not asserted, so that the checks hold under
    python -O (AssertionError, as the JAX package's asserts raise)."""
    if int(z["version"]) != _FORMAT_VERSION:
        raise AssertionError(f"checkpoint format {int(z['version'])}")
    if cfg is not None:
        for key in ("width", "height", "integrator"):
            saved = z[key].item()
            if saved != getattr(cfg, key):
                raise AssertionError(
                    f"checkpoint {key} {saved!r} != the config's "
                    f"{getattr(cfg, key)!r}")


def load_checkpoint(path, cfg=None, *, device="cuda"):
    """-> (AccumState on ``device``, seed). Validates the image size and
    the integrator against ``cfg`` when given (an AssertionError on a
    mismatch, as in the JAX package)."""
    with np.load(path, allow_pickle=False) as z:
        _check_header(z, cfg)

        def t(name):
            return torch.from_numpy(np.ascontiguousarray(z[name])).to(device)

        state = AccumState(
            img=Vec3(t("img_x"), t("img_y"), t("img_z")),
            comp=Vec3(t("comp_x"), t("comp_y"), t("comp_z")),
            n=int(z["n"]),
        )
        return state, int(z["seed"])


# ---------------------------------------------------------------------------
# sharded checkpoints of tile-sharded renders
# ---------------------------------------------------------------------------

_LEAVES = ("img_x", "img_y", "img_z", "comp_x", "comp_y", "comp_z")


def _state_leaves(state: AccumState):
    return dict(zip(_LEAVES, (*state.img, *state.comp)))


def shard_path(path, process_index: int, process_count: int) -> str:
    return f"{path}.p{process_index}of{process_count}.npz"


def save_checkpoint_sharded(path, state: AccumState, seed: int, cfg, mesh):
    """The rank's atomic save of ``state``, its slice of a tile-sharded
    render (parallel/shard.py), to ``shard_path(path, rank, world)``: one
    shard per leaf at the range's global offset. No rank gathers another's
    pixels. ``cfg`` may be None (then the size and the integrator are not
    stored)."""
    r = state.img.x.shape[0]
    start, _ = tile_range(r * mesh.world, mesh)
    payload = dict(
        version=_FORMAT_VERSION,
        sharded=np.asarray(1),
        process_index=np.asarray(mesh.rank),
        process_count=np.asarray(mesh.world),
        n=np.asarray(state.n, np.int32),
        seed=np.asarray(seed, np.int64),
        num_pixels=np.asarray(r * mesh.world),
    )
    for name, leaf in _state_leaves(state).items():
        payload[f"{name}_nshards"] = np.asarray(1)
        payload[f"{name}_s0"] = leaf.cpu().numpy().reshape(-1)
        payload[f"{name}_o0"] = np.asarray(start)
    _write(shard_path(path, mesh.rank, mesh.world), payload, cfg)


def load_checkpoint_sharded(path, mesh, cfg=None, *, device=None):
    """-> (the rank's AccumState on ``device``, default the mesh's, seed).

    Each rank reads only its own ``shard_path(path, rank, world)`` and
    assembles its range from the shards there, which must tile it
    exactly. Raises if the file is missing (FileNotFoundError: the rank
    count changed), if the file was saved by another rank or rank count,
    if a shard is missing or overlaps, on a config mismatch, and, across
    the ranks (an ``all_gather``), if the ranks'
    ``(n, seed)`` differ: a mixed set would average two renders."""
    device = mesh.device if device is None else device
    target = shard_path(path, mesh.rank, mesh.world)
    if not os.path.exists(target):
        raise FileNotFoundError(
            f"{target} not found: sharded checkpoints are per rank; resume "
            "with the rank count that saved them")
    with np.load(target, allow_pickle=False) as z:
        _check_header(z, cfg)
        saved = (int(z["process_index"]), int(z["process_count"]))
        if saved != (mesh.rank, mesh.world):
            raise AssertionError(f"{target} holds rank {saved[0]} of "
                                 f"{saved[1]}")
        n, seed = int(z["n"]), int(z["seed"])
        start, stop = tile_range(int(z["num_pixels"]), mesh)

        def leaf(name):
            shards = {}
            for i in range(int(z[f"{name}_nshards"])):
                shards[int(z[f"{name}_o{i}"])] = z[f"{name}_s{i}"]
            parts, at = [], start
            while at < stop:
                if at not in shards:
                    raise AssertionError(
                        f"{target}: no {name} shard at offset {at} (was the "
                        "mesh layout changed?)")
                parts.append(shards[at])
                at += shards[at].shape[0]
            if at != stop:
                raise AssertionError(f"{target}: the {name} shards overrun "
                                     f"the range [{start}, {stop})")
            return torch.from_numpy(np.concatenate(parts)).to(device)

        state = AccumState(
            img=Vec3(leaf("img_x"), leaf("img_y"), leaf("img_z")),
            comp=Vec3(leaf("comp_x"), leaf("comp_y"), leaf("comp_z")),
            n=n)
    if mesh.world > 1:
        mine = torch.tensor([n, seed], dtype=torch.int64, device=mesh.device)
        every = [torch.empty_like(mine) for _ in range(mesh.world)]
        dist.all_gather(every, mine)
        every = torch.stack(every).cpu()
        if not bool((every == every[0]).all()):
            raise AssertionError("inconsistent checkpoint set across ranks: "
                                 f"(n, seed) = {every.tolist()}")
    return state, seed
