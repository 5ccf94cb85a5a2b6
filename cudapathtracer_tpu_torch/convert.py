"""Carry state from the JAX package into the port.

The input is the JAX package's NamedTuples as dicts of numpy arrays keyed by
their field names (``to_numpy_dict`` makes them without importing JAX: it
only reads fields and calls ``np.asarray``). A ``Vec3`` field is a dict with
keys x, y, z. The outputs are the port's containers on ``device``: the same
scene, accel structure and camera render the same image in both packages,
and a render begun in JAX can be resumed in the port, whole or as one
rank's range of a tile-sharded render.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel.bvh import Accel, FlatBVH
from .diff.edge_sampling import EdgeTable
from .diff.render_grad import GradTargets
from .models.scene import Scene
from .ops.vecmath import Vec3
from .parallel.mesh import TileMesh, shard_pixels
from .render.camera import Camera
from .render.renderer import AccumState


def to_numpy_dict(nt):
    """A NamedTuple of arrays (nested NamedTuples included) -> nested dict
    of numpy arrays; other values pass through unchanged."""
    if hasattr(nt, "_fields"):
        return {f: to_numpy_dict(getattr(nt, f)) for f in nt._fields}
    if hasattr(nt, "__array__"):
        return np.asarray(nt)
    return nt


def _t(a, device, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def _vec3(v, device):
    return Vec3(*(_t(v[c], device, np.float32) for c in "xyz"))


def scene_from_jax(d: dict, device) -> Scene:
    """JAX ``Scene`` fields -> port Scene, host geometry copies included."""
    verts = np.stack([np.asarray(d["verts"][c], np.float32) for c in "xyz"],
                     axis=1)
    tris = np.stack([np.asarray(d[k], np.int32)
                     for k in ("tri_v0", "tri_v1", "tri_v2")], axis=1)
    i32 = np.int32
    return Scene(
        verts=_vec3(d["verts"], device),
        tri_v0=_t(d["tri_v0"], device, i32),
        tri_v1=_t(d["tri_v1"], device, i32),
        tri_v2=_t(d["tri_v2"], device, i32),
        tri_norm=_vec3(d["tri_norm"], device),
        tri_mat=_t(d["tri_mat"], device, i32),
        mat_albedo=_vec3(d["mat_albedo"], device),
        mat_emission=_vec3(d["mat_emission"], device),
        lights=_t(d["lights"], device, i32),
        total_light_area=_t(d["total_light_area"], device, np.float32),
        sph_center=_vec3(d["sph_center"], device),
        sph_radius=_t(d["sph_radius"], device, np.float32),
        sph_mat=_t(d["sph_mat"], device, i32),
        host_verts=verts,
        host_tris=tris,
    )


def flat_bvh_from_jax(d: dict, device) -> FlatBVH:
    return FlatBVH(**{f: _t(d[f], device) for f in FlatBVH._fields})


def accel_from_jax(d: dict, device) -> Accel:
    """JAX ``Accel`` fields (its ``fine`` FlatBVH included) -> the port's."""
    return Accel(fine=flat_bvh_from_jax(d["fine"], device),
                 **{f: _t(d[f], device) for f in Accel._fields[1:]})


def camera_from_jax(d: dict, device) -> Camera:
    def f(v):
        return _t(v, device, np.float32)

    return Camera(pos=Vec3(*(f(d["pos"][c]) for c in "xyz")),
                  dist_from_film=f(d["dist_from_film"]),
                  focal_length=f(d["focal_length"]), radius=f(d["radius"]),
                  width=int(d["width"]), height=int(d["height"]))


def accum_from_jax(d: dict, device) -> AccumState:
    """JAX ``AccumState`` -> port AccumState: the running mean, the Kahan
    compensation and the sample count."""
    return AccumState(img=_vec3(d["img"], device),
                      comp=_vec3(d["comp"], device), n=int(d["n"]))


def accum_tile_from_jax(d: dict, mesh: TileMesh, device=None) -> AccumState:
    """The rank's Morton range of a JAX ``AccumState`` (a whole image's, or
    a sharded one read back whole) on ``device``, default the mesh's: the
    ``state`` a rank passes to ``parallel.shard.render_sharded``."""
    return shard_pixels(mesh, accum_from_jax(
        d, mesh.device if device is None else device))


def targets_from_jax(d: dict, device) -> GradTargets:
    """JAX ``GradTargets`` (parameters or their gradients) -> the port's,
    plain tensors (``targets_of`` makes leaves that require grad)."""
    return GradTargets(verts=_vec3(d["verts"], device),
                       albedo=_vec3(d["albedo"], device),
                       emission=_vec3(d["emission"], device),
                       sph_center=_vec3(d["sph_center"], device),
                       sph_radius=_t(d["sph_radius"], device, np.float32))


def edge_table_from_jax(d: dict, device) -> EdgeTable:
    """JAX ``EdgeTable`` -> the port's (int32 ev0, ev1, fa, fb)."""
    return EdgeTable(*(_t(d[f], device, np.int32)
                       for f in EdgeTable._fields))
