"""Scene representation: SoA tensors on one device.

Counterpart of ``cudapathtracer_tpu/models/scene.py`` (reference:
modelLoader.h:14-41, 162-206): vertices, triangle vertex indices, face
normals from the winding, material ids, albedo and emission tables, the
emissive-triangle list and the total light area, plus the optional analytic
sphere block.

The scene keeps host copies of its geometry (``host_verts``, ``host_tris``)
beside the device tensors, as the JAX package's ``register_host_geometry``
does, so the accel build never reads the geometry back from the device;
``merge_scenes`` concatenates them too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.vecmath import Vec3, cross, gather, length, normalized, take_clip
from ..utils.si import check_area, si_area


class Scene(NamedTuple):
    verts: Vec3              # (V,) components
    tri_v0: torch.Tensor     # (T,) int32
    tri_v1: torch.Tensor     # (T,) int32
    tri_v2: torch.Tensor     # (T,) int32
    tri_norm: Vec3           # (T,) face normals (modelLoader.h:201 winding)
    tri_mat: torch.Tensor    # (T,) int32
    mat_albedo: Vec3         # (M,)
    mat_emission: Vec3       # (M,)
    lights: torch.Tensor     # (L,) int32 scene-triangle indices of emissives
    total_light_area: torch.Tensor  # () f32
    sph_center: Vec3         # (S,)
    sph_radius: torch.Tensor  # (S,)
    sph_mat: torch.Tensor    # (S,) int32
    host_verts: np.ndarray   # (V, 3) f32 host copy of the geometry
    host_tris: np.ndarray    # (T, 3) i32

    @property
    def num_tris(self):
        return self.tri_v0.shape[0]

    @property
    def num_verts(self):
        return self.verts.x.shape[0]

    @property
    def num_mats(self):
        return self.mat_albedo.x.shape[0]

    @property
    def num_lights(self):
        return self.lights.shape[0]

    @property
    def num_spheres(self):
        return self.sph_radius.shape[0]

    @property
    def device(self):
        return self.tri_v0.device


def _as_vec3(a, device):
    a = np.asarray(a, np.float32).reshape(-1, 3)
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(device)
                  for i in range(3)))


def make_scene(verts, tri_indices, tri_mats, albedo, emission, *,
               flip_normals=False, device="cuda", spheres=None) -> Scene:
    """Assemble a Scene from host arrays onto ``device``.

    The loader semantics of the JAX package's ``make_scene``: normals
    ``normalize(cross(v1-v0, v2-v0))`` computed on the host in numpy
    (negated with ``flip_normals``, the loader's flag), emissive detection
    by ``emission.r != 0`` (modelLoader.h:191), the light area summed on
    the host (modelLoader.h:194-197) and typed as an area before it crosses
    to the device (``siArea``, kernel.cu:422, 468; utils/si.py)."""
    verts = np.asarray(verts, np.float32)
    tri_indices = np.asarray(tri_indices, np.int32)
    tri_mats = np.asarray(tri_mats, np.int32)
    albedo = np.asarray(albedo, np.float32).reshape(-1, 3)
    emission = np.asarray(emission, np.float32).reshape(-1, 3)

    v0 = verts[tri_indices[:, 0]]
    v1 = verts[tri_indices[:, 1]]
    v2 = verts[tri_indices[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    nl = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.where(nl == 0, 1.0, nl)
    if flip_normals:
        n = -n

    is_light = emission[tri_mats, 0] != 0.0
    lights = np.nonzero(is_light)[0].astype(np.int32)
    areas = 0.5 * np.linalg.norm(
        np.cross(v1[lights] - v0[lights], v2[lights] - v0[lights]), axis=1
    )
    total_light_area = np.float32(check_area(si_area(float(areas.sum()))))

    if spheres is None:
        sc = np.zeros((0, 3), np.float32)
        sr = np.zeros((0,), np.float32)
        sm = np.zeros((0,), np.int32)
    else:
        sc, sr, sm = spheres
        sc = np.asarray(sc, np.float32).reshape(-1, 3)
        sr = np.asarray(sr, np.float32).reshape(-1)
        sm = np.asarray(sm, np.int32).reshape(-1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Scene(
        verts=_as_vec3(verts, device),
        tri_v0=t(tri_indices[:, 0]),
        tri_v1=t(tri_indices[:, 1]),
        tri_v2=t(tri_indices[:, 2]),
        tri_norm=_as_vec3(n.astype(np.float32), device),
        tri_mat=t(tri_mats),
        mat_albedo=_as_vec3(albedo, device),
        mat_emission=_as_vec3(emission, device),
        lights=t(lights),
        total_light_area=torch.tensor(total_light_area, device=device),
        sph_center=_as_vec3(sc, device),
        sph_radius=t(sr),
        sph_mat=t(sm),
        host_verts=verts,
        host_tris=tri_indices,
    )


def host_geometry(scene: Scene):
    """(verts (V, 3) f32, tris (T, 3) i32) host arrays of the scene. The
    JAX package keeps them in a cache keyed by the device array and gives
    None for a scene it did not build; a port Scene carries them."""
    return scene.host_verts, scene.host_tris


def merge_scenes(a: Scene, b: Scene) -> Scene:
    """Concatenate two scenes on one device (the reference appends
    successive loadOBJ calls into one global SoA, modelLoader.h:43-47; JAX
    ``scene.py:merge_scenes``): ``b``'s vertex ids, material ids and light
    ids are offset by ``a``'s counts, and the host geometry is concatenated
    the same way, so the accel build covers both parts."""
    if a.device != b.device:
        raise ValueError(f"scenes on {a.device} and {b.device}")
    vo, mo, to = a.num_verts, a.num_mats, a.num_tris

    def cat(x, y):
        return torch.cat([x, y])

    def catv(x: Vec3, y: Vec3) -> Vec3:
        return Vec3(cat(x.x, y.x), cat(x.y, y.y), cat(x.z, y.z))

    return Scene(
        verts=catv(a.verts, b.verts),
        tri_v0=cat(a.tri_v0, b.tri_v0 + vo),
        tri_v1=cat(a.tri_v1, b.tri_v1 + vo),
        tri_v2=cat(a.tri_v2, b.tri_v2 + vo),
        tri_norm=catv(a.tri_norm, b.tri_norm),
        tri_mat=cat(a.tri_mat, b.tri_mat + mo),
        mat_albedo=catv(a.mat_albedo, b.mat_albedo),
        mat_emission=catv(a.mat_emission, b.mat_emission),
        lights=cat(a.lights, b.lights + to),
        total_light_area=a.total_light_area + b.total_light_area,
        sph_center=catv(a.sph_center, b.sph_center),
        sph_radius=cat(a.sph_radius, b.sph_radius),
        sph_mat=cat(a.sph_mat, b.sph_mat + mo),
        host_verts=np.concatenate([a.host_verts, b.host_verts]),
        host_tris=np.concatenate([a.host_tris,
                                  b.host_tris + np.int32(vo)]),
    )


def recompute_derived(scene: Scene) -> Scene:
    """Face normals and the total light area from the current vertices, as
    tensors that carry the vertices' gradients, so d(image)/d(verts) flows
    through shading and the light pdf too (the gradient pass,
    diff/render_grad.py). The host copies stay as they are: the edge table
    and the accel build read them."""
    v0 = gather(scene.verts, scene.tri_v0)
    v1 = gather(scene.verts, scene.tri_v1)
    v2 = gather(scene.verts, scene.tri_v2)
    n = normalized(cross(v1 - v0, v2 - v0))
    lv0, lv1, lv2 = (gather(scene.verts, take_clip(c, scene.lights))
                     for c in (scene.tri_v0, scene.tri_v1, scene.tri_v2))
    areas = length(cross(lv1 - lv0, lv2 - lv0)) * 0.5
    return scene._replace(tri_norm=n, total_light_area=torch.sum(areas))
