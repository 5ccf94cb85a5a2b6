"""Inputs shared by the tests of the port's dense fold kernels K1, K2 and K3
(tests/test_torch_dense_*.py): rays made with numpy or the port's camera,
the port's packet data and shortlists, and the same scene on the JAX side.

The JAX package is imported only inside ``jax_scene``, so the kernels'
``cuda`` cases also run where JAX is not installed."""

import numpy as np
import torch

import cudapathtracer_tpu_torch as T
from cudapathtracer_tpu_torch import convert
from cudapathtracer_tpu_torch.models import procedural as tproc
from cudapathtracer_tpu_torch.ops import packets as tpk
from cudapathtracer_tpu_torch.ops import traversal as ttrav
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as tk1
from cudapathtracer_tpu_torch.ops.vecmath import Vec3 as TVec3
from cudapathtracer_tpu_torch.render.camera import camera_rays


def tv(v):
    return TVec3(*(torch.from_numpy(np.array(c)) for c in v))


def rays(kind, n=256):
    """(o, d, mask) numpy rays: camera rays at 16^2 or random ones."""
    if kind == "camera":
        o, d = camera_rays(T.make_camera(width=16, height=16, device="cpu"),
                           torch.arange(n), None, lens=False)
        o, d = [c.numpy() for c in o], [c.numpy() for c in d]
    else:
        rng = np.random.default_rng(3)
        o = [rng.uniform(-0.8, 0.8, n).astype(np.float32) + off
             for off in (0.0, 1.0, 0.0)]
        d = [(rng.standard_normal(n) + 1e-3).astype(np.float32)
             for _ in range(3)]
    mask = (np.arange(n) % 7) != 0
    return o, d, mask


def packet_data(accel, scene):
    return tpk.make_packet_data(
        scene, TVec3(accel.cl_lo_x, accel.cl_lo_y, accel.cl_lo_z),
        TVec3(accel.cl_hi_x, accel.cl_hi_y, accel.cl_hi_z), accel.cl_tri)


def shortlists(tpd, kind, sort, max_clusters=16, **kw):
    """Shortlists of 64-ray tiles of ``rays(kind)``, sorted as the packet
    engine sorts them when ``sort``; ``kw`` goes to build_shortlists."""
    o, d, mask = rays(kind)
    o, d, mask = tv(o), tv(d), torch.from_numpy(mask)
    if sort:
        perm = tpk.sort_rays(o, d, mask, tpd)
        o, d, mask = o.map(lambda c: c[perm]), d.map(lambda c: c[perm]), \
            mask[perm]
    return tpk.build_shortlists(o, d, mask, tpd, 64, max_clusters, **kw)


def jax_scene(subdiv):
    """cornell_with_sphere_mesh(subdiv) at C = 128 in both packages: the
    port's packet data, trace data and pack beside the JAX package's, with
    the JAX modules the tests call."""
    import jax.numpy as jnp

    from cudapathtracer_tpu.models import procedural as jproc
    from cudapathtracer_tpu.ops import packets as jpk
    from cudapathtracer_tpu.ops import traversal as jtrav
    from cudapathtracer_tpu.ops.pallas import dense as jd
    from cudapathtracer_tpu.ops.pallas import dense_resident as jdr
    from cudapathtracer_tpu.ops.vecmath import Vec3 as JVec3
    from cudapathtracer_tpu.render.renderer import build_bvh_for_scene

    js = jproc.to_scene(jproc.cornell_with_sphere_mesh(subdiv=subdiv))
    accel = build_bvh_for_scene(js, leaf_size=4, cluster_size=128)
    jpd = jpk.make_packet_data(
        js, JVec3(accel.cl_lo_x, accel.cl_lo_y, accel.cl_lo_z),
        JVec3(accel.cl_hi_x, accel.cl_hi_y, accel.cl_hi_z), accel.cl_tri)
    ta = convert.accel_from_jax(convert.to_numpy_dict(accel), "cpu")
    ts = tproc.to_scene(tproc.cornell_with_sphere_mesh(subdiv=subdiv), "cpu")
    tpd = packet_data(ta, ts)
    return dict(js=js, jpd=jpd, jtd=jtrav.make_trace_data(js, accel.fine),
                ts=ts, tpd=tpd, ttd=ttrav.make_trace_data(ts, ta.fine),
                pack=tk1.pack_clusters(tpd),
                jpack=jdr.pack_clusters_resident_bw(jpd),
                jboxes=jdr.pack_cluster_boxes(jpd), jd=jd, jdr=jdr,
                jpk=jpk, jnp=jnp, JVec3=JVec3)
