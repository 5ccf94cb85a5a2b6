"""Kind ``train_edges``: shape fitting with edge-sampled boundary terms. A
step is ``kinds/train.py``'s step (the L2 loss of a ``size``^2 PT+NEE image
of ``samples_per_step`` samples per pixel, ``torch.autograd.grad``, SGD at
``lr``, a synchronize) with the primary (silhouette) and the NEE shadow
boundary terms in the image: ``edge_samples`` and
``shadow_edge_samples`` samples a step, over the edge table of the start
mesh built once at set-up (the topology does not change). The target is
the interior image, under no_grad on the seed's key folded with 0, of the
configuration's ``target`` scene (the same topology, its own BVH). Keys as
``kinds/train.py`` draws them. Runs in one process.

The check compares set-up's ``first_steps`` steps with the reference
following them (``reference/edges.py``) by ``check.compare_steps``: the
leaves of ``kinds/train.py`` and the hero's vertices as leaves of their
own (``hero.x/y/z``, the configuration's last ``10 * 4^subdiv + 2``
vertices), whose gradient the boundary terms carry.
"""

from __future__ import annotations

import functools
from pathlib import Path
from types import SimpleNamespace

import torch

from h100_bench import check as checks
from h100_bench.drivers import port_scene
from h100_bench.harness import make_scene
from h100_bench.kinds import train
from h100_bench.reference import edges

BENCH_DIR = Path(__file__).resolve().parents[1]
AXES = "xyz"


def hero_vertices(config) -> int:
    """The hero icosphere's vertex count: the scene's last vertices."""
    return 10 * 4 ** config["scene"]["args"]["subdiv"] + 2


class Driver(train.Driver):
    """``kinds/train.py``'s SGD steps with both boundary terms."""

    def __init__(self, config, traffic, seed, device, spans, mesh, desc):
        super().__init__(config, traffic, seed, device, spans, mesh, desc)
        from cudapathtracer_tpu_torch.diff.edge_sampling import \
            build_edge_table
        from cudapathtracer_tpu_torch.render import renderer

        rg = self.rg
        self.table = build_edge_table(self.scene.host_tris,
                                      device=self.device)
        target = make_scene(BENCH_DIR, config["target"])
        self.target_verts = torch.from_numpy(target["verts"])
        tscene = port_scene(target, self.device)
        tbvh = renderer.build_bvh_for_scene(
            tscene, self.cfg.leaf_size, cluster_size=self.cfg.cluster_size)
        with torch.no_grad():
            self.target = rg.render_image_diff(
                tscene, self.cam, self.cfg, self.target_key, self.spp,
                bvh=tbvh)
        # the step of kinds/train.py, its render with both terms
        self.rg = SimpleNamespace(
            render_image_diff=functools.partial(
                rg.render_image_diff, edge_samples=traffic["edge_samples"],
                edge_table=self.table,
                shadow_edge_samples=traffic["shadow_edge_samples"]),
            scene_with=rg.scene_with, l2_loss=rg.l2_loss)
        self.hero = hero_vertices(config)

    def warm(self):
        super().warm()
        for part in ("grads", "change"):
            self.first[part] += [t[-self.hero:] for t in
                                 self.first[part][:3]]

    def outputs(self) -> dict:
        out = super().outputs()
        out["names"] = out["names"] + [f"hero.{c}" for c in AXES]
        out["target_verts"] = self.target_verts
        return out

    def release(self):
        super().release()
        del self.table


def reference_steps(outputs, config, traffic, arrays, dtype) -> dict:
    dev = arrays["verts"].device
    r = edges.follow_edges(
        arrays, outputs["target_verts"].to(dev), config["camera"],
        traffic["size"], [k.to(dev) for k in outputs["keys"]],
        outputs["target_key"].to(dev), traffic["lr"], dtype,
        traffic["edge_samples"], traffic["shadow_edge_samples"],
        config["render"].get("jitter", False),
        config["render"].get("num_bounces", 3))
    hero = hero_vertices(config)
    norms = {}
    for part, by_param in (("grads", r["first_grad"]),
                           ("change", r["change"])):
        by_param = dict(by_param, hero=by_param["verts"][-hero:])
        norms[part] = {f"{k}.{c}": float(v[:, j].double().norm())
                       for k, v in by_param.items()
                       for j, c in enumerate(AXES)}
    return dict(losses=r["losses"], **norms)


def check(outputs, config, traffic, arrays) -> dict:
    want = reference_steps(outputs, config, traffic, arrays, torch.float32)
    return checks.compare_steps(checks.program_steps(outputs), want)


def _scaled(term):
    return lambda *a, **k: term(*a, **k) * 1.05


def control_readings(outputs, config, traffic, arrays) -> dict:
    """The control's numbers (the reference in bfloat16 in the program's
    place), and the numbers with each fault planted in the reference put
    in the program's place: both boundary terms left out, and the edge
    weights times 1.05 (each boundary image scaled where it is made)."""
    from unittest import mock

    want = reference_steps(outputs, config, traffic, arrays, torch.float32)
    low = reference_steps(outputs, config, traffic, arrays, torch.bfloat16)
    no_edges = dict(traffic, edge_samples=0, shadow_edge_samples=0)
    faults = {"boundary terms left out": reference_steps(
        outputs, config, no_edges, arrays, torch.float32)}
    with mock.patch.multiple(edges, primary_term=_scaled(edges.primary_term),
                             shadow_term=_scaled(edges.shadow_term)):
        faults["edge weights x 1.05"] = reference_steps(
            outputs, config, traffic, arrays, torch.float32)
    return {"control": checks.compare_steps(low, want),
            "faults": {k: checks.compare_steps(v, want)
                       for k, v in faults.items()}}
