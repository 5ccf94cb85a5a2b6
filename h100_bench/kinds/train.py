"""Kind ``train``: inverse rendering. A step is the L2 loss of a ``size``^2
PT+NEE image of ``samples_per_step`` samples per pixel against a target
image (``diff/render_grad``), its gradients in every scene parameter by
``torch.autograd.grad``, and one SGD update at ``lr``, ending in a
synchronize. Step i draws on the seed's key folded with 1 + i, the target
on it folded with 0. Runs in one process.

The mix's other keys: ``first_steps`` (set-up's steps through the window's
own call, which the check compares) and ``trace_steps``. The check
(``check``): those steps against the reference following them; its
numbers are ``loss_gap``, ``grad_gap`` and ``change_gap``
(``check.compare_steps``).
"""

from __future__ import annotations

import torch

from h100_bench import check as checks
from h100_bench import work
from h100_bench.drivers import (Spans, camera, device_arrays, port_scene,
                                sync)
from h100_bench.reference import rng


class Driver:
    """Inverse-rendering SGD steps, in one process."""

    def __init__(self, config, traffic, seed, device, spans: Spans,
                 mesh, desc):
        if mesh is not None:
            raise ValueError("the train mix runs in one process")
        from cudapathtracer_tpu_torch.diff import render_grad as rg
        from cudapathtracer_tpu_torch.render import renderer
        from cudapathtracer_tpu_torch.utils.config import RenderConfig

        self.rg = rg
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = torch.device(device), spans
        self.size = traffic["size"]
        self.spp = traffic["samples_per_step"]
        self.lr = traffic["lr"]
        self.cfg = RenderConfig(width=self.size, height=self.size,
                                spp=self.spp, samples_per_call=self.spp,
                                reuse_primary_hit=False, **config["render"])
        if self.cfg.integrator != "pt_nee":
            raise ValueError("the train mix renders PT+NEE")
        self.desc = desc
        self.arrays = device_arrays(desc, self.device)
        self.scene = port_scene(self.desc, self.device)
        self.bvh = renderer.build_bvh_for_scene(
            self.scene, self.cfg.leaf_size,
            cluster_size=self.cfg.cluster_size)
        self.cam = camera(config, self.size, self.device)
        self.base = rng.seed_key(seed, self.device)
        self.target_key = rng.fold_in(self.base, 0)
        with torch.no_grad():
            self.target = rg.render_image_diff(
                self.scene, self.cam, self.cfg, self.target_key, self.spp,
                bvh=self.bvh)
        self.params = rg.targets_of(self.scene)
        self.leaves = rg.target_leaves(self.params)
        self.steps = 0
        self.first = None         # what set-up read of its first steps

    def key(self, i):
        return rng.fold_in(self.base, 1 + i)

    def step(self, record=False) -> int:
        """One SGD step; -> the samples per pixel it rendered."""
        rg = self.rg
        with self.spans("forward"):
            img = rg.render_image_diff(rg.scene_with(self.scene, self.params),
                                       self.cam, self.cfg,
                                       self.key(self.steps), self.spp,
                                       bvh=self.bvh)
            loss = rg.l2_loss(img, self.target)
        with self.spans("backward"):
            grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        with self.spans("update"), torch.no_grad():
            for p, g in zip(self.leaves, grads):
                if g is not None:
                    p -= self.lr * g
        sync(self.device)
        if record:
            self.first["losses"].append(float(loss.detach()))
            if self.steps == 0:
                self.first["grads"] = [None if g is None else g.cpu()
                                       for g in grads]
        self.steps += 1
        return self.spp

    def warm(self):
        """Set-up's first steps, through the window's own call: their
        losses, the first step's gradients as the update takes them, and
        the parameters' change over them are what the check compares."""
        start = [p.detach().cpu().clone() for p in self.leaves]
        self.first = dict(losses=[])
        for _ in range(self.traffic["first_steps"]):
            self.step(record=True)
        self.first["change"] = [p.detach().cpu() - s
                                for p, s in zip(self.leaves, start)]

    def rays(self, samples: int) -> int:
        return work.rays(self.cfg.num_pixels, samples, self.cfg.num_bounces)

    def outputs(self) -> dict:
        return dict(self.first, keys=[self.key(i).cpu() for i in
                                      range(self.traffic["first_steps"])],
                    target_key=self.target_key.cpu(),
                    names=[f"{n}.{c}" for n in ("verts", "albedo",
                                                "emission", "sph_center")
                           for c in "xyz"] + ["sph_radius"])

    def release(self):
        del self.scene, self.bvh, self.params, self.leaves, self.target


def check(outputs, config, traffic, arrays) -> dict:
    want = checks.reference_steps(outputs, config, traffic, arrays,
                                  torch.float32)
    return checks.compare_steps(checks.program_steps(outputs), want)


def _half_l2(img, target):
    h = img.shape[0] // 2
    return ((img[:h] - target[:h]) ** 2).sum(-1).mean()


def control_readings(outputs, config, traffic, arrays) -> dict:
    """The control's numbers (the reference in bfloat16 in the program's
    place), and the numbers with each fault a train step can have planted
    in the reference put in the program's place (half of the batch left
    out, the mean taken over the rest; each answer scaled by 1.05 where it
    is produced). A state left unchanged reads 1 by construction."""
    from unittest import mock

    from h100_bench.reference import inverse

    want = checks.reference_steps(outputs, config, traffic, arrays,
                                  torch.float32)
    low = checks.reference_steps(outputs, config, traffic, arrays,
                                 torch.bfloat16)
    orig = inverse.pt_nee
    planted = {"half the batch left out": ("l2", _half_l2),
               "answer altered where produced": (
                   "pt_nee", lambda *a, **k: orig(*a, **k) * 1.05)}
    faults = {}
    for name, (attr, fn) in planted.items():
        with mock.patch.object(inverse, attr, fn):
            got = checks.reference_steps(outputs, config, traffic, arrays,
                                         torch.float32)
        faults[name] = checks.compare_steps(got, want)
    return {"control": checks.compare_steps(low, want), "faults": faults}
