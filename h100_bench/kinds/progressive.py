"""Kind ``progressive``: a viewer's closed loop with one client. A pass is
one call of the renderer (``render/renderer.render_batch``) that adds
``samples_per_pass`` samples of a ``size``^2 image to the accumulator and
ends in a synchronize; the next pass starts when it returns. With
``passes_per_image`` N > 0 a fresh accumulator (the next image, on its own
key) starts every N passes; with 0 one accumulator runs through the
window. Image j's key folds j into the seed's key.

The mix's other keys: ``trace_steps`` (passes under the profiler in a
traced run) and ``check_pixels`` (pixels the check compares). The check
(``check``): each image the window left against the reference's float64
mean of the same samples (``check.image_gaps``); its number is
``pixels_off_pct``.
"""

from __future__ import annotations

import torch

from h100_bench import check as checks
from h100_bench import work
from h100_bench.drivers import (Spans, camera, device_arrays, port_scene,
                                sync)
from h100_bench.reference import rng

CHECK_WORD = 0x5EED


class Driver:
    """A viewer's progressive passes . On a mesh
    of ranks (``parallel/mesh.TileMesh``) each rank renders its Morton
    range (``parallel/shard.render_sharded``) and every pass ends by
    gathering the image to every rank (``gather_pixels``), as a viewer
    needs it."""

    def __init__(self, config, traffic, seed, device, spans: Spans,
                 mesh, desc):
        from cudapathtracer_tpu_torch.render import renderer
        from cudapathtracer_tpu_torch.utils.config import RenderConfig

        self.r = renderer
        self.mesh = mesh
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = torch.device(device), spans
        self.size = traffic["size"]
        self.spp = traffic["samples_per_pass"]
        self.per_image = traffic.get("passes_per_image", 0)
        self.cfg = RenderConfig(width=self.size, height=self.size,
                                spp=self.spp, samples_per_call=self.spp,
                                reuse_primary_hit=True, **config["render"])
        self.desc = desc
        self.arrays = device_arrays(desc, self.device)
        self.scene = port_scene(self.desc, self.device)
        self.bvh = renderer.build_bvh_for_scene(
            self.scene, self.cfg.leaf_size,
            cluster_size=self.cfg.cluster_size)
        self.prep = renderer.make_packet_prep(self.scene, self.bvh,
                                              self.cfg.intersector)
        self.cam = camera(config, self.size, self.device)
        self.base = rng.seed_key(seed, self.device)
        self.image = 0
        self.key = rng.fold_in(self.base, 0)
        self.state = None
        self.image_now = None     # the whole image after the last pass
        self.count = 0            # samples the window asked of this image
        self.done = []            # (key, image, count) of finished images

    def _fresh(self):
        n = None if self.mesh is None else \
            self.cfg.num_pixels // self.mesh.world
        return self.r.init_accum(self.cfg, device=self.device, num_pixels=n)

    def _pass(self, state):
        if self.mesh is None:
            state = self.r.render_batch(self.scene, self.bvh, self.cam,
                                        self.cfg, self.key, state, self.spp,
                                        prep=self.prep)
            return state, state.img
        from cudapathtracer_tpu_torch.parallel import mesh, shard

        state = shard.render_sharded(self.scene, self.bvh, self.cam,
                                     self.cfg, self.key, state, self.spp,
                                     self.mesh, prep=self.prep)
        with self.spans("gather"):
            image = mesh.gather_pixels(self.mesh, state.img)
        return state, image

    def warm(self):
        """One pass of the window's shapes into a throwaway state."""
        self._pass(self._fresh())
        sync(self.device)
        self.state = self._fresh()

    def step(self) -> int:
        """One pass; -> the samples it completed."""
        if self.per_image and self.count >= self.per_image * self.spp:
            self.done = [(self.key, self.image_now, self.count)]
            self.image += 1
            self.key = rng.fold_in(self.base, self.image)
            self.state = self._fresh()
            self.count = 0
        with self.spans("pass"):
            self.state, self.image_now = self._pass(self.state)
        sync(self.device)
        self.count += self.spp
        return self.spp

    def rays(self, samples: int) -> int:
        return work.rays(self.cfg.num_pixels, samples, self.cfg.num_bounces)

    def outputs(self) -> dict:
        """What the window produced, on the host: at a sample of pixels
        drawn from the seed, each image's mean, with the count of samples
        the window asked of it (not the program's own count)."""
        n_px = min(self.traffic["check_pixels"], self.cfg.num_pixels)
        gen = torch.Generator().manual_seed(self.seed ^ CHECK_WORD)
        idx = torch.randperm(self.cfg.num_pixels, generator=gen)[:n_px]
        idx = idx.sort().values
        images = []
        for key, im, n in self.done + [(self.key, self.image_now,
                                        self.count)]:
            img = torch.stack([c[idx.to(self.device)] for c in im], -1)
            images.append((key.cpu(), n, img.double().cpu()))
        return dict(idx=idx, images=images)

    def release(self):
        del self.scene, self.bvh, self.prep, self.state, self.done
        del self.image_now


def check(outputs, config, traffic, arrays) -> dict:
    want = checks.reference_images(outputs, config, traffic, arrays,
                                   torch.float32)
    return checks.compare_images([img for _, _, img in outputs["images"]],
                                 want)


def control_readings(outputs, config, traffic, arrays) -> dict:
    """The control's numbers (the reference in bfloat16 in the program's
    place), and for the record sum |got - reference| / sum |reference| of
    the program and of the control."""
    want = checks.reference_images(outputs, config, traffic, arrays,
                                   torch.float32)
    low = checks.reference_images(outputs, config, traffic, arrays,
                                  torch.bfloat16)
    got = [img for _, _, img in outputs["images"]]
    return {"control": checks.compare_images(low, want),
            "rel_l1": {"program": checks.image_gaps(got, want)[1],
                       "control": checks.image_gaps(low, want)[1]}}
