"""What every kind of mix drives with: the benchmark's spans around calls
into the program, the capture of the fold kernels' calls, and the scene,
BVH and camera the program gets from a configuration.

A kind of mix is a file of its own, ``kinds/<kind>.py``, found by the
``kind`` a mix's data names; a scene generator is ``scenes/<generator>.py``
(harness.py says what each exports). Everything comes from ``--seed``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import torch

from . import work


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """The benchmark's spans around calls into the program's layers. Off,
    they cost nothing; in ``profile`` mode each is a ``record_function``
    range named ``bench.<name>``; in ``time`` mode each synchronizes the
    device at both ends and keeps its host seconds."""

    def __init__(self, device):
        self.device = device
        self.mode = None
        self.seconds = {}
        self._patched = []

    @contextmanager
    def __call__(self, name):
        if self.mode is None:
            yield
        elif self.mode == "profile":
            from torch.profiler import record_function

            with record_function("bench." + name):
                yield
        else:
            sync(self.device)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                sync(self.device)
                self.seconds.setdefault(name, []).append(
                    time.perf_counter() - t0)

    def wrap(self, name, target: str, around=None):
        """Put a span named ``name`` (None: no span) around every call of
        ``target``, ``"package.module:attribute"``; ``around(fn, args,
        kwargs)``, if given, makes the call inside the span."""
        import importlib

        mod_name, attr = target.split(":")
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)

        def wrapped(*args, **kwargs):
            with self(name) if name else nullcontext():
                if around is None:
                    return orig(*args, **kwargs)
                return around(orig, args, kwargs)

        setattr(mod, attr, wrapped)
        self._patched.append((mod, attr, orig))

    def unwrap(self):
        for mod, attr, orig in reversed(self._patched):
            setattr(mod, attr, orig)
        self._patched = []


class FoldCapture:
    """Keeps the inputs and output of every call the packet engine makes
    into a fold kernel's wrapper, to reckon the work those calls needed.
    ``kernels``: the fold kernels' data (``fold_kernels/*.json``)."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.calls = []
        self.on = False

    def install(self, spans: Spans):
        for k in self.kernels:
            def around(fn, args, kwargs, k=k):
                out = fn(*args, **kwargs)
                if self.on:
                    F = args[7] if k.get("super_factor_arg") else None
                    self.calls.append((k["trace_name"], args[:7], out[0],
                                       F))
                return out
            spans.wrap(None, k["engine_call"], around)

    def bounds(self, num_tris: int) -> dict:
        """-> {trace name: (calls, summed bound seconds)}."""
        out = {}
        for name, (ids, counts, _e, rays, packed, tri, boxes), t, F in \
                self.calls:
            tests, _, nbytes = work.needed_work(ids, counts, rays, t,
                                                (packed, tri, boxes),
                                                num_tris, F)
            b = work.bound_seconds(tests, nbytes, work.intersector_of(packed))
            n, s = out.get(name, (0, 0.0))
            out[name] = (n + 1, s + b)
        self.calls = []
        return out


def device_arrays(desc, device) -> dict:
    """The scene's host arrays on the device: what the program and the
    reference both start from."""
    return {k: torch.from_numpy(desc[k]).to(device)
            for k in ("verts", "tris", "tri_mats", "albedo", "emission")}


def port_scene(desc, device):
    from cudapathtracer_tpu_torch.models.scene import make_scene

    return make_scene(desc["verts"], desc["tris"], desc["tri_mats"],
                      desc["albedo"], desc["emission"], device=device)


def camera(config, size, device):
    from cudapathtracer_tpu_torch.render.camera import make_camera

    cam = config["camera"]
    return make_camera(pos=tuple(cam["pos"]),
                       dist_from_film=cam.get("dist_from_film", 1.0),
                       focal_length=cam["focal_length"],
                       radius=cam.get("radius", 0.0), width=size,
                       height=size, device=device)
