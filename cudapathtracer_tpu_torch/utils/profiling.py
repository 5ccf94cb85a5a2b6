"""Instrumentation: timing, throughput, watchdog, traversal heatmaps.

Counterpart of ``cudapathtracer_tpu/utils/profiling.py``, after the
reference's three mechanisms (SURVEY.md §5.1):

* the cudaEvent render-loop timer and Mrays/s report (kernel.cu:704-757)
  -> ``RenderTimer`` with the reference's ray accounting. CUDA work is
  asynchronous, so on a CUDA device the timer synchronizes before each lap
  and before the report: a lap read while kernels are still queued would
  time their launches, not the render;
* the per-sample > 0.5 s watchdog (kernel.cu:712-723) -> ``RenderTimer.lap``
  warns through ``on_slow``;
* the per-triangle BVH leaf-visit histogram dumped to out.csv
  (kernel.cu:133, 742-750) -> ``ops.traversal.trace(with_stats=True)``
  returns the histogram; ``dump_visit_csv`` writes the same
  one-value-per-line CSV.

``profile_trace`` wraps ``torch.profiler`` around a block;
``device_health`` is the getGPUTemp analogue (kernel.cu:555-563) and
``falsecolor_state`` the library form of the 'sponza bvh.ppm' keeper.

The program's own spans and counters (the pass, the integrator glue, the
packet engine's sort and cull, live rays, the train step's recompute) are
``utils/tracing.py``, a module apart because this one imports the
renderer; with ``tracing.enable(True)`` they show as ranges in a
``profile_trace`` capture.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import numpy as np
import torch

from ..accel.bvh import Accel
from ..ops import traversal
from ..ops.rng import pixel_keys, prng_key, sample_key
from ..ops.vecmath import Vec3
from ..render.camera import camera_rays
from ..render.renderer import AccumState


def mrays_per_sec(num_pixels: int, spp: int, bounces: int, seconds: float):
    """The reference's accounting: rays = pixels * spp * (bounces+1)
    (kernel.cu:757)."""
    return num_pixels * spp * (bounces + 1) / seconds / 1e6


class RenderTimer:
    """Wall-clock timing of progressive batches with a slow-lap watchdog.
    With a CUDA ``device`` every reading waits for the device's queued work
    first."""

    def __init__(self, slow_threshold_s: float = 0.5, on_slow=None,
                 device=None):
        self.slow_threshold_s = slow_threshold_s
        self.on_slow = on_slow or (lambda msg: print(msg))
        self.device = None if device is None else torch.device(device)
        self.laps = []
        self._t0 = None
        self._start = None

    def _now(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self):
        self._start = self._t0 = self._now()
        return self

    def lap(self, label=""):
        t = self._now()
        dt = t - self._t0
        self._t0 = t
        self.laps.append(dt)
        if dt > self.slow_threshold_s:
            # kernel.cu:722-723 wording kept recognizable
            self.on_slow(
                f"-----Possible too long execution of {dt:f} seconds----- "
                f"{label}"
            )
        return dt

    @property
    def total(self):
        return self._now() - self._start

    def report(self, num_pixels: int, spp: int, bounces: int):
        """The reference's end-of-render block (kernel.cu:752-757)."""
        total = self.total
        ms = total * 1000.0
        return {
            "total_ms": ms,
            "ms_per_loop": ms / max(1, len(self.laps)),
            "mrays_per_sec": mrays_per_sec(num_pixels, spp, bounces, total),
        }


def dump_visit_csv(path, tri_visits):
    """Per-triangle visit counts, one per line with trailing comma — the
    exact out.csv shape the reference emits (kernel.cu:746-749)."""
    v = np.asarray(tri_visits.cpu() if torch.is_tensor(tri_visits)
                   else tri_visits)
    with open(path, "w") as f:
        for x in v:
            f.write(f"{int(x)},\n")


@contextlib.contextmanager
def profile_trace(logdir):
    """A ``torch.profiler`` capture of the CPU and, where there is a card,
    CUDA activity around a block, written to ``logdir`` as a TensorBoard
    trace. Yields the profiler (``key_averages()`` for sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))) as prof:
        yield prof


def _gpu_temperature(index: int):
    """The card's temperature in degrees C from ``nvidia-smi``, or None
    where it does not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=temperature.gpu",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def device_health(device="cuda"):
    """Device-health snapshot — the getGPUTemp analogue (kernel.cu:555-563),
    with the JAX package's keys: the device's name and platform, its
    temperature (``nvidia-smi``'s, None where it does not run) and its
    memory in use and in all (``torch.cuda.mem_get_info``). Every reading
    is None for a CPU device."""
    dev = torch.device(device)
    out = {"device": str(dev), "platform": dev.type, "temperature_c": None,
           "hbm_bytes_in_use": None, "hbm_bytes_limit": None}
    if dev.type != "cuda":
        return out
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    free, total = torch.cuda.mem_get_info(index)
    out.update(device=torch.cuda.get_device_name(index),
               temperature_c=_gpu_temperature(index),
               hbm_bytes_in_use=total - free, hbm_bytes_limit=total)
    return out


class HealthWatchdog:
    """The reference's thermal-throttle loop shape (kernel.cu:725-732),
    generalized and OFF by default — exactly like the reference, whose loop
    is commented out. ``check`` pauses while ``should_pause(health)`` holds
    (e.g. a temperature or memory gate), polling every ``poll_s``
    seconds."""

    def __init__(self, should_pause=None, poll_s: float = 5.0,
                 on_pause=None, max_wait_s: float = 300.0, device="cuda"):
        self.should_pause = should_pause  # None = disabled (reference dflt)
        self.poll_s = poll_s
        self.on_pause = on_pause or (lambda msg: print(msg))
        self.max_wait_s = max_wait_s
        self.device = device

    def check(self):
        if self.should_pause is None:
            return False
        waited = 0.0
        paused = False
        while (self.should_pause(device_health(self.device))
               and waited < self.max_wait_s):
            if not paused:
                self.on_pause("render paused: device health gate")
                paused = True
            time.sleep(self.poll_s)
            waited += self.poll_s
        if paused:
            self.on_pause("render resumed")
        return paused


def falsecolor_state(scene, bvh, cam, cfg, seed: int = 1234):
    """Per-pixel traversal cost of one primary-ray trace of the fine BVH
    (``bvh``: an Accel or its fine FlatBVH) as an AccumState: red = the
    ray's node visits over the most any ray made, times 4; green = 1 minus
    that. -> (AccumState, TraceStats), deterministic for a fixed scene,
    camera and seed."""
    fine = bvh.fine if isinstance(bvh, Accel) else bvh
    td = traversal.make_trace_data(scene, fine)
    dev = cam.pos.x.device
    idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    keys = pixel_keys(sample_key(prng_key(seed, dev), 0), idx)
    o, d = camera_rays(cam, idx, keys)
    _, stats = traversal.trace(o, d, td, with_stats=True)
    v = stats.ray_visits.to(torch.float32)
    v = v / torch.clamp(v.max(), min=1.0)
    z = torch.zeros_like(v)
    return AccumState(img=Vec3(v * 4.0, 1.0 - v, z), comp=Vec3(z, z, z),
                      n=1), stats
