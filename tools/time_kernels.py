"""Times the port's CUDA kernels alone on one GPU, each in turns with its
plain version, beside the least time the work it needs could take.

One line per row of PERF.md's kernel table:

* the fold kernels K1 (``csrc/dense_resident.cu``), K2 (``csrc/dense.cu``)
  and K3 (``csrc/dense_super.cu``) on the primary and first bounce batches
  of one sample of the headline (colonnade subdiv 3, PT+NEE at 1024^2, the
  bench camera), sorted and shortlisted as the packet engine does: K1 and
  K2 on the flat shortlists, K3 on super shortlists of SUPER_F clusters;
  each with its Baldwin-Weber and Moller-Trumbore instances, and its
  visibility instance on the Baldwin-Weber rays with each hitting ray's cap
  moved near its closest hit (so that the query retires some rays). The
  plain version runs on SAMPLE_TILES tiles spread over the batch. The
  counting instance gives the lane tests issued, against the tests needed;
* the glue's FMA (``csrc/fma.cu``) at the main paths' lane counts, as
  contiguous tensors and as columns of 9-wide tables, beside the library's
  nearest op, ``torch.addcmul`` (and its differing bits);
* the RNG's threefry (``csrc/threefry.cu``) at the cells' calls.

Times: a fold kernel's ms by CUDA events over ``--reps`` launches, the plain
version's by the host clock to a synchronize, in turns plain, kernel,
kernel, plain. The FMA's and threefry's card and host time a call: the
host's time to enqueue the calls back to back, then the card's for as many
between two CUDA events, enqueued behind a spin kernel so that the events
hold the card's time alone. The bound is the larger of the bytes over the
card's memory rate and the operations over its rate: a fold's from
``ops/kernels/work.py:needed_work`` (tests x ``OPS_PER_TEST``, float32), the
FMA's 16 bytes an element, threefry's int32 operations (HASH_OPS a hash) or
bytes. The card's name and power limit come first, then ptxas's registers
and spills of each kernel.

Run on a CUDA machine from the repository's root:
    python3 tools/time_kernels.py [--only fold,fma,threefry] [--reps 20]
To compare two versions of a kernel, run each tree's copy of this tool in
one call to the machine, in turns.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import cudapathtracer_tpu_torch as cpt  # noqa: E402
from cudapathtracer_tpu_torch.models import procedural  # noqa: E402
from cudapathtracer_tpu_torch.ops import packets, rng  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels import dense as k2  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as k1  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels import dense_super as k3  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels import fma as kfma  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels import threefry as kt  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels.work import (  # noqa: E402
    OPS_PER_TEST, needed_work)
from cudapathtracer_tpu_torch.ops.rng import (  # noqa: E402
    pixel_keys, prng_key, sample_key)
from cudapathtracer_tpu_torch.ops.vecmath import Vec3  # noqa: E402
from cudapathtracer_tpu_torch.render import renderer  # noqa: E402
from cudapathtracer_tpu_torch.render.camera import camera_rays  # noqa: E402
from cudapathtracer_tpu_torch.utils.build import BUILD_LOG  # noqa: E402

HEADLINE_SIZE = 1024
SUPER_F = 8
SAMPLE_TILES = 512
# the visibility instance's band, and the spread of the moved caps about
# each ray's hit: t + VIS_BAND * u, u uniform in [-1, 2]
VIS_BAND = 0.03
# one H100 SXM (its data sheet): HBM bytes/s, float32 operations/s outside
# the tensor cores, and the integer pipe's int32 operations/s (64 a clock
# on each of 132 SMs at 1.98 GHz)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_INT32_PER_S = 132 * 64 * 1.98e9
# the glue's lanes: the 1024^2 PT+NEE pass, the 512^2 BDPT pass and the
# 256^2 train step
FMA_SIZES = (1_048_576, 262_144, 65_536)
FMA_REPS = 100
# the RNG's calls at the cells' lane counts: (call, keys, counters); int32
# operations a threefry2x32 hash (20 rounds of add, rotate and xor, 5 key
# injections of 2 adds, the first 2 adds, the third key word)
THREEFRY_SHAPES = (("uniform_sites", 1_048_576, 6),
                   ("uniform_sites", 262_144, 7),
                   ("uniform_sites", 65_536, 6),
                   ("pixel_keys", 1_048_576, 1),
                   ("uniform_1", 1, 65_536),
                   ("randint", 1, 65_536))
THREEFRY_REPS = 100
THREEFRY_PLAIN_REPS = 10
HASH_OPS = 73


def cuda_ms(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn):
    """ms of one run of ``fn()`` between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def card_and_host_us(fn, reps):
    """(card us, host us) a call of ``fn``: the host's time to enqueue
    ``reps`` calls back to back, then the card's time for as many between
    two CUDA events, enqueued while a spin kernel holds the card for twice
    the enqueue time (at 2 GHz), so that the events see the card alone."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host * reps * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e3 / reps, host * 1e6


def bound(nbytes, ops, ops_rate, ops_name):
    """(least ms, what bounds it) of ``nbytes`` and ``ops`` operations."""
    return max((nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
               (ops / ops_rate * 1e3, ops_name))


def headline_batches(dev):
    """The headline's scene, its packet data, tile size and the primary and
    first bounce batches of one sample, each (o, d, mask)."""
    scene = procedural.to_scene(procedural.colonnade(subdiv=3), dev)
    cfg = cpt.RenderConfig(width=HEADLINE_SIZE, height=HEADLINE_SIZE, spp=1,
                           integrator="pt_nee", samples_per_call=1)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
    prep = renderer.make_packet_prep(scene, bvh)
    cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=HEADLINE_SIZE,
                          height=HEADLINE_SIZE, focal_length=2.0, device=dev)
    trace_fn = renderer.make_trace_fn(scene, cfg, bvh, prep=prep)
    calls = []

    def recording(o, d, mask, t_cap=None, vis_band=0.0):
        calls.append((o, d, mask))
        return trace_fn(o, d, mask, t_cap=t_cap, vis_band=vis_band)

    idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    keys = pixel_keys(sample_key(prng_key(1234, dev), 0), idx)
    o, d = camera_rays(cam, idx, keys, lens=False)
    renderer._radiance(o, d, scene, recording, keys, cfg)
    P = renderer.resolve_tile_size(cfg, scene.num_tris)
    return scene, prep.pdata, P, {"primary": calls[0], "bounce": calls[1]}


def shortlists(batch, pd, P, F=None):
    """The batch's rays sorted as the packet engine sorts them, and their
    shortlists (in super units of F clusters with ``F``)."""
    o, d, mask = batch
    perm = packets.sort_rays(o, d, mask, pd)
    return packets.build_shortlists(
        Vec3(*(c[perm] for c in o)), Vec3(*(c[perm] for c in d)), mask[perm],
        pd, P, 4095, super_factor=F)


def sample_tiles(sl, n):
    """The shortlists of about n tiles spread evenly over the batch."""
    Tl = sl.ids.shape[0]
    idx = torch.unique(torch.linspace(0, Tl - 1, min(n, Tl),
                                      device=sl.ids.device).round().long())
    return type(sl)(*(a[idx].contiguous() for a in sl))


def moved_caps(sl, t, best):
    """The shortlists with each hitting ray's cap moved to t + VIS_BAND * u,
    u uniform in [-1, 2]."""
    g = torch.Generator(device=t.device).manual_seed(11)
    u = torch.rand(t.shape, generator=g, device=t.device) * 3.0 - 1.0
    rays = sl.rays.clone()
    rays[:, 7] = torch.where(best >= 0, t + VIS_BAND * u, rays[:, 7])
    return sl._replace(rays=rays)


def time_folds(dev, reps):
    scene, pd, P, batches = headline_batches(dev)
    packs = {i: k1.pack_clusters(pd, i) for i in ("bw", "mt")}
    kernels = {"k1": (k1.dense_intersect_resident,
                      k1.dense_intersect_resident_plain, None),
               "k2": (k2.dense_intersect, k2.dense_intersect_plain, None),
               "k3": (k3.dense_intersect_super,
                      k3.dense_intersect_super_plain, SUPER_F)}
    print(f"fold: headline colonnade subdiv 3, tris={scene.num_tris} "
          f"K={pd.num_clusters} C={packs['bw'][0].shape[2]} P={P} "
          f"{HEADLINE_SIZE}^2 pt_nee")
    for bname, batch in batches.items():
        lists = {F: shortlists(batch, pd, P, F) for F in (None, SUPER_F)}
        for name, (wrap, plain, F) in kernels.items():
            sl = lists[F]
            extra = (F,) if F else ()
            for form in ("bw", "mt", "vis"):
                isect = "mt" if form == "mt" else "bw"
                pack = packs[isect]
                kw = dict(intersector=isect)
                if form == "vis":
                    t, best = wrap(sl.ids, sl.counts, sl.entries, sl.rays,
                                   *pack, *extra)
                    sl = moved_caps(sl, t, best)
                    kw["vis_band"] = VIS_BAND
                args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack, *extra)
                part = sample_tiles(sl, SAMPLE_TILES)
                pargs = (part.ids, part.counts, part.entries, part.rays,
                         *pack, *extra)
                pkw = {k: v for k, v in kw.items() if k == "vis_band"}
                got = wrap(*args, **kw)
                plain(*pargs, **pkw)            # a warm-up of each
                ms, plain_ms = [], []
                for step in ("plain", "kernel", "kernel", "plain"):
                    if step == "plain":
                        plain_ms.append(host_ms(lambda: plain(*pargs, **pkw)))
                    else:
                        ms.append(cuda_ms(lambda: wrap(*args, **kw), reps))
                counts = torch.empty((sl.ids.shape[0], k1.COUNT_COLS),
                                     dtype=torch.int64, device=dev)
                wrap(*args, counts_out=counts, **kw)
                issued = int(counts[:, 1].sum())
                tests, _, nbytes = needed_work(sl, got[0], pack,
                                               scene.num_tris, F)
                bnd = bound(nbytes, tests * OPS_PER_TEST[isect],
                            PEAK_F32_PER_S, "operations")
                mean = sum(ms) / 2
                print(f"fold[{name}/{bname}/{form}]: tiles={sl.ids.shape[0]} "
                      f"ms={mean:.4f} ({ms[0]:.4f}, {ms[1]:.4f}) plain_ms="
                      f"{sum(plain_ms) / 2:.1f} (on {part.ids.shape[0]} "
                      f"tiles) bound_ms={bnd[0]:.4f} ({bnd[1]}) share="
                      f"{bnd[0] / mean:.1%} tests_issued={issued} "
                      f"tests_needed={tests} ({issued / max(tests, 1):.2f})")


def fma_operands(n, cols, seed, dev):
    """(a, b, c), n float32 elements each on ``dev`` whose result lives in
    the product's low bits (c near -a*b), as columns of ``cols``-wide
    tables (1: contiguous)."""
    g = torch.Generator().manual_seed(seed)
    a, b = (torch.randn((n, cols), generator=g) * 3.0 for _ in range(2))
    c = -(a * b) * (1 + torch.randn((n, cols), generator=g) * 1e-6)
    return tuple(x.to(dev)[:, 0] for x in (a, b, c))


def bits_differ(got, want):
    """Elements whose bits differ, NaN for NaN."""
    nan = torch.isnan(want)
    return int((torch.isnan(got) != nan).sum()) + int(
        ((got.view(torch.int32) != want.view(torch.int32)) & ~nan).sum())


def time_fma(dev):
    for n in FMA_SIZES:
        for form, cols in (("contiguous", 1), ("stride9", 9)):
            a, b, c = fma_operands(n, cols, n + cols, dev)
            lib = bits_differ(torch.addcmul(c, a, b), kfma.fma_plain(a, b, c))
            us = {name: card_and_host_us(fn, FMA_REPS) for name, fn in (
                ("kernel", lambda: kfma.fma(a, b, c)),
                ("plain", lambda: kfma.fma_plain(a, b, c)),
                ("library", lambda: torch.addcmul(c, a, b)))}
            print(f"fma[{n}/{form}]: "
                  + " ".join(f"{k}_card_us={v[0]:.3f} {k}_host_us={v[1]:.2f}"
                             for k, v in us.items())
                  + f" bound_us={16 * n / PEAK_BYTES_PER_S * 1e6:.3f} "
                  f"addcmul_differs={lib} (of {n})")


def threefry_call(name, R, n, dev):
    """-> (the call for ``name`` over R random keys and n counters, the
    bytes it moves, the hashes it makes)."""
    g = torch.Generator().manual_seed(R + n)
    keys = torch.randint(0, 2**32, (R, 2), generator=g,
                         dtype=torch.int64).to(dev)
    if name == "uniform_sites":
        group = rng.SiteGroups.PT_BOUNCE if n == 6 else rng.SiteGroups.BDPT
        return (lambda: rng.uniform_sites(keys, group, n, bounce=1),
                16 * R + 4 * R * n, R * (1 + n))
    if name == "pixel_keys":
        idx = torch.arange(R, dtype=torch.int64, device=dev)
        return lambda: rng.pixel_keys(keys[0], idx), 24 * R, R
    if name == "uniform_1":
        return lambda: rng.uniform_1(keys[0], n), 4 * n, n
    # randint: split in two, then 32 bits of each key for every draw
    return (lambda: rng.randint(keys[0], n, 0, 30_786), 32 + 16 * n,
            2 + 2 * n)


def time_threefry(dev):
    for name, R, n in THREEFRY_SHAPES:
        fn, nbytes, hashes = threefry_call(name, R, n, dev)
        kernel = card_and_host_us(fn, THREEFRY_REPS)
        on_card = rng._on_card
        rng._on_card = lambda keys: False
        try:
            plain = card_and_host_us(fn, THREEFRY_PLAIN_REPS)
        finally:
            rng._on_card = on_card
        bnd = bound(nbytes, hashes * HASH_OPS, PEAK_INT32_PER_S, "integer")
        print(f"threefry[{name}/{R}/{n}]: kernel_card_us={kernel[0]:.3f} "
              f"kernel_host_us={kernel[1]:.2f} plain_card_us={plain[0]:.3f} "
              f"plain_host_us={plain[1]:.2f} bound_us={bnd[0] * 1e3:.3f} "
              f"({bnd[1]})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="fold,fma,threefry")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    for module in (k1, k2, k3, kfma, kt):
        module.build()
    for lib, log in BUILD_LOG.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas[{lib}]: {line.strip()}")
    only = args.only.split(",")
    if "fold" in only:
        time_folds(dev, args.reps)
    if "fma" in only:
        time_fma(dev)
    if "threefry" in only:
        time_threefry(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
