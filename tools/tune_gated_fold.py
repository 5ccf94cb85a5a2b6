"""Builds and register caps of the dense fold kernels, timed on one GPU.

For each path in ``--paths`` it renders nothing: it records the primary and
first bounce batches of one 1024^2 pt_nee sample of chip_smoke.py's scene,
sorts them and builds their shortlists as the packet engine does, then runs
every build of that path's kernel on them. The paths:

* resident_s3, resident_s4, resident_s5: colonnade subdiv 3, 4 and 5 at
  their default (adaptive) cluster width and tile size, the resident route,
  K1 (``csrc/dense_resident.cu``, blocks of at most 128 rays of a tile).
  Its builds: K1 at each cap in ``--caps`` (``k1_cap64``, ...), K2's kernel
  as its wrapper builds it (``k2``), and each ``--baseline NAME=SRC``:
  another K1 source, built with the headers beside it, e.g. an earlier
  commit's ``csrc/dense_resident.cu`` unpacked with ``git archive`` or a
  design to try against the shipped one (its launch takes K after C and
  the pack's rows after K, as this one's does, K alone, as the K1 before
  the Moller-Trumbore instance did, or neither, as the ray-stationary K1
  did; the tool reads which from the source);
* stream: colonnade subdiv 6, adaptive C = 1024, K2 (``csrc/dense.cu``) at
  each cap;
* super: colonnade subdiv 5, C = 256, super_factor 8, K3
  (``csrc/dense_super.cu``) at each cap.

All builds of a path start at once; ptxas's registers and spills are
printed for each. Every build must return the path's reference result (the
path's kernel through its wrapper; K2's on K1's paths) bit for bit: a
build that fails to build or differs is reported, left out, and makes the
tool exit 1 at its end. Builds are timed by CUDA
events in turns (in order, then in reverse), ``--reps`` launches each. Each
build with a counting instance (every build here but the baselines, unless
``--baseline-counts``) then runs it once: clusters folded, lane tests
issued, waste (issued over ``ops/kernels/work.py:needed_work``'s tests) and
each phase's share of the fold's clock cycles (``dense_resident.PHASES``).
With ``--windows N``, each resident path then renders N timed 2-spp 1024^2
windows with each build of ``--render-builds`` in place of K1's kernel, in
turns, and prints each build's Mrays/s.

Run on a CUDA machine from the repo root:
    python3 tools/tune_gated_fold.py [--paths resident_s3,stream]
        [--caps 0,64,72,80,96] [--baseline old=SRC [--baseline NAME=SRC]
        [--baseline-counts]] [--reps 3]
        [--windows 4 --render-builds k1_cap64,k2,old]
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import cudapathtracer_tpu_torch as cpt  # noqa: E402
from cudapathtracer_tpu_torch.models import procedural  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels import dense as k2  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels import dense_resident as k1  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels import dense_super as k3  # noqa: E402
from cudapathtracer_tpu_torch.ops.kernels.work import needed_work  # noqa: E402
from cudapathtracer_tpu_torch.ops.rng import prng_key  # noqa: E402
from cudapathtracer_tpu_torch.render import renderer  # noqa: E402
from cudapathtracer_tpu_torch.utils.build import BUILD_LOG  # noqa: E402

SUPER = dict(cluster_size=256, two_level_cull="super", super_factor=8,
             super_list=255)
PATHS = {
    # label: (subdiv, RenderConfig knobs, kernel family)
    "resident_s3": (3, {}, "k1"),
    "resident_s4": (4, {}, "k1"),
    "resident_s5": (5, {}, "k1"),
    "stream": (6, {}, "k2"),
    "super": (5, SUPER, "k3"),
}
# family: (source, launch symbol, its int arguments)
FAMILIES = {"k1": (k1.SOURCE, "dense_resident_launch", 6),
            "k2": (k2.SOURCE, "dense_stream_launch", 6),
            "k3": (k3.SOURCE, "dense_super_launch", 7)}


def launch_ints(src):
    """The int arguments of ``dense_resident_launch`` in K1 source ``src``:
    6 where it takes K and the pack's rows after C, 5 where it takes K
    alone, 4 where it takes neither. The binding also passes the
    visibility band (0 here), a float after the ints; a source from before
    the visibility instance ignores it (on x86-64 a float goes in a vector
    register, so the stream argument keeps its place)."""
    with open(src) as fh:
        text = fh.read()
    sig = text[text.index("dense_resident_launch("):]
    sig = sig[:sig.index(")")]
    return len(re.findall(r"\bint\s+\w+", sig))


def builds_for(family, caps, baselines, baseline_counts):
    """-> [(name, source, symbol, ints, flags, headers, counts)]."""
    src, sym, n = FAMILIES[family]
    capf = [(cap, [f"-maxrregcount={cap}"] if cap else []) for cap in caps]
    if family != "k1":
        return [(f"{family}_cap{cap}", src, sym, n, f, k1.HEADERS, True)
                for cap, f in capf]
    out = [(f"k1_cap{cap}", src, sym, n, f, k1.HEADERS, True)
           for cap, f in capf]
    out.append(("k2", k2.SOURCE, "dense_stream_launch", 6,
                k1.GATED_FOLD_FLAGS, k1.HEADERS, True))
    for name, path in baselines:
        path = os.path.abspath(path)
        src_dir = os.path.dirname(path)
        headers = [os.path.join(src_dir, h) for h in os.listdir(src_dir)
                   if h.endswith(".cuh")]
        out.append((name, path, "dense_resident_launch", launch_ints(path),
                    [], headers, baseline_counts))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--caps", default="0,64,72,80,96")
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="NAME=SRC")
    ap.add_argument("--baseline-counts", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--windows", type=int, default=0)
    ap.add_argument("--render-builds", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_gated_fold: no CUDA device", file=sys.stderr)
        return 1
    caps = [int(c) for c in args.caps.split(",")]
    paths = args.paths.split(",")
    baselines = [b.split("=", 1) for b in args.baseline]
    if any(len(b) != 2 or b[0].startswith(("k1_", "k2", "k3_"))
           for b in baselines):
        ap.error("--baseline takes NAME=SRC, NAME not k1_..., k2 or k3_...")
    dev = torch.device("cuda:0")
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}")

    families = sorted({PATHS[p][2] for p in paths})
    jobs = {b[0]: b for f in families
            for b in builds_for(f, caps, baselines, args.baseline_counts)}

    def build(job):
        name, src, sym, n, flags, headers, _ = job
        stem = os.path.splitext(os.path.basename(src))[0]
        lib = f"lib{stem}_{name}.so"
        try:
            return name, (lib, k1.load_fold_kernel(
                lib, src, sym, n, flags=flags, headers=headers))
        except RuntimeError as e:
            return name, (lib, e)

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(pool.map(build, jobs.values()))
    failed = []                  # builds that did not build or differ
    for name, (lib, fn) in built.items():
        if isinstance(fn, Exception):
            print(f"build[{name}] FAILED: {fn}")
            failed.append(name)
        for line in BUILD_LOG.get(lib, "").splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")

    base_key = prng_key(1234, dev)
    for label in paths:
        subdiv, kw, family = PATHS[label]
        size = chip_smoke.HEADLINE_SIZE
        scene = procedural.to_scene(procedural.colonnade(subdiv=subdiv), dev)
        cfg = cpt.RenderConfig(width=size, height=size, spp=2,
                               integrator="pt_nee", samples_per_call=2,
                               reuse_primary_hit=True, **kw)
        bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size,
                                           cluster_size=cfg.cluster_size)
        prep = renderer.make_packet_prep(scene, bvh)
        cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                              focal_length=2.0, device=dev)
        P = renderer.resolve_tile_size(cfg, scene.num_tris)
        trace_fn = renderer.make_trace_fn(scene, cfg, bvh, prep=prep)
        batches = chip_smoke.record_batches(scene, trace_fn, cam, cfg,
                                            base_key)
        F = cfg.super_factor if family == "k3" else None
        pack = prep.resident_pack
        K = pack[0].shape[0] - 1
        names = [n for n in jobs if _timed_on(family, n)
                 and n not in failed]
        print(f"{label}: tris={scene.num_tris} K={K} C={pack[0].shape[2]} "
              f"P={P} builds={names}")
        for bname, batch in batches.items():
            sl = chip_smoke.sorted_shortlists(batch, prep.pdata, P, cfg,
                                              super_factor=F)
            fargs = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
            want = (k3.dense_intersect_super(*fargs, F) if F
                    else k2.dense_intersect(*fargs))
            needed = needed_work(sl, want[0], pack, scene.num_tris, F)[0]

            def run(name, counts_out=None):
                fn = adapt(built[name][1], jobs[name][3])
                extra = (F, K) if family == "k3" else (K,)
                return k1.launch_fold(lambda: fn, name, *fargs, extra=extra,
                                      counts_out=counts_out)

            for name in list(names):
                got = run(name)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    print(f"{label}/{bname}: {name} DIFFERS from the "
                          "reference; left out")
                    failed.append(name)
                    names.remove(name)
            ms = {name: [] for name in names}
            for name in names + names[::-1]:
                ms[name].append(chip_smoke.cuda_ms(lambda: run(name),
                                                   args.reps))
            print(f"{label}/{bname}: P={P} C={pack[0].shape[2]} "
                  f"tiles={sl.ids.shape[0]} tests_needed={needed} "
                  + " ".join(f"{n}_ms={sum(v) / len(v):.4f} "
                             f"({v[0]:.4f}, {v[1]:.4f})"
                             for n, v in ms.items()))
            for name in names:
                if not jobs[name][6]:
                    continue
                counts = torch.empty((sl.ids.shape[0], k1.COUNT_COLS),
                                     dtype=torch.int64, device=dev)
                got = run(name, counts)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    print(f"{label}/{bname}: {name}'s counting instance "
                          "DIFFERS from the reference")
                    failed.append(name)
                groups = (P // k1.k1_group(P) if name.startswith("k1_")
                          else F or 1)
                print(f"{label}/{bname}: {name} "
                      + chip_smoke.count_line(counts, int(sl.counts.sum())
                                              * groups, needed)[0])
        if args.windows and family == "k1":
            render_in_turns(label, built, jobs, [
                n for n in args.render_builds.split(",")
                if n in names], scene, bvh, prep, cam, cfg, base_key,
                args.windows)
        del scene, bvh, prep, trace_fn, batches
        torch.cuda.empty_cache()
    if failed:
        print(f"failed: {sorted(set(failed))}")
    return 1 if failed else 0


def render_in_turns(label, built, jobs, names, scene, bvh, prep, cam, cfg,
                    base_key, windows):
    """Render ``windows`` 1024^2 windows of cfg.spp spp with each K1 build
    of ``names`` put in place of the wrapper's kernel, in turns (in order,
    then in reverse, a warm-up window before each turn), and print each
    build's Mrays/s over all its windows and per window."""
    load = k1._load_kernel
    dev = cam.pos.x.device

    def install(name):
        fn = adapt(built[name][1], jobs[name][3])
        k1._load_kernel = lambda: fn

    def window():
        return cpt.render_batch(scene, bvh, cam, cfg, base_key,
                                cpt.init_accum(cfg, device=dev), cfg.spp,
                                prep=prep)

    walls = {n: [] for n in names}
    try:
        for name in names + names[::-1]:
            install(name)
            window()
            torch.cuda.synchronize()
            for _ in range(windows):
                _, ms = chip_smoke.host_ms(window)
                walls[name].append(ms / 1e3)
    finally:
        k1._load_kernel = load
    rays = cfg.num_pixels * cfg.spp * (cfg.num_bounces + 1)
    print(f"{label}/render: {cfg.width}x{cfg.height} spp={cfg.spp} "
          f"windows={2 * windows} per build (in turns {names} and back) "
          + " ".join(f"{n}_mrays_per_s={rays * len(w) / sum(w) / 1e6:.3f} "
                     f"(windows {rays / max(w) / 1e6:.3f}-"
                     f"{rays / min(w) / 1e6:.3f})"
                     for n, w in walls.items()))


def adapt(fn, n_ints):
    """A K1 or K2 launch ``fn`` of ``n_ints`` int arguments as
    ``launch_fold`` calls it: (10 pointers, Tl, M, P, C, K, rows, vis band,
    stream), without the rows for a source of 5 ints and without K and the
    rows for one of 4 (K3's builds all take 7: F, K and the rows)."""
    if n_ints == 5:
        return lambda *a: fn(*a[:15], *a[16:])
    if n_ints == 4:
        return lambda *a: fn(*a[:14], *a[16:])
    return fn


def _timed_on(family, name):
    """Whether build ``name`` runs on a path of ``family``: K1's paths run
    K1's builds, K2's kernel and the baselines; the others their caps."""
    if family == "k1":
        return not name.startswith(("k2_", "k3_"))
    return name.startswith(f"{family}_cap")


if __name__ == "__main__":
    sys.exit(main())
