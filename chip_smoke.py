"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's render paths (PT+NEE and BDPT through the packet engine
and its CUDA kernels K1, K2 and K3, with either triangle intersector, each
cull and the batching knobs) at the JAX bench's sizes, its other two
engines and its differentiable pass (the bench's train step), and checks
them:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: K1, K2, K3 (nvcc, sm_90a; each with its Baldwin-Weber and
   Moller-Trumbore instances) and the native BVH builder, all started
   together, timed; each instance's registers and spills as ptxas reports
   them;
3. goldens: all five of tests/goldens/ on the card under the golden tests'
   rule: the pt_nee Cornell renders at 64x64 16 spp and 128x128 8 spp, the
   analytic-sphere one at 32x32 8 spp (ray_sphere on the card), the BDPT
   one at 32x32 8 spp (the default integrator) and the BVH falsecolor of
   colonnade subdiv 2 at 64x64 (the fine-BVH walk with its visit counts);
4. engines: a 32x32 pt_nee Cornell render with traversal="bvh" and one
   with traversal="brute": bit-identical images, and no fold kernel or
   plain fold runs;
4b. fma: the glue's FMA kernel (csrc/fma.cu) against its plain version,
   the float64 emulation, bit for bit (NaN for NaN): on the hard cases of
   tests/test_torch_fma.py, on FMA_BITS_N random bit patterns and as many
   triples whose result lives in the product's low bits, and at the main
   paths' lane counts FMA_SIZES, as contiguous tensors and as columns of
   9-wide tables. At each of those the kernel, its plain version and the
   library's nearest op, torch.addcmul (its differing bits printed), are
   timed on the card (FMA_REPS calls enqueued behind a spin, so the events
   hold the card's time alone) and on the host (the time to enqueue a call),
   beside the bound, 16 bytes an element. Every render path below must
   launch it beside its fold kernel;
4c. threefry: the RNG's kernel (csrc/threefry.cu) against its plain
   version, the int64 hash, bit for bit, at the cells' shapes
   THREEFRY_SHAPES (uniform_sites over R keys and n rows, pixel_keys over
   R keys, and one key's 65,536 draws of uniform_1 and randint's split
   and draws), timed as step 4b times the FMA (card and host us a call,
   the plain version beside it) with the bound, the larger of its integer
   work (HASH_OPS a hash) and its bytes. Every render path below must
   launch it too;
5. headline (resident route, K1): colonnade subdiv 3 (20,884 triangles,
   adaptive C = 256, P = 256). On the primary batch and a sorted bounce
   batch of a real pt_nee sample: K1 against its plain version on the
   full batch; K1 against K2 on the same shortlists, bit for bit, both
   timed in turns (K2, K1, K1, K2); both counting instances (waste,
   fold_fraction, the phase spans); K1's clusters folded against a plain
   count of its schedule (blocks of 128 rays) on SAMPLE_TILES sampled
   tiles; the bound.
   Then the fine-BVH fallback (64x64 primary rays with a one-cluster
   shortlist, so the fallback runs on the card; hits equal to brute
   force's), one sample's trace calls, and HEADLINE_WINDOWS timed 1024^2
   windows of HEADLINE_SPP spp after a warm-up;
6. mt (resident route, K1's Moller-Trumbore instance): the same scene with
   intersector="mt" (its own pack, rows v0, e1, e2): the checks of step 5
   with the MT instances (K1 against its plain version on the full
   primary batch and SAMPLE_TILES sampled bounce tiles, K1 against K2 bit
   for bit in turns, counting instances, the schedule); on the bounce
   batch K3's MT instance on super shortlists of BDPT_SUPER_F against its
   plain version and, bit for bit, K1's on the flat shortlists; MT against
   BW on the same rays (t within MT_BW_RTOL where both hit, hit/miss flips
   under MT_BW_FLIPS_MAX); K1's MT visibility instance with caps near each
   ray's hit; the MT fallback against MT brute force; one sample's trace
   calls; MT_WINDOWS windows of MT_SPP spp, K1 alone launching;
7. resident_82k (K1): colonnade subdiv 4 (82,324 triangles, adaptive
   C = 512, P = 256): the checks of step 5, K1 against its plain version
   on SAMPLE_TILES sampled tiles, one sample's trace calls and
   PATH_WINDOWS windows of PATH_SPP spp;
8. resident_wide (K1): colonnade subdiv 5 (328,084 triangles) at its
   default adaptive C = 1024, P = 128: the same;
9. stream (K2): colonnade subdiv 6 (1,311,124 triangles, adaptive C = 1024,
   flat cull past the resident budget): K2 against its plain version on
   sampled tiles, K2 against K1 bit for bit on the full batches, timed in
   turns (K1, K2, K2, K1), both counting instances, K2's clusters folded
   against a plain count of its block schedule, the windows; then
   stream_mt, the same with K2's MT instance and MT_VARIANT_WINDOWS
   windows;
10. super (K3): colonnade subdiv 5, C = 256, two_level_cull="super",
   super_factor 8, super_list 255: the same steps, with K1 on the flat
   shortlists of the same rays beside K3; then super_mt with K3's MT
   instance;
11. bdpt (K1): colonnade subdiv 3, BDPT at 512x512 (the JAX bench's BDPT
   configuration, one sample a batch). The checks of step 5 on one
   sample's three batches: the primary (R rays; K1 against its plain
   version on the full batch), the joint subpath batch (2R) and the
   connection batch (4R, capped at each segment's length + 2 eps; its
   shortlists carry the caps). Then the visibility instances of K1, K2
   and K3 (super shortlists of 8, with their bound) on the connection
   rays, each against its closest-hit instance on the whole batch and its
   plain version on sampled tiles, timed beside it in turns, and the
   packet engine's visibility decisions against its closest-hit ones; one
   sample's trace calls; PATH_WINDOWS windows of 8 spp with vis_dropout
   off and on in turns, whose images must be bit-identical, K1 alone
   launching;
12. train (K1): the bench's train step (bench.py:189-225): colonnade
   subdiv 3 at TRAIN_SIZE^2, pt_nee, 1 spp, primary hit not reused, the L2
   loss against a key-9 target through render_grad.make_loss_fn and one
   SGD step (lr 1e-4), interior only and with both boundary terms at
   TRAIN_EDGE_SAMPLES samples each. Each: K1 launched once per trace call
   of the forward and of the per-sample recompute and nothing else ran;
   the recompute's hit ids equal the forward's bit for bit; the loss and
   every gradient finite; a repeat's gradients within TRAIN_REPEAT_FRAC of
   each array's largest |g|; the step's wall (median of TRAIN_STEPS after
   a warm-up), its forward, the no-grad forward, grad Mrays/s, K1's
   CUDA-event ms and peak memory. Then K1 on the step's bounce batch
   against its plain version, its counting instance and bound; a central
   finite difference of the loss in the most-seen material's albedo.x
   (tests/test_diff.py:57's rule); render_and_grad on the card against
   the CPU at TRAIN_PARITY_SIZE^2 with both terms (the CPU parity tests'
   tolerances); and a BDPT render_and_grad at TRAIN_BDPT_SIZE^2;
13. cli (K1): host I/O and the CLI. ``cli.main`` in this process renders
   the reference's live config (``render --scene cornell-sphere
   --integrator bdpt --size 512 --spp 99``, kernel.cu:28-35) three times:
   whole to a PNG, killed at CLI_KILLED_SPP with a checkpoint every
   CLI_CHECKPOINT_EVERY samples, and resumed to 99 from that checkpoint.
   The two PNGs must be equal byte for byte, the checkpoint's n must read
   99, the PNG must equal finalize_image flipped in x, and each run must
   launch K1 alone; K1 is held against its plain version on the live
   config's primary batch; the runs' walls, the CLI's Mrays/s and the
   checkpoint's save and load ms are printed. Then one CLI run in a fresh
   process (CLI_FRESH_SPP spp; it must not import jax); the reference's
   own CornellBox-Original, written from its embedded OBJ text and
   rendered through ``--obj`` (BDPT, 512^2, CLI_ORIGINAL_SPP spp: finite,
   its maximum above 150, the left wall red and the right green); colonnade
   subdiv OBJ_SUBDIV (328,084 triangles) written by ``write_obj`` and
   loaded through the native parser onto the card (write, parse, upload and
   load_obj seconds; its arrays equal to_scene's up to write_obj's stable
   sort by material), rendered at OBJ_SIZE^2 pt_nee OBJ_SPP spp through K1
   alone within the golden rule of the procedural scene's render, K1
   against its plain version on sampled bounce tiles; and ``heatmap
   --scene cornell --size 512 --falsecolor`` (36 CSV lines ending in a
   comma, a falsecolor image not all zero);
14. sharded (K1): the tile-sharded render, train step, checkpoints and
   CLI over torch.distributed (parallel/). (a) A one-rank NCCL group in
   this process: the headline through ``render_sharded`` and
   ``render_batch`` in turns (unsharded, sharded, sharded, unsharded),
   bit-identical, gathered over NCCL bit for bit, K1 alone launching, both
   Mrays/s; one BDPT 512^2 window each, bit-identical. (b) Two ranks on
   this card over gloo (NCCL refuses two ranks on one device), spawned
   with a time limit: the gathered headline equals (a)'s image bit for
   bit, K1 alone launching on each rank, each rank's wall; a sharded
   checkpoint at half the samples resumed to all of them equals the
   uninterrupted range bit for bit, and a load at one rank raises; the
   train step at TRAIN_SIZE^2 (interior, then both boundary terms at
   TRAIN_EDGE_SAMPLES) through ``make_sharded_grad_fn``: the all-reduced
   loss within rtol 1e-5 and the gradients within TRAIN_REPEAT_FRAC of
   each array's largest |g| of the one-process step's, and the update of
   one SGD step (at a rate that moves every parameter array by at least
   SGD_STEP_FRAC of its largest |p|) within TRAIN_REPEAT_FRAC of lr times
   each array's largest |g|. (c) ``cli.main(["render",
   "--sharded", ...])`` on the live config killed at CLI_KILLED_SPP and
   resumed: the PNG byte-identical to phase 13's unsharded PNG, K1 alone.
   (d) The contiguous Morton split: for each world in SPLIT_WORLDS each
   rank's range of the headline and of BDPT 512^2 rendered alone, one
   sample: K1's lane tests (its counting instance) and the range's
   CUDA-event ms, and worst over mean of each. Then K1 on rank 0 of 2's
   bounce batch, as step 5 checks a batch.
15. twolevel (K2, then K1): (a) colonnade subdiv TWOLEVEL_SUBDIV (1,311,124
   triangles) at cluster_size TWOLEVEL_C (K = 3,700, its pack past the
   resident budget), two_level_cull left at auto: the route must be the
   capped two-level cull with K2 (printed with Ms, M and P); one sample's
   trace calls with the rays its fallback walk took, the walk's steps and
   ms (``fallback[twolevel]``); on the primary and sorted bounce batches
   K2 on the two-level shortlists as step 9 checks a batch (K1 beside it
   bit for bit, plain on SAMPLE_TILES sampled tiles, both counting
   instances, the schedule, the bound); the trace's hits against the flat
   cull's (two_level_cull=False, K2 over all K clusters) on the same rays
   bit for bit, each trace's ms and peak memory; TWOLEVEL_WINDOWS windows
   of TWOLEVEL_SPP spp of each cull in turns, K2 alone launching, images
   bit-identical. (b) BDPT 512^2 (step 11's scene) at sample_batch 2 and 1
   in turns, KNOB_WINDOWS windows of 8 spp each: bit-identical images, K1
   alone, K1's launches per sample, Mrays/s, peak memory; K1 on the joint
   subpath batch of two samples (4R rays) as step 5 checks a batch.
   (c) The headline at its default, sample_batch 2, packet_rounds 2 with
   packet_first_round 2 and sort_window KNOB_SORT_WINDOW in turns, the
   same checks and numbers.
16. entry (K1): the port's graft entry points
   (cudapathtracer_tpu_torch/entry.py) and the quirk flags. (a)
   ``entry()``'s forward step (cornell_with_sphere_mesh(subdiv=2), 356
   triangles, 128^2 pt_nee, 1 spp): the resident route, one warm run and
   ENTRY_RUNS runs timed by CUDA events (median ms, Mrays/s), K1 alone
   launching; the image finite and lit, against ``entry("cpu")``'s under
   the golden rule, its worst relative gap; K1 against its plain version
   on the step's primary and bounce batches as step 5 checks a batch. (b)
   The dry run (``dryrun_ranks``, ``dryrun_loss``): one rank over NCCL,
   two gloo ranks sharing this card and two on the CPU; finite losses
   within DRYRUN_RTOL of each other, K1 alone launching on every card
   rank. (c) Each of QUIRK_CASES (every quirk flag with each integrator
   that reads it) rendered at QUIRK_SIZE^2, QUIRK_SPP spp on the card,
   K1 alone, against the same render on the CPU (QUIRK_WORKERS worker
   processes of one torch thread, started after (a)'s timing) under the
   golden rule; a flag must change the CPU image, and the card's in the
   same pixels.
   The phase's wall is printed.
17. bench (K1, K2, K3): the port's bench harnesses
   (cudapathtracer_tpu_torch/bench.py, bench_scaling.py). (a)
   ``bench.parts`` at bench.py's defaults in this process: the headline
   (colonnade subdiv 3, 1024^2, 16 spp), the sweep (subdiv 4, 5 and 6 at 8
   spp), BDPT 512^2 at sample_batch 2 and the train step at 256^2, each
   the best of 3 windows after a warm-up; every count at 0 before each part
   and read after it (BENCH_PART_KERNEL: K1 alone, K2 alone at subdiv 6,
   no plain call); the assembled line printed as ``bench:`` with every key
   of bench.py's default run, each value finite and above 0, its
   baselines bench.py's formulas; the headline's K1 and subdiv 6's K2 on
   their bounce batches as step 5 checks a batch (sampled tiles). (b) The
   super knobs (BENCH_SUPER_ENV): K3 alone, and on its bounce batch. (c)
   ``python -m cudapathtracer_tpu_torch.bench`` in a fresh process, the
   headline only, where jax cannot be imported: one JSON line with the
   headline's keys, its context line naming the card. (d) ``python -m
   cudapathtracer_tpu_torch.bench_scaling`` at its defaults (world 1 over
   NCCL): value 1.0, the five keys, K1 alone, a profiler trace holding
   K1's kernel events; then two gloo ranks sharing this card: the gathered
   image world 1's bit for bit (its efficiency is not a scaling number).
   The phase's wall is printed.

Each render path runs with every kernel's launch count and every plain
version's call count set to 0 just before its timed windows and read just
after; the path's kernel must have launched and nothing else may have run.
A kernel's bound is the larger of the bytes its inputs need over the card's
memory rate and the float32 operations of the ray-triangle tests they need
over its float32 rate (``ops/kernels/work.py:needed_work``, with the
intersector's operations per test, ``OPS_PER_TEST``). A kernel's
counting instance gives the clusters it folded (once per group of rays that
folds one: K1's blocks of 128 rays, K2's block per tile, K3's members),
the lane tests it issued (a lane test is one test body run by one lane, its
result used or not) and the clock cycles of each phase of its fold; waste
is issued over needed,
and fold_fraction is folded over (group, slot) pairs listed. Counting
launches are not timed and are not the path's. Each phase prints lines of
its own; any failure raises. The line before the last is a JSON summary of
the kernels (fma with its launches in the headline windows and its
numbers at each lane count, one K1 entry per resident path, with the bounce
batch's numbers, dense_resident_mt/mt, dense_mt and dense_super_mt for the
Moller-Trumbore instances, dense_resident/bdpt with the connection
batch's numbers and the visibility instances' times, and dense_resident/train
with K1's launches per interior train step, its time on the step's bounce
batch and its ms summed over each step, and dense_resident/cli with K1's
launches in the live config's whole run and per sample there and on the OBJ
path, and its time on the OBJ path's bounce batch, and
dense_resident/sharded with K1's launches in the world-1 sharded windows
and per rank per sample on two ranks, its time on a rank's bounce batch,
both worlds' Mrays/s and the split's worst/mean figures, and dense/twolevel
with K2's numbers on the two-level bounce batch, its launches in the
two-level windows and per sample, the fallback's rays, steps and ms per
sample, both culls' trace ms and Mrays/s, and the sample_batch, rounds
and window variants' Mrays/s and K1 launches per sample, and
dense_resident/entry with K1's numbers on the entry's bounce batch, its
launches in the timed entry runs, the entry's ms and Mrays/s, the dry
runs' losses and K1 launches per rank and each quirk case's gaps, and
dense_resident/bench, dense/bench and dense_super/bench with the bench
parts' launches (K1's summed over its parts and by part), each kernel's
numbers on its part's bounce batch, the bench's lines and the scaling
runs' lines), the last line the device record.

Run: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(REPO, "tests", "goldens")
HEADLINE_SIZE = 1024
HEADLINE_SPP = 4
HEADLINE_WINDOWS = 5
PATH_SPP = 2
PATH_WINDOWS = 5
# the JAX bench's BDPT configuration (bench.py:150-187) but one sample a
# batch: 512^2, windows of 8 spp, colonnade subdiv 3
BDPT_SIZE = 512
BDPT_SPP = 8
# clusters per super of the visibility instances' super shortlists
BDPT_SUPER_F = 8
SAMPLE_TILES = 512
FALLBACK_SIZE = 64
# the mt path: windows of 4 spp, 3 of them; the MT variants of the stream
# and super paths: 2 windows of PATH_SPP
MT_SPP = 4
MT_WINDOWS = 3
MT_VARIANT_WINDOWS = 2
# the bvh and brute engines' Cornell render
ENGINE_SIZE = 32
ENGINE_SPP = 4
# Moller-Trumbore against Baldwin-Weber on the same rays, the JAX package's
# contract (tests/test_packets.py:364-386)
MT_BW_RTOL = 2e-5
MT_BW_FLIPS_MAX = 0.06
# the visibility band of the mt path's check: BDPT's 3 * EPS_VISIBILITY
VIS_BAND = 0.03
# kernel vs plain: ids may differ only on exact-t ties, as the JAX
# package's own engines do
ID_MISMATCH_MAX = 1e-5
T_RTOL = 1e-6
# the train step (phase 12): bench.py:189-225's size, both boundary terms
# at a quarter of the pixels each, the timed steps, the repeat's limit (of
# each gradient array's largest |g|), the card-vs-CPU and BDPT sizes
TRAIN_SIZE = 256
TRAIN_EDGE_SAMPLES = 16384
TRAIN_STEPS = 3
TRAIN_REPEAT_FRAC = 1e-5
TRAIN_PARITY_SIZE = 16
TRAIN_BDPT_SIZE = 128
# the CLI (phase 13): the reference's live config (kernel.cu:28-35), killed
# at CLI_KILLED_SPP and resumed; an OBJ at the scale users load
CLI_SIZE = 512
CLI_SPP = 99
CLI_KILLED_SPP = 48
CLI_CHECKPOINT_EVERY = 16
CLI_FRESH_SPP = 8
CLI_ORIGINAL_SPP = 16
OBJ_SUBDIV = 5
OBJ_SIZE = 1024
OBJ_SPP = 4
# the sharded phase (14): the SGD check's rate, set so that every parameter
# array moves by at least this share of its largest |p| (an update far
# past float32's rounding of the parameters), the two gloo ranks' time
# limit, the worlds whose contiguous split is measured
SGD_STEP_FRAC = 0.1
RANK_TIMEOUT_S = 600
SPLIT_WORLDS = (2, 4, 8)
# the two-level phase (15): colonnade subdiv 6 at C = 512 (K = 3,700, its
# pack past the resident budget), 1-spp windows of each cull in turns; the
# knobs' windows (BDPT at sample_batch 2 and 1, the headline's variants)
# and the headline's sort window
TWOLEVEL_SUBDIV = 6
TWOLEVEL_C = 512
TWOLEVEL_SPP = 1
TWOLEVEL_WINDOWS = 2
KNOB_WINDOWS = 2
KNOB_SORT_WINDOW = 65536
# the entry phase (16): the entry's timed runs; the quirk flags' renders of
# cornell_with_sphere_mesh(subdiv=2) (size, spp, seed), each case with the
# integrators that read its flag, the default of each first; the CPU
# references' worker processes (one torch thread each); the dry runs'
# agreement
ENTRY_RUNS = 5
QUIRK_SIZE = 64
QUIRK_SPP = 4
QUIRK_SEED = 9
QUIRK_CASES = (
    ("pt_nee", {}),
    ("pt_nee", {"orthonormal_frame": True}),
    ("pt_nee", {"light_normal_mode": "true"}),
    ("pt_nee", {"branch_pdf_correction": True}),
    ("pt_nee", {"compensated_accum": False}),
    ("pt_nee", {"jitter": True}),
    ("bdpt", {}),
    ("bdpt", {"orthonormal_frame": True}),
    ("bdpt", {"compensated_accum": False}),
)
QUIRK_WORKERS = 5
DRYRUN_RTOL = 1e-5
# the bench phase (17): the kernel each part of bench.py's default run must
# launch alone, the super knobs' run (BASELINE.md:123-130) and the JSON's
# keys
BENCH_PART_KERNEL = {"headline": "k1", "mrays_82k": "k1", "mrays_328k": "k1",
                     "mrays_1310k": "k2", "bdpt": "k1", "train": "k1"}
BENCH_HEADLINE_ONLY = {"BENCH_SWEEP": "0", "BENCH_BDPT": "0",
                       "BENCH_TRAIN": "0"}
BENCH_SUPER_ENV = dict(BENCH_HEADLINE_ONLY, BENCH_SUBDIV="5", BENCH_C="256",
                       BENCH_TWO_LEVEL="super")
BENCH_HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
BENCH_KEYS = BENCH_HEADLINE_KEYS | {
    "mrays_82k", "mrays_328k", "mrays_1310k", "mrays_328k_vs_baseline",
    "bdpt_mrays", "bdpt_vs_baseline", "train_step_ms", "grad_mrays"}
SCALING_KEYS = {"metric", "value", "unit", "vs_baseline", "profile_artifact"}
# one H100 SXM (its data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# the glue's lanes: the 1024^2 PT+NEE pass, the 512^2 BDPT pass and the
# 256^2 train step
FMA_SIZES = (1_048_576, 262_144, 65_536)
FMA_BITS_N = 2 ** 22
FMA_REPS = 100
# the RNG's calls at the cells' lane counts: (call, keys, counters); int32
# operations a threefry2x32 hash (20 rounds of add, rotate and xor, 5 key
# injections of 2 adds, the first 2 adds, the third key word) and the
# integer pipe's rate (64 a clock on each of 132 SMs at 1.98 GHz)
THREEFRY_SHAPES = (("uniform_sites", 1_048_576, 6),
                   ("uniform_sites", 262_144, 7),
                   ("uniform_sites", 65_536, 6),
                   ("pixel_keys", 1_048_576, 1),
                   ("uniform_1", 1, 65_536),
                   ("randint", 1, 65_536))
THREEFRY_REPS = 100
THREEFRY_PLAIN_REPS = 10
HASH_OPS = 73
PEAK_INT32_PER_S = 132 * 64 * 1.98e9
# the glue's kernels, which launch beside every path's fold kernel
GLUE_KERNELS = ("fma", "threefry")


def image_rule(label, got, want, tol=2, max_frac=0.005):
    """tests/test_goldens.py:_check's rule between two (H, W, 3) u8 images:
    under 0.5% of channels may differ by more than 2. -> that share."""
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shapes {got.shape}, {want.shape}")
    frac = float((np.abs(got.astype(np.int32) - want.astype(np.int32))
                  > tol).mean())
    if frac >= max_frac:
        raise AssertionError(f"{label}: {frac:.4%} of channels differ by "
                             f"more than {tol}")
    return frac


def check_golden(img, path):
    """``image_rule`` on an image before the writer's x flip against the
    golden PPM at ``path``."""
    from cudapathtracer_tpu_torch.utils.ppm import read_ppm

    return image_rule(os.path.basename(path), img[:, ::-1], read_ppm(path))


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


def cuda_ms_once(fn):
    """(result, ms) of one run of ``fn()`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def host_ms(fn):
    """(result, ms) of one synchronized run of ``fn()``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def agreement(label, got, want, rays):
    """Differing ids among live rays and the t gaps where ids agree; raises
    past ID_MISMATCH_MAX or T_RTOL. -> (differing, max_abs_dt)."""
    (t_k, i_k), (t_p, i_p) = got, want
    live = rays[:, 6] > 0.5
    differ = int(((i_k != i_p) & live).sum())
    n_live = int(live.sum())
    same = (i_k == i_p) & live & (i_k >= 0)
    gap = (t_k - t_p).abs()[same]
    rel = gap / t_p.abs()[same]
    max_abs = float(gap.max()) if gap.numel() else 0.0
    max_rel = float(rel.max()) if rel.numel() else 0.0
    print(f"{label}: live_rays={n_live} differing_ids={differ} "
          f"max_rel_dt={max_rel:.3g} max_abs_dt={max_abs:.3g}")
    if differ > ID_MISMATCH_MAX * n_live:
        raise AssertionError(f"{label}: {differ} of {n_live} ids differ")
    if max_rel > T_RTOL:
        raise AssertionError(f"{label}: t differs by {max_rel} relative")
    return differ, max_abs


def bound(tests, nbytes, ops_per_test):
    """(bound ms, "bytes" or "operations") on one H100, for ``tests``
    ray-triangle tests of ``ops_per_test`` float32 operations each
    (``ops/kernels/work.py:OPS_PER_TEST``, an FMA as 2)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = tests * ops_per_test / PEAK_F32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def in_turns(fa, fb, reps):
    """CUDA-event ms of ``fa`` and ``fb``, timed in turns a, b, b, a.
    -> ((a1, a2), (b1, b2))."""
    a1 = cuda_ms(fa, reps)
    b1 = cuda_ms(fb, reps)
    b2 = cuda_ms(fb, reps)
    return (a1, cuda_ms(fa, reps)), (b1, b2)


def count_line(counts, listed, needed):
    """A counting instance's per-tile counts (Tl, COUNT_COLS) as one line:
    clusters folded (counted once per group of rays that folds them: the
    block, a warp, or per member) against the (group, slot) pairs listed,
    lane tests issued against the tests needed (waste), and each phase's
    share of the fold's clock cycles (``dense_resident.PHASES``) with their
    mean per tile, summed over the tile's warps. -> (line, tests issued)."""
    from cudapathtracer_tpu_torch.ops.kernels.dense_resident import PHASES

    tot = counts.sum(dim=0).tolist()
    folded, issued, spans = tot[0], tot[1], tot[2:]
    cycles = max(sum(spans), 1)
    return (f"folded={folded} listed={listed} "
            f"fold_fraction={folded / max(listed, 1):.4f} "
            f"lane_tests_issued={issued} tests_needed={needed} "
            f"waste={issued / max(needed, 1):.3f} cycles_per_tile="
            f"{cycles / max(counts.shape[0], 1):.0f} "
            + " ".join(f"{p}={v / cycles:.3f}" for p, v in zip(PHASES, spans)),
            issued)


def fold_counts(label, name, fn, args, want, listed, needed):
    """Run ``fn``'s counting instance on ``args`` and print its counts; its
    hits must equal the timed instance's ``want``. -> (per-tile counts
    (Tl, COUNT_COLS), total lane tests issued)."""
    from cudapathtracer_tpu_torch.ops.kernels.dense_resident import COUNT_COLS

    counts = torch.empty((args[0].shape[0], COUNT_COLS), dtype=torch.int64,
                         device=args[0].device)
    out = fn(*args, counts_out=counts)
    if not (torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])):
        raise AssertionError(f"{label}: {name}'s counting instance differs "
                             "from its timed instance")
    line, issued = count_line(counts, listed, needed)
    print(f"{label}: {name} {line}")
    return counts, issued


def sample_tiles(sl, n):
    """The shortlists of about n tiles spread evenly over the batch."""
    Tl = sl.ids.shape[0]
    idx = torch.unique(torch.linspace(0, Tl - 1, min(n, Tl),
                                      device=sl.ids.device).round().long())
    return type(sl)(*(a[idx].contiguous() for a in sl))


def record_batches(scene, trace_fn, cam, cfg, base_key, idx=None, S=1):
    """The batches of one sample of ``cfg.integrator`` as the renderer's
    trace closure receives them, each (o, d, mask, t_cap or None): pt_nee's
    primary and first bounce batches; BDPT's primary batch (R rays), its
    joint subpath batch (2R) and its capped connection batch (4R). ``idx``:
    the Morton pixels traced (default the whole image). ``S``: the first S
    samples traced as one batch, as ``sample_batch`` S traces them (S
    times the rays)."""
    from cudapathtracer_tpu_torch.ops.rng import pixel_keys, sample_key
    from cudapathtracer_tpu_torch.render.camera import camera_rays
    from cudapathtracer_tpu_torch.render.renderer import _radiance

    dev = cam.pos.x.device
    if idx is None:
        idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    calls = []

    def recording(o, d, mask, t_cap=None, vis_band=0.0):
        calls.append((o, d, mask, t_cap))
        return trace_fn(o, d, mask, t_cap=t_cap, vis_band=vis_band)

    keys = torch.cat([pixel_keys(sample_key(base_key, i), idx)
                      for i in range(S)])
    o0, d0 = camera_rays(cam, idx.repeat(S), keys, lens=False)
    _radiance(o0, d0, scene, recording, keys, cfg)
    if cfg.integrator == "bdpt":
        return {"primary": calls[0], "subpath": calls[1],
                "connection": calls[2]}
    return {"primary": calls[0], "bounce1": calls[1]}


def sorted_shortlists(batch, pd, P, cfg, super_factor=None,
                      super_slots=None):
    """Sort one batch's rays (and caps) as the packet engine does and build
    its shortlists (in super units with ``super_factor``; the capped
    two-level cull's, in cluster units, with ``super_slots`` too)."""
    from cudapathtracer_tpu_torch.ops import packets
    from cudapathtracer_tpu_torch.ops.vecmath import Vec3

    o, d, mask, cap = batch
    perm = packets.sort_rays(o, d, mask, pd)
    return packets.build_shortlists(
        Vec3(o.x[perm], o.y[perm], o.z[perm]),
        Vec3(d.x[perm], d.y[perm], d.z[perm]), mask[perm], pd, P,
        cfg.max_clusters, super_factor=super_factor,
        super_list=cfg.super_list, t_cap=None if cap is None else cap[perm],
        super_slots=super_slots)


def trace_breakdown(label, scene, trace_fn, cam, cfg, base_key):
    """One sample (primary trace included) with every trace call timed
    between synchronizes, against the sample's wall time; where the packet
    engine's fallback walk ran, a ``fallback[label]`` line per trace call
    (its live rays, the rays the walk took, its steps and ms) and one for
    the sample. -> (walk rays, steps, ms) summed over the sample."""
    from cudapathtracer_tpu_torch.ops.rng import pixel_keys, sample_key
    from cudapathtracer_tpu_torch.render.camera import camera_rays
    from cudapathtracer_tpu_torch.render.renderer import _radiance

    dev = cam.pos.x.device
    idx = torch.arange(cfg.num_pixels, dtype=torch.int64, device=dev)
    calls = []

    with WalkLog() as walk:
        def timed(o, d, mask, **kw):
            before = len(walk.calls)
            h, ms = host_ms(lambda: trace_fn(o, d, mask, **kw))
            calls.append((int(mask.sum()), walk.calls[before:], ms))
            return h

        def one_sample():
            keys = pixel_keys(sample_key(base_key, 0), idx)
            o0, d0 = camera_rays(cam, idx, keys, lens=False)
            primary = timed(o0, d0, torch.ones(idx.shape, dtype=torch.bool,
                                               device=dev))
            return _radiance(o0, d0, scene, timed, keys, cfg,
                             primary_hit=primary)

        _, wall = host_ms(one_sample)
        walk.count_steps()
    calls = [(rays, *(sum(c[k] for c in fb) for k in range(3)), ms)
             for rays, fb, ms in calls]
    trace_ms = [c[4] for c in calls]
    print(f"{label}: sample trace_calls={len(calls)} trace_ms="
          f"{[round(m, 3) for m in trace_ms]} trace_total_ms="
          f"{sum(trace_ms):.3f} sample_wall_ms={wall:.3f} (synchronize "
          "after every trace call)")
    tot = [sum(c[k] for c in calls) for k in range(4)]
    if tot[1]:
        for i, (rays, fb, steps, walk_ms, ms) in enumerate(calls):
            print(f"fallback[{label}]: trace_call={i} live_rays={rays} "
                  f"fallback_rays={fb} ({fb / max(rays, 1):.4%}) "
                  f"walk_steps={steps} walk_ms={walk_ms:.3f} "
                  f"trace_ms={ms:.3f}")
        print(f"fallback[{label}]: sample live_rays={tot[0]} fallback_rays="
              f"{tot[1]} walk_steps={tot[2]} walk_ms={tot[3]:.3f} of "
              f"trace_ms={sum(trace_ms):.3f}")
    return tot[1], tot[2], tot[3]


class WalkLog:
    """The packet engine's fallback walk while entered: each call's rays,
    synchronized ms and, once ``count_steps`` has run the walks again with
    their stats (untimed), loop steps: ``calls`` [rays, steps, ms]."""

    def __enter__(self):
        from cudapathtracer_tpu_torch.ops import packets

        self._packets, self._orig = packets, packets.trace
        self.calls, self._args = [], []

        def logged(o, d, td, mask=None, intersector="bw"):
            hit, ms = host_ms(lambda: self._orig(
                o, d, td, mask=mask, intersector=intersector))
            self.calls.append([int(mask.sum()), 0, ms])
            self._args.append((o, d, td, mask, intersector))
            return hit

        packets.trace = logged
        return self

    def count_steps(self):
        for call, (o, d, td, mask, isect) in zip(self.calls, self._args):
            call[1] = int(self._orig(o, d, td, mask=mask, with_stats=True,
                                     intersector=isect)[1].steps)
        self._args = []

    def __exit__(self, *exc):
        self._packets.trace = self._orig


def reset_counts(kernels):
    """Every kernel's launch count (and the FMA's count of expanded
    operands) and every plain version's call count to 0."""
    for _, wrapper, plain in kernels.values():
        wrapper.launches = 0
        plain.calls = 0
        if hasattr(wrapper, "expanded"):
            wrapper.expanded = 0


def path_counts(label, kernels, expect):
    """-> (launches by kernel, plain calls) since ``reset_counts``; raises
    unless ``expect`` launched, with the glue's kernels (FMA, threefry)
    where ``kernels`` lists them, and no other kernel nor plain version
    ran."""
    launches = {n: w.launches for n, (_, w, _) in kernels.items()}
    plain_calls = sum(p.calls for _, _, p in kernels.values())
    others = sum(v for n, v in launches.items()
                 if n != expect and n not in GLUE_KERNELS)
    if launches[expect] <= 0 or any(launches.get(n, 1) <= 0
                                    for n in GLUE_KERNELS) or others \
            or plain_calls:
        raise AssertionError(f"{label}: the path did not run through "
                             f"{expect} and the glue's kernels alone: "
                             f"{launches}, {plain_calls} plain calls")
    return launches, plain_calls


def render_windows(label, kernels, expect, run, cfg, spp, windows):
    """One warm-up window, then ``windows`` timed ones with every count at
    0 before them; the image must be finite and lit, ``expect`` and the FMA
    must have launched and nothing else may have run. -> launches by
    kernel."""
    run()
    torch.cuda.synchronize()
    reset_counts(kernels)
    walls = []
    for _ in range(windows):
        t0 = time.perf_counter()
        st = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches, plain_calls = path_counts(label, kernels, expect)
    img = np.stack([c.cpu().numpy() for c in st.img], axis=1)
    finite = bool(np.isfinite(img).all())
    rays = cfg.num_pixels * spp * (cfg.num_bounces + 1)
    dt = sum(walls)
    print(f"{label}: {cfg.width}x{cfg.height} spp={spp} "
          f"bounces={cfg.num_bounces} windows={windows} "
          f"window_seconds={[round(w, 4) for w in walls]} "
          f"mrays_per_s={rays * windows / dt / 1e6:.3f} "
          f"window_mrays_per_s_min={rays / max(walls) / 1e6:.3f} "
          f"max={rays / min(walls) / 1e6:.3f} image_max={img.max():.4f} "
          f"finite={finite} "
          + " ".join(f"{n}_launches={v}" for n, v in launches.items())
          + f" launches_per_sample={launches[expect] / (windows * spp):.2f}"
          f" fma_launches_per_sample={launches['fma'] / (windows * spp):.2f}"
          " threefry_launches_per_sample="
          f"{launches['threefry'] / (windows * spp):.2f}"
          f" fma_expanded={kernels['fma'][1].expanded}"
          f" plain_calls={plain_calls}")
    if img.shape != (cfg.num_pixels, 3) or not finite or img.max() <= 0:
        raise AssertionError(f"{label}: image is not finite and lit")
    return launches


def kernel_entry(name, source, replaces, launches, res):
    return {"name": name, "route": "cuda",
            "source": f"cudapathtracer_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound"][0],
            "bound_by": res["bound"][1], "library_ms": None,
            "tiles": res["tiles"], "plain_tiles": res["plain_tiles"],
            "tests_issued": res["issued"], "tests_needed": res["needed"]}


def fma_operands(n, kind, cols, seed, dev):
    """(a, b, c), n float32 elements each on ``dev``, as columns of
    ``cols``-wide tables (1: contiguous). ``kind`` "bits": random bit
    patterns (every exponent, subnormals, inf and NaN); "near_cancel": c
    near -a*b, so that the result lives in the product's low bits."""
    g = torch.Generator().manual_seed(seed)
    if kind == "bits":
        xs = [torch.randint(-2**31, 2**31, (n, cols), generator=g,
                            dtype=torch.int64).to(torch.int32).view(
                                torch.float32) for _ in range(3)]
    else:
        a, b = (torch.randn((n, cols), generator=g) * 3.0 for _ in range(2))
        xs = [a, b, -(a * b) * (1 + torch.randn((n, cols), generator=g)
                                * 1e-6)]
    return tuple(x.to(dev)[:, 0] for x in xs)


def bits_differ(got, want):
    """Elements whose bits differ, NaN for NaN (a NaN's payload is the
    device's)."""
    nan = torch.isnan(want)
    return int((torch.isnan(got) != nan).sum()) + int(
        ((got.view(torch.int32) != want.view(torch.int32)) & ~nan).sum())


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


def fma_phase(dev):
    """Step 4b: the glue's FMA kernel against its plain version, bit for
    bit, and the kernel, the plain version and torch.addcmul timed at each
    lane count. -> {"<n>/<form>": its numbers}."""
    from cudapathtracer_tpu_torch.ops.kernels import fma as kfma

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_fma import HARD_CASES

    a, b, c = (torch.tensor(col, dtype=torch.float32, device=dev)
               for col in zip(*HARD_CASES))
    want = kfma.fma_plain(a, b, c)
    hard = (bits_differ(kfma.fma(a, b, c), want),
            bits_differ(torch.addcmul(c, a, b), want))
    line = (f"fma: hard_cases={len(HARD_CASES)} kernel_differs={hard[0]} "
            f"addcmul_differs={hard[1]}")
    bad = hard[0]
    for kind in ("bits", "near_cancel"):
        a, b, c = fma_operands(FMA_BITS_N, kind, 1, 7, dev)
        want = kfma.fma_plain(a, b, c)
        differ = (bits_differ(kfma.fma(a, b, c), want),
                  bits_differ(torch.addcmul(c, a, b), want))
        line += (f" {kind}={FMA_BITS_N} kernel_differs={differ[0]} "
                 f"addcmul_differs={differ[1]}")
        bad += differ[0]
    print(line)
    if bad:
        raise AssertionError("fma: the kernel's bits differ from its plain "
                             "version's")
    rows = {}
    for n in FMA_SIZES:
        for form, cols in (("contiguous", 1), ("stride9", 9)):
            differ = lib_differ = 0
            for kind in ("bits", "near_cancel"):
                a, b, c = fma_operands(n, kind, cols, n + cols, dev)
                want = kfma.fma_plain(a, b, c)
                differ += bits_differ(kfma.fma(a, b, c), want)
                lib_differ += bits_differ(torch.addcmul(c, a, b), want)
            us = {name: card_and_host_us(fn, FMA_REPS) for name, fn in (
                ("kernel", lambda: kfma.fma(a, b, c)),
                ("plain", lambda: kfma.fma_plain(a, b, c)),
                ("library", lambda: torch.addcmul(c, a, b)))}
            bound_us = 16 * n / PEAK_BYTES_PER_S * 1e6
            print(f"fma: n={n} form={form} kernel_differs={differ} "
                  f"addcmul_differs={lib_differ} (of {2 * n}) "
                  + " ".join(f"{k}_card_us={v[0]:.3f} {k}_host_us={v[1]:.2f}"
                             for k, v in us.items())
                  + f" bound_us={bound_us:.3f}")
            if differ:
                raise AssertionError(f"fma: n={n} {form}: the kernel's bits "
                                     "differ from its plain version's")
            rows[f"{n}/{form}"] = dict(
                ms=us["kernel"][0] / 1e3, host_us=us["kernel"][1],
                plain_ms=us["plain"][0] / 1e3, plain_host_us=us["plain"][1],
                library_ms=us["library"][0] / 1e3,
                library_host_us=us["library"][1],
                library_differs=lib_differ, bound_ms=bound_us / 1e3)
    return rows


def threefry_call(name, R, n, dev, seed):
    """-> (the call for ``name`` over R random keys and n counters, the
    bytes it moves, the hashes it makes)."""
    from cudapathtracer_tpu_torch.ops import rng

    g = torch.Generator().manual_seed(seed)
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


def threefry_phase(dev):
    """Step 4c: the RNG's kernel against its plain version (the int64
    hash), bit for bit, and both timed at the cells' shapes. -> {"<call>/
    <keys>/<counters>": its numbers}."""
    from cudapathtracer_tpu_torch.ops import rng

    rows = {}
    for name, R, n in THREEFRY_SHAPES:
        fn, nbytes, hashes = threefry_call(name, R, n, dev, R + n)
        got = fn()
        on_card = rng._on_card
        rng._on_card = lambda keys: False
        try:
            want = fn()
            plain = card_and_host_us(fn, THREEFRY_PLAIN_REPS)
        finally:
            rng._on_card = on_card
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        differ = int((got != want).sum()) + abs(got.numel() - want.numel())
        kernel = card_and_host_us(fn, THREEFRY_REPS)
        bound = max((hashes * HASH_OPS / PEAK_INT32_PER_S * 1e6, "integer"),
                    (nbytes / PEAK_BYTES_PER_S * 1e6, "bytes"))
        print(f"threefry: call={name} keys={R} counters={n} "
              f"kernel_differs={differ} (of {want.numel()}) "
              f"kernel_card_us={kernel[0]:.3f} kernel_host_us="
              f"{kernel[1]:.2f} plain_card_us={plain[0]:.3f} plain_host_us="
              f"{plain[1]:.2f} bound_us={bound[0]:.3f} ({bound[1]})")
        if differ:
            raise AssertionError(f"threefry: {name} over {R} keys x {n}: "
                                 "the kernel's bits differ from its plain "
                                 "version's")
        rows[f"{name}/{R}/{n}"] = dict(
            ms=kernel[0] / 1e3, host_us=kernel[1], plain_ms=plain[0] / 1e3,
            plain_host_us=plain[1], bound_ms=bound[0] / 1e3,
            bound_by=bound[1])
    return rows


def band_caps(rays, t, best, seed=11):
    """A capped batch's rays (Tl, 8, P) with each hitting ray's cap (row 7)
    moved near its closest hit t: t + VIS_BAND * u, u from {-1, 0, 1, 2} or
    uniform in [-1, 2] (tests/torch_fold_cases.py:band_caps), so that a
    visibility query retires some rays and keeps others."""
    rng = np.random.default_rng(seed)
    shape = tuple(t.shape)
    u = np.where(rng.random(shape) < 0.5, rng.integers(-1, 3, shape),
                 rng.uniform(-1.0, 2.0, shape)).astype(np.float32)
    cap = t + np.float32(VIS_BAND) * torch.from_numpy(u).to(t.device)
    rays = rays.clone()
    rays[:, 7] = torch.where(best >= 0, cap, rays[:, 7])
    return rays.contiguous()


class TraceLog:
    """Every trace call of the differentiable pass, as ``render_image_diff``
    makes its closure (``render_grad.make_trace_fn``): each call's inputs
    and hit ids, and whether it ran in the backward (the per-sample
    recompute) or the forward."""

    def __init__(self):
        self.calls = []
        self.backward = False

    def __enter__(self):
        from cudapathtracer_tpu_torch.diff import render_grad as rg
        from cudapathtracer_tpu_torch.ops.vecmath import stop_gradient

        self._rg, self._orig = rg, rg.make_trace_fn

        def make(scene, cfg, bvh, prep=None, **kw):
            base = self._orig(scene, cfg, bvh, prep, **kw)

            def fn(o, d, mask, t_cap=None, vis_band=0.0):
                h = base(o, d, mask, t_cap=t_cap, vis_band=vis_band)
                self.calls.append((self.backward, stop_gradient(
                    (o, d, mask, t_cap)), h.tri.clone()))
                return h

            return fn

        rg.make_trace_fn = make
        return self

    def __exit__(self, *exc):
        self._rg.make_trace_fn = self._orig

    def split(self):
        """-> (forward calls, recompute calls), each [(batch, ids)]."""
        fwd = [(b, i) for bwd, b, i in self.calls if not bwd]
        rec = [(b, i) for bwd, b, i in self.calls if bwd]
        return fwd, rec


class K1Timer:
    """CUDA events around every K1 call of the packet engine while
    entered: -> the calls' device ms (``ms()``), read after a
    synchronize."""

    def __init__(self):
        self.pairs = []

    def __enter__(self):
        from cudapathtracer_tpu_torch.ops import packets

        self._packets = packets
        self._orig = packets.dense_intersect_resident

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._orig(*a, **kw)
            stop.record()
            self.pairs.append((start, stop))
            return out

        packets.dense_intersect_resident = timed
        return self

    def __exit__(self, *exc):
        self._packets.dense_intersect_resident = self._orig

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def grads_close(label, got, want, frac, what):
    """Each array of ``got`` within ``frac`` of its largest |g| in
    ``want``; raises otherwise. -> the largest gap over that scale."""
    worst = 0.0
    for a, b in zip(got, want):
        if not b.numel():
            continue
        scale = float(b.abs().max())
        gap = float((a.to(b.device) - b).abs().max())
        worst = max(worst, gap / scale if scale else gap)
        if gap > frac * scale:
            raise AssertionError(f"{label}: {what} gap {gap} past {frac} "
                                 f"of its largest |g| {scale}")
    return worst


def train_kernel_numbers(label, kernels, scene, bvh, cfg, P, batch):
    """K1 on one batch of the train step, as the packet engine sorts and
    shortlists it: its CUDA-event ms, its plain version on sampled tiles
    (ids and t), its counting instance and its bound. -> the numbers of
    its kernels-line entry."""
    from cudapathtracer_tpu_torch.ops.kernels.dense_resident import k1_group
    from cudapathtracer_tpu_torch.ops.kernels.work import (OPS_PER_TEST,
                                                           needed_work)
    from cudapathtracer_tpu_torch.render import renderer

    _, wrap, plain = kernels["k1"]
    prep = renderer.make_packet_prep(scene, bvh)
    pack = prep.resident_pack
    sl = sorted_shortlists(batch, prep.pdata, P, cfg)
    args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
    got = wrap(*args)
    wrap(*args)
    ms = cuda_ms(lambda: wrap(*args), 5)
    part = sample_tiles(sl, SAMPLE_TILES)
    pargs = (part.ids, part.counts, part.entries, part.rays, *pack)
    want_p, plain_ms = host_ms(lambda: plain(*pargs))
    _, gap = agreement(f"kernel[{label}] k1 vs plain on {part.ids.shape[0]} "
                       "sampled tiles", wrap(*pargs), want_p, part.rays)
    tests, _, nbytes = needed_work(sl, got[0], pack, scene.num_tris)
    bnd = bound(tests, nbytes, OPS_PER_TEST["bw"])
    _, issued = fold_counts(f"fold[{label}]", "k1", wrap, args, got,
                            int(sl.counts.sum()) * (P // k1_group(P)), tests)
    print(f"kernel[{label}]: tiles={sl.ids.shape[0]} k1_ms={ms:.4f} "
          f"plain_ms={plain_ms:.1f} (on {part.ids.shape[0]} tiles) "
          f"tests={tests} bytes={nbytes} bound_ms={bnd[0]:.4f} "
          f"bound_by={bnd[1]}")
    return dict(ms=ms, plain_ms=plain_ms, bound=bnd, max_abs=gap,
                tiles=sl.ids.shape[0], plain_tiles=part.ids.shape[0],
                issued=issued, needed=tests)


def train_phase(dev, kernels, size=TRAIN_SIZE,
                edge_samples=TRAIN_EDGE_SAMPLES, parity_size=TRAIN_PARITY_SIZE,
                bdpt_size=TRAIN_BDPT_SIZE, subdiv=3):
    """Phase 12: the bench's train step (bench.py:189-225) on the card,
    interior only and with both boundary terms, and its checks. -> the
    dense_resident/train entry of the kernels line."""
    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch.diff import render_grad as rg
    from cudapathtracer_tpu_torch.diff.edge_sampling import build_edge_table
    from cudapathtracer_tpu_torch.models import procedural
    from cudapathtracer_tpu_torch.ops import packets
    from cudapathtracer_tpu_torch.ops.rng import prng_key
    from cudapathtracer_tpu_torch.render import renderer

    scene = procedural.to_scene(procedural.colonnade(subdiv=subdiv), dev)
    cfg = cpt.RenderConfig(width=size, height=size, spp=1,
                           samples_per_call=1, integrator="pt_nee",
                           reuse_primary_hit=False)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
    cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                          focal_length=2.0, device=dev)
    K, C = bvh.cl_tri.shape
    P = renderer.resolve_tile_size(cfg, scene.num_tris)
    kern = packets.route(K, C, cfg.two_level_cull, cfg.super_factor).kernel
    print(f"train: scene tris={scene.num_tris} clusters={K} C={C} P={P} "
          f"route={kern} {size}x{size} spp=1 pt_nee "
          f"bounces={cfg.num_bounces} reuse_primary_hit=False")
    if kern != "resident":
        raise AssertionError(f"train took the {kern} route")
    _, k1_wrap, _ = kernels["k1"]
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, cfg, prng_key(9, dev), 1,
                                      bvh=bvh)
    key = prng_key(1234, dev)
    rays = cfg.num_pixels * cfg.spp * (cfg.num_bounces + 1)

    def step(loss_fn, log=None):
        """One SGD step (lr 1e-4, __graft_entry__.py:95) -> (loss, grads,
        forward s, step s)."""
        p = rg.targets_of(scene)
        opt = torch.optim.SGD(rg.target_leaves(p), lr=1e-4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(p, target)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        if log is not None:
            log.backward = True
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        grads = [torch.zeros_like(t) if t.grad is None else t.grad.clone()
                 for t in rg.target_leaves(p)]
        return loss.detach(), grads, t_fwd, t_step

    out = {}
    for label, n_edge in (("interior", 0), ("both_terms", edge_samples)):
        lab = f"train/{label}"
        loss_fn = rg.make_loss_fn(scene, cam, cfg, key, 1, bvh=bvh,
                                  edge_samples=n_edge,
                                  shadow_edge_samples=n_edge)
        edges = (build_edge_table(scene.host_tris, device=dev) if n_edge
                 else None)
        step(loss_fn)  # warm-up
        reset_counts(kernels)
        with TraceLog() as log:
            loss, grads, _, _ = step(loss_fn, log)
        launches = k1_wrap.launches
        plain_calls = sum(pl.calls for _, _, pl in kernels.values())
        others = sum(w.launches for n, (_, w, _) in kernels.items()
                     if n != "k1" and n not in GLUE_KERNELS)
        fwd, rec = log.split()
        same_ids = len(rec) > 0 and all(
            torch.equal(i_r, i_f) for (_, i_r), (_, i_f) in zip(rec, fwd))
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        # the sample's traces run again in the backward; the boundary
        # terms' traces run once, outside the checkpoint
        want = len(fwd) + len(rec)
        print(f"{lab}: loss={float(loss):.6f} finite={finite} "
              f"forward_trace_calls={len(fwd)} recompute_trace_calls="
              f"{len(rec)} k1_launches={launches} (forward {len(fwd)} + "
              f"recompute {len(rec)}"
              + ("" if len(rec) * 2 == want else
                 f"; the boundary terms' {len(fwd) - len(rec)} calls run "
                 "once, outside the per-sample checkpoint")
              + f") other_kernel_launches={others} plain_calls="
              f"{plain_calls} recompute_ids_equal_forward={same_ids}")
        if not finite:
            raise AssertionError(f"{lab}: the loss or a gradient is not "
                                 "finite")
        if launches != want or launches <= 0 or others or plain_calls:
            raise AssertionError(f"{lab}: K1 launched {launches} times, "
                                 f"expected {want}; {others} other "
                                 f"launches, {plain_calls} plain calls")
        if not same_ids:
            raise AssertionError(f"{lab}: the recompute's hit ids differ "
                                 "from the forward's")
        # the same inputs again: the gradients within 1e-5 of each array's
        # largest |g| (the backward's atomics reorder sums)
        _, grads2, _, _ = step(loss_fn)
        rep = grads_close(lab, grads2, grads, TRAIN_REPEAT_FRAC, "repeat")
        walls = [step(loss_fn)[2:] for _ in range(TRAIN_STEPS)]
        t_step = float(np.median([w[1] for w in walls]))
        t_fwd = float(np.median([w[0] for w in walls]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with K1Timer() as timer:
            step(loss_fn)
        k1_ms = timer.ms()
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            _, prim_s = host_ms(lambda: rg.render_image_diff(
                scene, cam, cfg, key, 1, bvh=bvh, edge_samples=n_edge,
                edge_table=edges, shadow_edge_samples=n_edge))
        print(f"{lab}: step_ms={t_step * 1e3:.3f} (median of {TRAIN_STEPS} "
              f"after a warm-up: {[round(w[1] * 1e3, 3) for w in walls]}) "
              f"forward_in_step_ms={t_fwd * 1e3:.3f} "
              f"backward_and_update_ms={(t_step - t_fwd) * 1e3:.3f} "
              f"forward_nograd_ms={prim_s:.3f} grad_mrays_per_s="
              f"{rays / t_step / 1e6:.3f} k1_launches={len(timer.pairs)} "
              f"k1_event_ms={k1_ms:.4f} peak_mib={peak / 2**20:.1f} "
              f"repeat_gap_over_max={rep:.3g} (limit {TRAIN_REPEAT_FRAC})")
        out[label] = dict(launches=launches, k1_ms=k1_ms,
                          k1_calls=len(timer.pairs), batches=fwd,
                          grads=grads, loss_fn=loss_fn)

    # ---- K1 on the step's bounce batch: its numbers for the kernels line --
    res = train_kernel_numbers("train/bounce1", kernels, scene, bvh, cfg, P,
                               out["interior"]["batches"][1][0])

    # ---- FD on the card: d loss / d albedo.x of the most-seen material ----
    first = out["interior"]["batches"][0][1]
    mats = scene.tri_mat[first[first >= 0].long()]
    m = int(torch.bincount(mats).argmax())
    g = float(out["interior"]["grads"][3][m])  # albedo.x (leaves_of)
    loss_fn = out["interior"]["loss_fn"]
    p0 = rg.targets_of(scene)
    eps = 1e-3

    def f(delta):
        ax = p0.albedo.x.detach().clone()
        ax[m] += delta
        with torch.no_grad():
            return float(loss_fn(p0._replace(
                albedo=p0.albedo._replace(x=ax)), target))

    fd = (f(eps) - f(-eps)) / (2 * eps)
    err = abs(fd - g)
    ok = err <= 2e-2 * max(abs(fd), abs(g), 1e-5) + 1e-5
    print(f"train/fd: material={m} (primary hits "
          f"{int((mats == m).sum())} of {int(first.numel())}) "
          f"d_loss_d_albedo_x ad={g:.6g} fd={fd:.6g} eps={eps} "
          f"rel_err={err / max(abs(fd), 1e-30):.3g} (rule: 2e-2 "
          "relative + 1e-5, tests/test_diff.py:57)")
    if not ok:
        raise AssertionError("train/fd: the gradient disagrees with finite "
                             "differences")

    # ---- the card against the CPU at 16^2, both terms ---------------------
    def small(device):
        sc = procedural.to_scene(procedural.cornell_box(with_boxes=False),
                                 device)
        c = cpt.RenderConfig(width=parity_size, height=parity_size, spp=2,
                             samples_per_call=2, integrator="pt_nee")
        cm = cpt.make_camera(width=parity_size, height=parity_size,
                             device=device)
        bv = renderer.build_bvh_for_scene(sc, c.leaf_size)
        with torch.no_grad():
            tg = rg.render_image_diff(sc, cm, c, prng_key(99, device), 1,
                                      bvh=bv)
        return rg.render_and_grad(sc, cm, c, prng_key(0, device), 2, tg,
                                  bvh=bv, edge_samples=256,
                                  shadow_edge_samples=256)

    reset_counts(kernels)
    loss_d, g_d = small(dev)
    if dev != "cpu" and (kernels["k1"][1].launches <= 0 or sum(
            pl.calls for _, _, pl in kernels.values())):
        raise AssertionError("train/parity: the card's run did not go "
                             "through K1 alone")
    loss_c, g_c = small("cpu")
    rel = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    mat = max(float(((a.cpu() - b).abs() / b.abs().clamp(min=1e-30)).max())
              if b.numel() else 0.0
              for a, b in zip([*g_d.albedo, *g_d.emission],
                              [*g_c.albedo, *g_c.emission]))
    geo = grads_close("train/parity", [*g_d.verts, *g_d.sph_center,
                                       g_d.sph_radius],
                      [*g_c.verts, *g_c.sph_center, g_c.sph_radius],
                      1e-3, "vertex gradient")
    print(f"train/parity: {parity_size}x{parity_size} cornell_box(open) "
          f"pt_nee spp=2 edge_samples=256 shadow_edge_samples=256 card vs "
          f"cpu: loss_rel={rel:.3g} (limit 1e-5) material_grad_rel="
          f"{mat:.3g} (limit 1e-4) vertex_gap_over_max={geo:.3g} "
          "(limit 1e-3)")
    if rel > 1e-5 or mat > 1e-4:
        raise AssertionError("train/parity: the card's loss or material "
                             "gradients differ from the CPU's")

    # ---- BDPT: render_and_grad at 128^2, 1 spp ----------------------------
    bcfg = dataclasses.replace(cfg, width=bdpt_size, height=bdpt_size,
                               integrator="bdpt")
    bcam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=bdpt_size,
                           height=bdpt_size, focal_length=2.0, device=dev)
    with torch.no_grad():
        btarget = rg.render_image_diff(scene, bcam, bcfg, prng_key(9, dev),
                                       1, bvh=bvh)
    reset_counts(kernels)
    bloss, bg = rg.render_and_grad(scene, bcam, bcfg, key, 1, btarget,
                                   bvh=bvh)
    bfinite = bool(torch.isfinite(bloss)) and all(
        bool(torch.isfinite(t).all()) for t in rg.target_leaves(bg))
    blaunch = kernels["k1"][1].launches
    print(f"train/bdpt: {bdpt_size}x{bdpt_size} spp=1 loss={float(bloss):.6f}"
          f" finite={bfinite} k1_launches={blaunch}")
    if not bfinite or (dev != "cpu" and blaunch <= 0):
        raise AssertionError("train/bdpt: not finite, or K1 did not launch")

    # the kernels line: K1's launches per interior step, its time on the
    # step's bounce batch beside that batch's plain version and bound, and
    # its CUDA-event ms summed over each step
    return res, dict(
        k1_ms_per_step=out["interior"]["k1_ms"],
        launches_both_terms=out["both_terms"]["launches"],
        k1_ms_per_step_both_terms=out["both_terms"]["k1_ms"]), \
        out["interior"]["launches"]


def run_cli(argv):
    """``cli.main(argv)`` in this process, its standard error captured and
    echoed. -> (the captured text, wall seconds to a synchronize)."""
    from cudapathtracer_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    sys.stderr.write(text)
    return text, wall


def cli_mrays(text):
    """The CLI's closing ``<x> Mrays/s`` line (kernel.cu:757)."""
    for line in text.splitlines():
        if line.endswith(" Mrays/s"):
            return float(line.split()[0])
    raise AssertionError("the CLI printed no Mrays/s line")


def cli_phase(dev, kernels, check_batch, base_key, size=CLI_SIZE,
              spp=CLI_SPP, killed=CLI_KILLED_SPP, fresh_spp=CLI_FRESH_SPP,
              original_spp=CLI_ORIGINAL_SPP, obj_subdiv=OBJ_SUBDIV,
              obj_size=OBJ_SIZE, obj_spp=OBJ_SPP):
    """Phase 13: host I/O and the CLI on the card. The live config through
    ``cli.main`` (uninterrupted, killed at ``killed`` samples with
    checkpoints, resumed), one run from a fresh process, the reference's own
    CornellBox-Original from its OBJ, colonnade subdiv ``obj_subdiv``
    written as OBJ and loaded through the native parser, and ``heatmap``.
    -> (K1's numbers on the OBJ path's bounce batch, extra keys, K1's
    launches in the uninterrupted live run, the uninterrupted run's PNG
    bytes)."""
    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch.accel import native
    from cudapathtracer_tpu_torch.models import cornell_original, procedural
    from cudapathtracer_tpu_torch.models.loader import obj_arrays
    from cudapathtracer_tpu_torch.render import renderer
    from cudapathtracer_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                           save_checkpoint)
    from cudapathtracer_tpu_torch.utils.png import read_png

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build"))
    wd = work.name
    live = ["render", "--scene", "cornell-sphere", "--integrator", "bdpt",
            "--size", str(size), "--device", str(dev)]
    cfg = cpt.RenderConfig(width=size, height=size, spp=spp)
    ck = os.path.join(wd, "ck.npz")
    pngs = [os.path.join(wd, f"{n}.png") for n in ("whole", "resumed")]

    # ---- 1. the live config: whole, killed, resumed ------------------------
    runs = {}
    for label, argv in (
            ("whole", live + ["--spp", str(spp), "-o", pngs[0]]),
            ("killed", live + ["--spp", str(killed), "--checkpoint", ck,
                               "--checkpoint-every",
                               str(CLI_CHECKPOINT_EVERY), "-o",
                               os.path.join(wd, "killed.png")]),
            ("resumed", live + ["--spp", str(spp), "--checkpoint", ck, "-o",
                                pngs[1]])):
        reset_counts(kernels)
        text, wall = run_cli(argv)
        launches, _ = path_counts(f"cli/live/{label}", kernels, "k1")
        n = load_checkpoint(ck, cfg, device=dev)[0].n \
            if label != "whole" else spp
        runs[label] = dict(wall=wall, mrays=cli_mrays(text),
                           k1=launches["k1"], n=n,
                           resumed="resumed from" in text)
        print(f"cli/live/{label}: {size}x{size} bdpt cornell-sphere "
              f"spp_after={n} wall_s={wall:.3f} cli_mrays_per_s="
              f"{runs[label]['mrays']:.3f} k1_launches={launches['k1']} "
              f"resumed_from_checkpoint={runs[label]['resumed']}")
    live_png = open(pngs[0], "rb").read()
    same = live_png == open(pngs[1], "rb").read()
    st, seed = load_checkpoint(ck, cfg, device=dev)
    img = read_png(pngs[1])
    flipped = np.array_equal(img, cpt.finalize_image(st, cfg)[:, ::-1])
    _, save_ms = host_ms(lambda: save_checkpoint(
        os.path.join(wd, "timed.npz"), st, seed, cfg))
    _, load_ms = host_ms(lambda: load_checkpoint(
        os.path.join(wd, "timed.npz"), cfg, device=dev))
    print(f"cli/live: killed_at={runs['killed']['n']} resumed_n={st.n} "
          f"pngs_byte_identical={same} png_equals_finalize_flipped={flipped} "
          f"checkpoint_save_ms={save_ms:.3f} checkpoint_load_ms="
          f"{load_ms:.3f} launches_per_sample="
          f"{runs['whole']['k1'] / spp:.2f}")
    if not (same and flipped and st.n == spp and runs["resumed"]["resumed"]
            and runs["killed"]["n"] == killed
            and not runs["killed"]["resumed"]):
        raise AssertionError("cli/live: the resumed render differs from the "
                             "whole one, or the checkpoint is wrong")

    # K1 against its plain version on the live config's primary batch
    scene = procedural.to_scene(procedural.cornell_with_sphere_mesh(), dev)
    cam = cpt.make_camera(width=size, height=size, device=dev)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
    prep = renderer.make_packet_prep(scene, bvh, cfg.intersector)
    one = dataclasses.replace(cfg, spp=1, reuse_primary_hit=True)
    trace_fn = renderer.make_trace_fn(scene, one, bvh, prep=prep)
    batch = record_batches(scene, trace_fn, cam, one, base_key)["primary"]
    live_res = check_batch("cli/live/primary", "k1", batch, scene, prep, one,
                           renderer.resolve_tile_size(one, scene.num_tris),
                           None, full_plain=True)
    del scene, bvh, prep, trace_fn, batch

    # ---- 2. one run from a fresh process -----------------------------------
    argv = live + ["--spp", str(fresh_spp), "-o",
                   os.path.join(wd, "fresh.png")]
    code = ("import sys; from cudapathtracer_tpu_torch.cli import main; "
            f"main({argv!r}); assert 'jax' not in sys.modules")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    fresh_s = time.perf_counter() - t0
    print(f"cli/fresh: exit={proc.returncode} spp={fresh_spp} "
          f"process_wall_s={fresh_s:.3f} cli_mrays_per_s="
          f"{cli_mrays(proc.stderr) if proc.returncode == 0 else 'none'}")
    if proc.returncode != 0:
        raise AssertionError(f"cli/fresh: {proc.stderr[-3000:]}")

    # ---- 3. the reference's own scene, CornellBox-Original -----------------
    obj = cornell_original.write_cornell_original(wd)
    ock = os.path.join(wd, "original.npz")
    reset_counts(kernels)
    _, wall = run_cli(["render", "--obj", obj, "--integrator", "bdpt",
                       "--size", str(size), "--spp", str(original_spp),
                       "--device", str(dev), "--checkpoint", ock, "-o",
                       os.path.join(wd, "original.png")])
    launches, _ = path_counts("cli/original", kernels, "k1")
    ost = load_checkpoint(ock, device=dev)[0]
    finite = all(bool(torch.isfinite(c).all()) for c in ost.img)
    oimg = read_png(os.path.join(wd, "original.png")).astype(np.float64)
    h, w = oimg.shape[:2]
    rows = slice(int(0.3 * h), int(0.7 * h))
    left = oimg[rows, int(0.05 * w):int(0.2 * w)].mean(axis=(0, 1))
    right = oimg[rows, int(0.8 * w):int(0.95 * w)].mean(axis=(0, 1))
    print(f"cli/original: CornellBox-Original bdpt {size}x{size} "
          f"spp={original_spp} wall_s={wall:.3f} finite={finite} "
          f"image_max={oimg.max():.0f} left_wall_rgb="
          f"{[round(float(v), 1) for v in left]} right_wall_rgb="
          f"{[round(float(v), 1) for v in right]} k1_launches="
          f"{launches['k1']}")
    if not (finite and oimg.max() > 150 and left[0] > max(left[1:])
            and right[1] > max(right[0], right[2])):
        raise AssertionError("cli/original: not finite, too dark, or the "
                             "walls' colours are wrong")

    # ---- 4. an OBJ at the scale users load ---------------------------------
    desc = procedural.colonnade(subdiv=obj_subdiv)
    po, pm = os.path.join(wd, "colonnade.obj"), os.path.join(wd, "c.mtl")
    t0 = time.perf_counter()
    procedural.write_obj(po, pm, desc)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays = obj_arrays(po)
    parse_s = time.perf_counter() - t0
    loaded, upload_ms = host_ms(lambda: cpt.make_scene(*arrays, device=dev))
    _, load_obj_ms = host_ms(lambda: cpt.load_obj(po, device=dev))
    ref = procedural.to_scene(desc, dev)
    order = np.argsort(desc["tri_mats"], kind="stable")
    geo = np.array_equal(loaded.host_verts[loaded.host_tris],
                         desc["verts"][desc["tris"][order]])
    mats = np.array_equal(loaded.tri_mat.cpu().numpy(),
                          desc["tri_mats"][order])
    o_t = torch.from_numpy(order).to(dev)
    norms = all(torch.equal(a, b[o_t]) for a, b in zip(loaded.tri_norm,
                                                        ref.tri_norm))
    lights = np.array_equal(np.sort(order[loaded.lights.cpu().numpy()]),
                            ref.lights.cpu().numpy())
    area = abs(float(loaded.total_light_area) - float(ref.total_light_area))
    area_rel = area / float(ref.total_light_area)
    print(f"cli/obj: colonnade subdiv {obj_subdiv} tris={loaded.num_tris} "
          f"write_obj_s={write_s:.3f} native_parse_s={parse_s:.3f} "
          f"upload_s={upload_ms / 1e3:.3f} "
          f"load_obj_s={load_obj_ms / 1e3:.3f} "
          f"obj_bytes={os.path.getsize(po)} equal_up_to_material_sort: "
          f"geometry={geo} materials={mats} normals={norms} lights={lights} "
          f"light_area_rel={area_rel:.3g}")
    if not (geo and mats and norms and lights and area_rel < 1e-6):
        raise AssertionError("cli/obj: the loaded scene differs from "
                             "to_scene's")

    ocfg = cpt.RenderConfig(width=obj_size, height=obj_size, spp=obj_spp,
                            samples_per_call=obj_spp, integrator="pt_nee")
    ocam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=obj_size,
                           height=obj_size, focal_length=2.0, device=dev)
    obvh = renderer.build_bvh_for_scene(loaded, ocfg.leaf_size)
    reset_counts(kernels)
    ost, owall = host_ms(lambda: cpt.render(loaded, ocam, ocfg, seed=1234,
                                            bvh=obvh, device=dev))
    olaunch, _ = path_counts("cli/obj", kernels, "k1")
    rst = cpt.render(ref, ocam, ocfg, seed=1234, device=dev)
    print(f"cli/obj: pt_nee {obj_size}x{obj_size} spp={obj_spp} "
          f"render_wall_ms={owall:.1f} (accel built before) k1_launches="
          f"{olaunch['k1']} launches_per_sample={olaunch['k1'] / obj_spp:.2f}")
    frac = image_rule("cli/obj", cpt.finalize_image(ost, ocfg),
                      cpt.finalize_image(rst, ocfg))
    print(f"cli/obj: loaded vs procedural channels_off_by_more_than_2="
          f"{frac:.4%} (limit 0.5%)")
    one = dataclasses.replace(ocfg, spp=1, samples_per_call=1,
                              reuse_primary_hit=True)
    oprep = renderer.make_packet_prep(loaded, obvh, one.intersector)
    otrace = renderer.make_trace_fn(loaded, one, obvh, prep=oprep)
    bounce = record_batches(loaded, otrace, ocam, one, base_key)["bounce1"]
    res = check_batch("cli/obj/bounce1", "k1", bounce, loaded, oprep, one,
                      renderer.resolve_tile_size(one, loaded.num_tris), None,
                      full_plain=False)
    res["max_abs"] = max(res["max_abs"], live_res["max_abs"])
    del loaded, ref, obvh, oprep, otrace, bounce, ost, rst

    # ---- 5. heatmap ---------------------------------------------------------
    csv, fc = os.path.join(wd, "out.csv"), os.path.join(wd, "fc.png")
    run_cli(["heatmap", "--scene", "cornell", "--size", str(size),
             "--device", str(dev), "-o", csv, "--falsecolor", fc])
    lines = open(csv).read().strip().splitlines()
    fimg = read_png(fc)
    print(f"cli/heatmap: csv_lines={len(lines)} all_end_in_comma="
          f"{all(x.endswith(',') for x in lines)} falsecolor_max="
          f"{int(fimg.max())}")
    if len(lines) != 36 or not all(x.endswith(",") for x in lines) \
            or fimg.max() == 0:
        raise AssertionError("cli/heatmap: the CSV or the falsecolor image "
                             "is wrong")
    work.cleanup()
    return res, dict(
        launches_per_sample_live=runs["whole"]["k1"] / spp,
        launches_per_sample_obj=olaunch["k1"] / obj_spp,
        live_wall_s=runs["whole"]["wall"],
        live_cli_mrays_per_s=runs["whole"]["mrays"],
        resumed_wall_s=runs["resumed"]["wall"],
        checkpoint_save_ms=save_ms, checkpoint_load_ms=load_ms,
        obj_parse_s=parse_s, obj_upload_s=upload_ms / 1e3,
        live_primary_ms=live_res["ms"], live_primary_plain_ms=live_res[
            "plain_ms"], live_primary_bound_ms=live_res["bound"][0]), \
        runs["whole"]["k1"], live_png


def path_setup(dev, subdiv, size, integrator, spp):
    """The paths' colonnade scene at ``size``^2 with the bench camera, the
    config (one batch of ``spp`` samples, the primary hit reused), its
    accel structure and packet prep."""
    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch.models import procedural
    from cudapathtracer_tpu_torch.render import renderer

    scene = procedural.to_scene(procedural.colonnade(subdiv=subdiv), dev)
    cfg = cpt.RenderConfig(width=size, height=size, spp=spp,
                           integrator=integrator, samples_per_call=spp,
                           reuse_primary_hit=True)
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size)
    cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                          focal_length=2.0, device=dev)
    return scene, cfg, bvh, cam, renderer.make_packet_prep(scene, bvh)


def state_bits(st):
    """An AccumState's six arrays as int32 bit patterns, on the host."""
    return [t.view(torch.int32).cpu() for t in (*st.img, *st.comp)]


class K1Lanes:
    """K1's counting instance in place of its timed instance on every
    packet-engine call while entered: -> the lane tests issued
    (``tests()``). Its launches are not a path's."""

    def __enter__(self):
        from cudapathtracer_tpu_torch.ops import packets
        from cudapathtracer_tpu_torch.ops.kernels.dense_resident import (
            COUNT_COLS)

        self._packets, self._orig = packets, packets.dense_intersect_resident
        self.counts = []

        def counted(ids, *rest, **kw):
            c = torch.empty((ids.shape[0], COUNT_COLS), dtype=torch.int64,
                            device=ids.device)
            out = self._orig(ids, *rest, counts_out=c, **kw)
            self.counts.append(c)
            return out

        packets.dense_intersect_resident = counted
        return self

    def __exit__(self, *exc):
        self._packets.dense_intersect_resident = self._orig

    def tests(self):
        return sum(int(c[:, 1].sum()) for c in self.counts)


def sharded_rank(mesh, out_dir, size, spp, train_size, edge_samples,
                 subdiv):
    """One of phase 14's two ranks, both on one card over gloo (a process
    of its own, started by ``parallel.launch.start_ranks``): its range of
    the headline (``size``^2, ``spp`` spp) timed with K1's launches
    counted, gathered; a sharded checkpoint at spp / 2 resumed to spp,
    gathered and held against the uninterrupted range; a load at another
    rank count; the train step at ``train_size``^2 (interior, then both
    boundary terms at ``edge_samples`` each) through
    ``make_sharded_grad_fn`` and one SGD step of ``make_train_step`` at the
    rate SGD_STEP_FRAC sets. -> the numbers the parent holds; anything
    wrong raises, which fails the phase."""
    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch.diff import render_grad as rg
    from cudapathtracer_tpu_torch.ops.kernels import dense as k2
    from cudapathtracer_tpu_torch.ops.kernels import dense_resident as k1
    from cudapathtracer_tpu_torch.ops.kernels import dense_super as k3
    from cudapathtracer_tpu_torch.ops.rng import prng_key
    from cudapathtracer_tpu_torch.parallel import mesh as pmesh
    from cudapathtracer_tpu_torch.parallel import shard
    from cudapathtracer_tpu_torch.utils import checkpoint as ck

    dev, rank = mesh.device, mesh.rank
    kernels = {"k1": (None, k1.dense_intersect_resident,
                      k1.dense_intersect_resident_plain),
               "k2": (None, k2.dense_intersect, k2.dense_intersect_plain),
               "k3": (None, k3.dense_intersect_super,
                      k3.dense_intersect_super_plain)}
    sync = (torch.cuda.synchronize if dev.type == "cuda" else
            (lambda: None))
    out = {}
    scene, cfg, bvh, cam, prep = path_setup(dev, subdiv, size, "pt_nee", spp)
    key = prng_key(1234, dev)
    start, stop = pmesh.tile_range(cfg.num_pixels, mesh)

    def window(n, state=None):
        if state is None:
            state = cpt.init_accum(cfg, device=dev, num_pixels=stop - start)
        return shard.render_sharded(scene, bvh, cam, cfg, key, state, n,
                                    mesh, prep=prep)

    window(spp)
    sync()
    reset_counts(kernels)
    t0 = time.perf_counter()
    tile = window(spp)
    sync()
    out["window_s"] = time.perf_counter() - t0
    launches, _ = path_counts(f"sharded/gloo/rank{rank}", kernels, "k1")
    out["k1_launches"] = launches["k1"]
    whole = pmesh.gather_pixels(mesh, tile)
    if rank == 0:
        out["image_bits"] = np.stack([b.numpy() for b in state_bits(whole)])

    path = os.path.join(out_dir, "ck.npz")
    part = window(spp // 2)
    ck.save_checkpoint_sharded(path, part, 1234, cfg, mesh)
    loaded, seed = ck.load_checkpoint_sharded(path, mesh, cfg)
    resumed = window(spp - spp // 2, loaded)
    out["resume_equal"] = seed == 1234 and resumed.n == spp and all(
        torch.equal(a, b) for a, b in zip(state_bits(resumed),
                                          state_bits(tile)))
    if rank == 0:
        try:
            ck.load_checkpoint_sharded(path, pmesh.TileMesh(0, 1, dev), cfg)
            out["other_world_raised"] = False
        except FileNotFoundError:
            out["other_world_raised"] = True
    del scene, bvh, prep, tile, whole, part, loaded, resumed

    scene, tcfg, bvh, cam, _ = path_setup(dev, subdiv, train_size, "pt_nee",
                                          1)
    tcfg = dataclasses.replace(tcfg, reuse_primary_hit=False)
    with torch.no_grad():
        target = rg.render_image_diff(scene, cam, tcfg, prng_key(9, dev), 1,
                                      bvh=bvh)
    idx = torch.arange(*pmesh.tile_range(tcfg.num_pixels, mesh),
                       device=dev)
    tile_target = type(target)(*(c[idx] for c in target))
    for label, n_edge in (("interior", 0), ("both_terms", edge_samples)):
        fn = shard.make_sharded_grad_fn(scene, cam, tcfg, mesh, 1, bvh=bvh,
                                        edge_samples=n_edge,
                                        shadow_edge_samples=n_edge)
        fn(rg.targets_of(scene), tile_target, idx, key)  # warm-up
        sync()
        t0 = time.perf_counter()
        loss, g = fn(rg.targets_of(scene), tile_target, idx, key)
        sync()
        out[f"{label}_step_s"] = time.perf_counter() - t0
        out[f"{label}_loss"] = float(loss)
        out[f"{label}_grads"] = np.concatenate(
            [t.cpu().numpy().reshape(-1) for t in rg.target_leaves(g)])
        if label == "interior":
            pairs = [(float(p.detach().abs().max()), float(d.abs().max()))
                     for p, d in zip(rg.target_leaves(rg.targets_of(scene)),
                                     rg.target_leaves(g)) if d.numel()]
            lr = SGD_STEP_FRAC * max(p / d for p, d in pairs if d > 0)
    step = shard.make_train_step(scene, cam, tcfg, mesh, 1, bvh=bvh,
                                 learning_rate=lr)
    _, params, _ = step(rg.targets_of(scene), None, target, key)
    out["sgd_lr"] = lr
    out["sgd_params"] = np.concatenate(
        [t.cpu().numpy().reshape(-1) for t in rg.target_leaves(params)])
    return out


def split_balance(label, dev, scene, cfg, bvh, cam, prep, base_key, worlds):
    """Phase 14 (d): each rank's range of one sample rendered alone, for
    each world in ``worlds``: K1's lane tests (its counting instance) and
    the range's CUDA-event ms, and their worst over mean per world.
    -> {world: (tests worst/mean, ms worst/mean)}."""
    from cudapathtracer_tpu_torch import init_accum
    from cudapathtracer_tpu_torch.parallel.mesh import TileMesh, tile_range
    from cudapathtracer_tpu_torch.parallel.shard import render_sharded

    out = {}
    for world in worlds:
        tests, ms = [], []
        for r in range(world):
            mesh = TileMesh(r, world, dev)
            start, stop = tile_range(cfg.num_pixels, mesh)

            def one():
                return render_sharded(scene, bvh, cam, cfg, base_key,
                                      init_accum(cfg, device=dev,
                                                 num_pixels=stop - start),
                                      1, mesh, prep=prep)

            with K1Lanes() as lanes:
                one()
            tests.append(lanes.tests())
            ms.append(cuda_ms(one, 1))
        t_ratio = max(tests) / (sum(tests) / world)
        m_ratio = max(ms) / (sum(ms) / world)
        out[world] = (t_ratio, m_ratio)
        print(f"split[{label}]: world={world} {cfg.width}x{cfg.height} "
              f"{cfg.integrator} 1 spp lane_tests_per_rank={tests} "
              f"ms_per_rank={[round(m, 3) for m in ms]} "
              f"tests_worst_over_mean={t_ratio:.4f} "
              f"ms_worst_over_mean={m_ratio:.4f}")
    return out


def sharded_phase(dev, kernels, check_batch, base_key, live_png,
                  size=HEADLINE_SIZE, spp=HEADLINE_SPP, bdpt_size=BDPT_SIZE,
                  bdpt_spp=BDPT_SPP, train_size=TRAIN_SIZE,
                  edge_samples=TRAIN_EDGE_SAMPLES, cli_size=CLI_SIZE,
                  cli_spp=CLI_SPP, killed=CLI_KILLED_SPP,
                  worlds=SPLIT_WORLDS, subdiv=3):
    """Phase 14: the tile-sharded render, train step, checkpoints and CLI
    (parallel/). (a) world 1 over NCCL in this process, sharded windows
    against render_batch windows in turns, then BDPT; (b) two ranks on
    this card over gloo (``sharded_rank``) against this process's
    one-process references; (c) ``cli.main(["render", "--sharded", ...])``
    killed and resumed, its PNG against phase 13's ``live_png`` bytes; (d)
    the contiguous split's balance. -> (K1's numbers on a rank's bounce
    batch, extra keys, K1's launches in (a)'s sharded windows)."""
    import torch.distributed as dist

    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch.diff import render_grad as rg
    from cudapathtracer_tpu_torch.ops.rng import prng_key
    from cudapathtracer_tpu_torch.parallel import mesh as pmesh
    from cudapathtracer_tpu_torch.parallel.launch import start_ranks
    from cudapathtracer_tpu_torch.parallel import shard
    from cudapathtracer_tpu_torch.render import renderer

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    work = tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build"))
    extra = {}

    # ---- (a) world 1, NCCL: sharded against unsharded, in turns -----------
    mesh = pmesh.initialize_distributed(device=dev)
    backend = dist.get_backend()
    print(f"sharded/world1: backend={backend} rank={mesh.rank} "
          f"world={mesh.world} device={mesh.device}")
    scene, cfg, bvh, cam, prep = path_setup(dev, subdiv, size, "pt_nee",
                                            spp)
    R = cfg.num_pixels

    def unsharded(c=cfg, n=spp):
        return cpt.render_batch(scene, bvh, cam, c, base_key,
                                cpt.init_accum(c, device=dev), n, prep=prep)

    def sharded(c=cfg, n=spp):
        return shard.render_sharded(scene, bvh, cam, c, base_key,
                                    cpt.init_accum(c, device=dev), n, mesh,
                                    prep=prep)

    imgs, walls, k1_by = {}, {"unsharded": [], "sharded": []}, {
        "unsharded": 0, "sharded": 0}
    for name in ("unsharded", "sharded"):  # warm-up
        (unsharded if name == "unsharded" else sharded)()
    sync()
    for name in ("unsharded", "sharded", "sharded", "unsharded"):
        reset_counts(kernels)
        t0 = time.perf_counter()
        st = (unsharded if name == "unsharded" else sharded)()
        sync()
        walls[name].append(time.perf_counter() - t0)
        launches, _ = path_counts(f"sharded/world1/{name}", kernels, "k1")
        k1_by[name] += launches["k1"]
        bits = state_bits(st)
        if name in imgs and not all(torch.equal(a, b)
                                    for a, b in zip(bits, imgs[name])):
            raise AssertionError(f"sharded/world1: two {name} windows "
                                 "differ")
        imgs[name] = bits
        if name == "sharded":
            gathered = state_bits(pmesh.gather_pixels(mesh, st))
    same = all(torch.equal(a, b) for a, b in zip(imgs["sharded"],
                                                 imgs["unsharded"]))
    same_gather = all(torch.equal(a, b) for a, b in zip(gathered,
                                                        imgs["unsharded"]))
    rays = R * spp * (cfg.num_bounces + 1)
    mrays = {n: rays * len(w) / sum(w) / 1e6 for n, w in walls.items()}
    print(f"sharded/world1: headline {size}x{size} pt_nee spp={spp} "
          f"windows_in_turns=unsharded,sharded,sharded,unsharded "
          f"unsharded_s={[round(w, 4) for w in walls['unsharded']]} "
          f"sharded_s={[round(w, 4) for w in walls['sharded']]} "
          f"unsharded_mrays_per_s={mrays['unsharded']:.3f} "
          f"sharded_mrays_per_s={mrays['sharded']:.3f} "
          f"k1_launches_unsharded={k1_by['unsharded']} "
          f"k1_launches_sharded={k1_by['sharded']} "
          f"bit_identical={same} gathered_bit_identical={same_gather}")
    if not (same and same_gather):
        raise AssertionError("sharded/world1: the sharded image differs")
    headline_bits = imgs["unsharded"]
    extra.update(world1_backend=backend,
                 world1_sharded_mrays_per_s=mrays["sharded"],
                 world1_unsharded_mrays_per_s=mrays["unsharded"])
    launches_a = k1_by["sharded"]

    bscene, bcfg, bbvh, bcam, bprep = path_setup(dev, subdiv, bdpt_size,
                                                 "bdpt", bdpt_spp)
    bimgs, bwalls = {}, {}
    for name in ("unsharded", "sharded"):
        st0 = cpt.init_accum(bcfg, device=dev)
        run = (lambda: cpt.render_batch(bscene, bbvh, bcam, bcfg, base_key,
                                        st0, bdpt_spp, prep=bprep)) \
            if name == "unsharded" else \
            (lambda: shard.render_sharded(bscene, bbvh, bcam, bcfg,
                                          base_key, st0, bdpt_spp, mesh,
                                          prep=bprep))
        reset_counts(kernels)
        t0 = time.perf_counter()
        st = run()
        sync()
        bwalls[name] = time.perf_counter() - t0
        path_counts(f"sharded/world1/bdpt/{name}", kernels, "k1")
        bimgs[name] = state_bits(st)
    bsame = all(torch.equal(a, b) for a, b in zip(bimgs["sharded"],
                                                  bimgs["unsharded"]))
    print(f"sharded/world1: bdpt {bdpt_size}x{bdpt_size} spp={bdpt_spp} "
          f"unsharded_s={bwalls['unsharded']:.4f} "
          f"sharded_s={bwalls['sharded']:.4f} bit_identical={bsame}")
    if not bsame:
        raise AssertionError("sharded/world1: the BDPT images differ")
    dist.destroy_process_group()
    del bscene, bbvh, bprep, bimgs

    # ---- (b) two ranks on this card over gloo -------------------------------
    # a rank that fails, or ranks that outlast RANK_TIMEOUT_S, make
    # wait() kill every rank and raise
    wait = start_ranks(os.path.abspath(__file__), "sharded_rank", 2,
                       work.name, device=str(dev), backend="gloo",
                       args=[size, spp, train_size, edge_samples, subdiv],
                       timeout=RANK_TIMEOUT_S)
    # the one-process references while the ranks run
    tscene, tcfg, tbvh, tcam, _ = path_setup(dev, subdiv, train_size,
                                             "pt_nee", 1)
    tcfg = dataclasses.replace(tcfg, reuse_primary_hit=False)
    with torch.no_grad():
        target = rg.render_image_diff(tscene, tcam, tcfg, prng_key(9, dev),
                                      1, bvh=tbvh)
    refs = {}
    for label, n_edge in (("interior", 0), ("both_terms", edge_samples)):
        loss, g = rg.render_and_grad(tscene, tcam, tcfg, base_key, 1,
                                     target, bvh=tbvh, edge_samples=n_edge,
                                     shadow_edge_samples=n_edge)
        refs[label] = (float(loss), rg.target_leaves(g))
    p0 = rg.target_leaves(rg.targets_of(tscene))
    t0 = time.perf_counter()
    ranks = wait()
    ranks_s = time.perf_counter() - t0
    gloo_same = all(torch.equal(torch.from_numpy(a), b) for a, b in zip(
        ranks[0]["image_bits"], headline_bits))
    print(f"sharded/gloo: 2 ranks on {dev} join_s={ranks_s:.1f} headline "
          f"{size}x{size} spp={spp} window_s="
          f"{[round(float(x['window_s']), 4) for x in ranks]} "
          f"k1_launches={[int(x['k1_launches']) for x in ranks]} "
          f"gathered_equals_world1_unsharded={gloo_same} "
          f"checkpoint_resume_equal="
          f"{[bool(x['resume_equal']) for x in ranks]} "
          f"load_at_world1_raised={bool(ranks[0]['other_world_raised'])}")
    if not (gloo_same and all(bool(x["resume_equal"]) for x in ranks)
            and bool(ranks[0]["other_world_raised"])):
        raise AssertionError("sharded/gloo: the gathered image, the resumed "
                             "checkpoint or the load at world 1 is wrong")
    sizes = [t.numel() for t in p0]
    for label, (loss, want) in refs.items():
        gaps = []
        for x in ranks:
            got = torch.from_numpy(x[f"{label}_grads"]).split(sizes)
            rel = abs(float(x[f"{label}_loss"]) - loss) / abs(loss)
            gap = grads_close(f"sharded/gloo/{label}", got,
                              [w.cpu() for w in want], TRAIN_REPEAT_FRAC,
                              "all-reduced gradient")
            if rel > 1e-5:
                raise AssertionError(f"sharded/gloo/{label}: loss {rel} "
                                     "relative off the one-process loss")
            gaps.append((rel, gap))
        n_edge = 0 if label == "interior" else edge_samples
        steps = [round(float(x[f"{label}_step_s"]), 4) for x in ranks]
        print(f"sharded/gloo/{label}: {train_size}x{train_size} pt_nee "
              f"1 spp edge_samples={n_edge} step_s={steps} "
              f"loss={[float(x[label + '_loss']) for x in ranks]} "
              f"one_process_loss={loss} loss_rel={[g[0] for g in gaps]} "
              f"(limit 1e-5) grad_gap_over_max={[g[1] for g in gaps]} "
              f"(limit {TRAIN_REPEAT_FRAC})")
        extra[f"gloo_{label}_step_s"] = [float(x[f"{label}_step_s"])
                                         for x in ranks]
    # the update itself against lr times the one-process gradient, on the
    # scale of lr times each array's largest |g|: a step left undone shows
    # a gap of 1
    before = [p.detach().double().cpu() for p in p0]
    upd_gap = max(grads_close("sharded/gloo/sgd", [
        a.double() - b for a, b in zip(torch.from_numpy(
            x["sgd_params"]).split(sizes), before)], [
        -float(x["sgd_lr"]) * g.double().cpu() for g in refs["interior"][1]],
        TRAIN_REPEAT_FRAC, "update") for x in ranks)
    print(f"sharded/gloo/sgd: lr={[float(x['sgd_lr']) for x in ranks]} "
          f"(every array moved by >= {SGD_STEP_FRAC} of its largest |p|) "
          f"update after one step against lr x the one-process gradient: "
          f"gap_over_lr_max_g={upd_gap:.3g} (limit {TRAIN_REPEAT_FRAC})")
    extra.update(gloo_window_s=[float(x["window_s"]) for x in ranks],
                 gloo_mrays_per_s=rays / max(float(x["window_s"])
                                             for x in ranks) / 1e6,
                 launches_per_rank_per_sample=[
                     int(x["k1_launches"]) / spp for x in ranks])
    del tscene, tbvh, target, refs

    # ---- (c) the CLI, --sharded, killed and resumed ------------------------
    live = ["render", "--scene", "cornell-sphere", "--integrator", "bdpt",
            "--size", str(cli_size), "--device", str(dev), "--sharded"]
    ck_path = os.path.join(work.name, "cli.npz")
    png = os.path.join(work.name, "cli.png")
    cli = {}
    for label, argv in (
            ("killed", live + ["--spp", str(killed), "--checkpoint", ck_path,
                               "--checkpoint-every",
                               str(CLI_CHECKPOINT_EVERY), "-o",
                               os.path.join(work.name, "killed.png")]),
            ("resumed", live + ["--spp", str(cli_spp), "--checkpoint",
                                ck_path, "-o", png])):
        reset_counts(kernels)
        text, wall = run_cli(argv)
        launches, _ = path_counts(f"sharded/cli/{label}", kernels, "k1")
        cli[label] = (wall, cli_mrays(text), launches["k1"],
                      "mesh: 1 devices" in text)
        print(f"sharded/cli/{label}: wall_s={wall:.3f} cli_mrays_per_s="
              f"{cli[label][1]:.3f} k1_launches={launches['k1']} "
              f"mesh_line={cli[label][3]}")
    cli_same = open(png, "rb").read() == live_png
    print(f"sharded/cli: resumed png byte-identical to phase 13's "
          f"unsharded png: {cli_same}")
    if not (cli_same and cli["killed"][3] and cli["resumed"][3]):
        raise AssertionError("sharded/cli: the PNG differs from phase 13's")
    extra.update(cli_resumed_wall_s=cli["resumed"][0],
                 cli_resumed_mrays_per_s=cli["resumed"][1])

    # ---- (d) the contiguous split's balance -------------------------------
    balance = {"pt_nee": split_balance("pt_nee", dev, scene, cfg, bvh, cam,
                                       prep, base_key, worlds)}
    bscene, bcfg, bbvh, bcam, bprep = path_setup(dev, subdiv, bdpt_size,
                                                 "bdpt", 1)
    balance["bdpt"] = split_balance("bdpt", dev, bscene, bcfg, bbvh, bcam,
                                    bprep, base_key, worlds)
    extra["split_worst_over_mean"] = {
        k: {str(w): {"lane_tests": t, "ms": m} for w, (t, m) in v.items()}
        for k, v in balance.items()}

    # K1 on rank 0 of 2's bounce batch of the headline
    half = torch.arange(*pmesh.tile_range(R, pmesh.TileMesh(0, 2, dev)),
                        device=dev)
    one = dataclasses.replace(cfg, spp=1, samples_per_call=1)
    trace_fn = renderer.make_trace_fn(scene, one, bvh, prep=prep)
    batch = record_batches(scene, trace_fn, cam, one, base_key,
                           idx=half)["bounce1"]
    res = check_batch("sharded/rank0of2/bounce1", "k1", batch, scene, prep,
                      one, renderer.resolve_tile_size(one, scene.num_tris),
                      None, full_plain=False)
    work.cleanup()
    return res, extra, launches_a


def windows_in_turns(label, kernels, expect, runs, rays, windows):
    """Render windows of several configurations of one path in turns (the
    order reversed every other round) after a warm-up of each, every count
    at 0 before each window and read after it: ``expect`` and the FMA
    alone must launch, each configuration's windows must repeat bit for bit
    and every configuration must render the first one's image bit for bit,
    finite and lit. ``runs``: {name: () -> AccumState}; ``rays``: rays a
    window. -> {name: {"launches", "fma_launches", "mrays", "peak_mib"}}."""
    names = list(runs)
    bits = {}
    for n in names:
        bits[n] = state_bits(runs[n]())
    torch.cuda.synchronize()
    walls = {n: [] for n in names}
    launches = dict.fromkeys(names, 0)
    fma = dict.fromkeys(names, 0)
    peak = dict.fromkeys(names, 0)
    for i in range(windows):
        for n in (names if i % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            reset_counts(kernels)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            st = runs[n]()
            torch.cuda.synchronize()
            walls[n].append(time.perf_counter() - t0)
            counts = path_counts(f"{label}/{n}", kernels, expect)[0]
            launches[n] += counts[expect]
            fma[n] += counts.get("fma", 0)
            peak[n] = max(peak[n], torch.cuda.max_memory_allocated())
            if not all(torch.equal(a, b)
                       for a, b in zip(state_bits(st), bits[n])):
                raise AssertionError(f"{label}/{n}: windows of one seed "
                                     "differ")
    same = {n: all(torch.equal(a, b) for a, b in zip(bits[n],
                                                     bits[names[0]]))
            for n in names}
    img = torch.stack(bits[names[0]][:3], dim=1).view(torch.float32)
    finite = bool(torch.isfinite(img).all())
    out = {}
    for n in names:
        ws = walls[n]
        out[n] = dict(launches=launches[n], fma_launches=fma[n],
                      peak_mib=peak[n] / 2**20,
                      mrays=rays * windows / sum(ws) / 1e6)
        print(f"{label}: {n} windows={windows} window_seconds="
              f"{[round(w, 4) for w in ws]} mrays_per_s={out[n]['mrays']:.3f}"
              f" window_mrays_per_s_min={rays / max(ws) / 1e6:.3f} "
              f"max={rays / min(ws) / 1e6:.3f} {expect}_launches="
              f"{launches[n]} fma_launches={fma[n]} "
              f"peak_mib={out[n]['peak_mib']:.1f} "
              f"bit_identical_to_{names[0]}={same[n]}")
    print(f"{label}: images_bit_identical={all(same.values())} "
          f"finite={finite} image_max={float(img.max()):.4f} (windows in "
          f"turns: {', '.join(names)}, then reversed)")
    if not (all(same.values()) and finite and float(img.max()) > 0):
        raise AssertionError(f"{label}: images differ, or are not finite "
                             "and lit")
    return out


def twolevel_phase(dev, kernels, check_batch, base_key, size=HEADLINE_SIZE,
                   subdiv=TWOLEVEL_SUBDIV, cluster_size=TWOLEVEL_C,
                   spp=TWOLEVEL_SPP, windows=TWOLEVEL_WINDOWS,
                   bdpt_size=BDPT_SIZE, bdpt_spp=BDPT_SPP,
                   headline_subdiv=3, headline_spp=HEADLINE_SPP,
                   knob_windows=KNOB_WINDOWS, sort_window=KNOB_SORT_WINDOW):
    """Phase 15: (a) the auto capped two-level cull with K2 on colonnade
    subdiv ``subdiv`` at ``cluster_size`` (K past 2048, the pack past the
    resident budget); (b) BDPT at ``sample_batch`` 2 beside 1; (c) the
    headline at ``sample_batch`` 2, straggler rounds and a sort window
    beside the default. -> (K2's numbers on the two-level bounce batch,
    the extra keys of its JSON entry, K2's launches in the two-level
    windows)."""
    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch.models import procedural
    from cudapathtracer_tpu_torch.ops import packets, traversal
    from cudapathtracer_tpu_torch.ops.kernels.dense_resident import (
        resident_fits)
    from cudapathtracer_tpu_torch.render import renderer

    def camera(w):
        return cpt.make_camera(pos=(0.0, 2.0, 3.4), width=w, height=w,
                               focal_length=2.0, device=dev)

    # ---- (a) the capped two-level cull, K2 ---------------------------------
    scene = procedural.to_scene(procedural.colonnade(subdiv=subdiv), dev)
    cfg = cpt.RenderConfig(width=size, height=size, spp=spp,
                           integrator="pt_nee", samples_per_call=spp,
                           reuse_primary_hit=True, cluster_size=cluster_size)
    t0 = time.perf_counter()
    bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size,
                                       cluster_size=cluster_size)
    accel_s = time.perf_counter() - t0
    cam = camera(size)
    P = renderer.resolve_tile_size(cfg, scene.num_tris)
    K, C = bvh.cl_tri.shape
    F = cfg.super_factor
    Ms = min(cfg.super_slots, -(-K // F))
    M = min(cfg.max_clusters, Ms * F)
    rt = packets.route(K, C, cfg.two_level_cull, F)
    prep = renderer.make_packet_prep(scene, bvh)
    pack_mb = sum(a.numel() * a.element_size()
                  for a in prep.resident_pack) / 1e6
    print(f"twolevel: scene tris={scene.num_tris} clusters={K} C={C} P={P} "
          f"route={rt.cull}+{rt.kernel} super_factor={F} "
          f"super_slots={cfg.super_slots} Ms={Ms} M={M} pack_mb={pack_mb:.1f}"
          f" resident_fits={resident_fits(K, C)} accel_s={accel_s:.2f}")
    if tuple(rt) != ("two_level", "stream"):
        raise AssertionError(f"twolevel took {rt}, not the two-level cull "
                             "with K2")
    trace_fn = renderer.make_trace_fn(scene, cfg, bvh, prep=prep)
    fb_rays, fb_steps, fb_ms = trace_breakdown(
        "twolevel", scene, trace_fn, cam, cfg, base_key)
    batches = record_batches(scene, trace_fn, cam, cfg, base_key)
    res = {}
    for bname, batch in batches.items():
        res[bname] = check_batch(f"twolevel/{bname}", "k2", batch, scene,
                                 prep, cfg, P, None, False, two_level=True)
    td = traversal.make_trace_data(scene, bvh.fine)
    trace_ms = {}
    for bname, (o, d, mask, cap) in batches.items():
        kw = dict(fine_td=td, mask=mask, tile_size=P,
                  max_clusters=cfg.max_clusters, sort=True,
                  resident_pack=prep.resident_pack, t_cap=cap)
        hits, ms, peak = {}, {}, {}
        for cull, tl in (("two_level", None), ("flat", False)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            hits[cull], ms[cull] = host_ms(lambda: packets.trace_packets(
                o, d, prep.pdata, two_level=tl, **kw))
            peak[cull] = torch.cuda.max_memory_allocated() / 2**20
        a, b = hits["two_level"], hits["flat"]
        same = (torch.equal(a.tri, b.tri)
                and torch.equal(a.t.view(torch.int32), b.t.view(torch.int32)))
        trace_ms[bname] = ms
        print(f"twolevel/{bname}: rays={mask.shape[0]} live={int(mask.sum())}"
              f" hits_bit_identical_to_flat_cull={same} differing_ids="
              f"{int((a.tri != b.tri).sum())} two_level_trace_ms="
              f"{ms['two_level']:.3f} flat_trace_ms={ms['flat']:.3f} "
              f"(one synchronized call each, K = {K}) peak_mib two_level="
              f"{peak['two_level']:.1f} flat={peak['flat']:.1f}")
        if not same:
            raise AssertionError(f"twolevel/{bname}: the two-level cull's "
                                 "hits differ from the flat cull's")

    def window(c, s=None, sc=scene, bv=bvh, cm=cam, pp=prep):
        return lambda: cpt.render_batch(sc, bv, cm, c, base_key,
                                        cpt.init_accum(c, device=dev),
                                        s or c.spp, prep=pp)

    rays = cfg.num_pixels * spp * (cfg.num_bounces + 1)
    culls = windows_in_turns(
        "twolevel", kernels, "k2",
        {"two_level": window(cfg),
         "flat": window(dataclasses.replace(cfg, two_level_cull=False))},
        rays, windows)
    del batches, prep, trace_fn, td, bvh, scene
    torch.cuda.empty_cache()

    # ---- (b) BDPT at sample_batch 2 beside 1, K1 ---------------------------
    bscene = procedural.to_scene(procedural.colonnade(subdiv=3), dev)
    bcfg = cpt.RenderConfig(width=bdpt_size, height=bdpt_size, spp=bdpt_spp,
                            samples_per_call=bdpt_spp, reuse_primary_hit=True)
    bbvh = renderer.build_bvh_for_scene(bscene, bcfg.leaf_size)
    bprep = renderer.make_packet_prep(bscene, bbvh)
    bcam = camera(bdpt_size)
    brays = bcfg.num_pixels * bdpt_spp * (bcfg.num_bounces + 1)
    bwin = windows_in_turns(
        "sample_batch/bdpt", kernels, "k1",
        {"s1": window(bcfg, sc=bscene, bv=bbvh, cm=bcam, pp=bprep),
         "s2": window(dataclasses.replace(bcfg, sample_batch=2), sc=bscene,
                      bv=bbvh, cm=bcam, pp=bprep)},
        brays, knob_windows)
    # K1 on the joint subpath batch of two samples (4R rays)
    btrace = renderer.make_trace_fn(bscene, bcfg, bbvh, prep=bprep)
    bb = record_batches(bscene, btrace, bcam, bcfg, base_key, S=2)
    if bb["subpath"][0].x.shape[0] != 4 * bcfg.num_pixels:
        raise AssertionError("sample_batch/bdpt: the joint subpath batch of "
                             "two samples is not 4R rays")
    k1_res = check_batch("sample_batch/bdpt/subpath", "k1", bb["subpath"],
                         bscene, bprep, bcfg, renderer.resolve_tile_size(
                             bcfg, bscene.num_tris), None, False)
    del bb, btrace, bprep, bbvh, bscene
    torch.cuda.empty_cache()

    # ---- (c) the headline: sample_batch 2, rounds and a window -------------
    hscene = procedural.to_scene(
        procedural.colonnade(subdiv=headline_subdiv), dev)
    hcfg = cpt.RenderConfig(width=size, height=size, spp=headline_spp,
                            integrator="pt_nee", samples_per_call=headline_spp,
                            reuse_primary_hit=True)
    hbvh = renderer.build_bvh_for_scene(hscene, hcfg.leaf_size)
    hprep = renderer.make_packet_prep(hscene, hbvh)
    hrays = hcfg.num_pixels * headline_spp * (hcfg.num_bounces + 1)
    knobs = {"default": {}, "sample_batch2": dict(sample_batch=2),
             "rounds2": dict(packet_rounds=2, packet_first_round=2),
             f"window{sort_window}": dict(sort_window=sort_window)}
    hwin = windows_in_turns(
        "knobs/headline", kernels, "k1",
        {n: window(dataclasses.replace(hcfg, **kw), sc=hscene, bv=hbvh,
                   cm=camera(size), pp=hprep) for n, kw in knobs.items()},
        hrays, knob_windows)
    del hprep, hbvh, hscene
    torch.cuda.empty_cache()

    per = {"twolevel": (culls, windows * spp),
           "bdpt": (bwin, knob_windows * bdpt_spp),
           "headline": (hwin, knob_windows * headline_spp)}
    for label, (runs, samples) in per.items():
        print(f"launches_per_sample[{label}]: " + " ".join(
            f"{n}={r['launches'] / samples:.2f}" for n, r in runs.items()))
    extra = {"route": f"{rt.cull}+{rt.kernel}", "clusters": K, "Ms": Ms,
             "M": M, "P": P, "pack_mb": pack_mb,
             "launches_per_sample": culls["two_level"]["launches"]
             / (windows * spp),
             "flat_cull_k2_launches": culls["flat"]["launches"],
             "fallback_rays_per_sample": fb_rays,
             "fallback_walk_steps_per_sample": fb_steps,
             "fallback_walk_ms_per_sample": fb_ms,
             "trace_ms_two_level_vs_flat": trace_ms,
             "primary_ms": res["primary"]["ms"],
             "mrays": {n: r["mrays"] for n, r in culls.items()},
             "bdpt_sample_batch": {
                 n: dict(mrays=r["mrays"], k1_launches_per_sample=r[
                     "launches"] / (knob_windows * bdpt_spp),
                     peak_mib=r["peak_mib"]) for n, r in bwin.items()},
             "bdpt_s2_subpath_k1_ms": k1_res["ms"],
             "bdpt_s2_subpath_k1_bound_ms": k1_res["bound"][0],
             "headline_knobs": {
                 n: dict(mrays=r["mrays"], k1_launches_per_sample=r[
                     "launches"] / (knob_windows * headline_spp),
                     peak_mib=r["peak_mib"]) for n, r in hwin.items()}}
    out = dict(res["bounce1"])
    out["max_abs"] = max(r["max_abs"] for r in res.values())
    return out, extra, culls["two_level"]["launches"]


def quirk_label(integrator, flags):
    return integrator + "".join(f"/{k}={v}" for k, v in flags.items())


def quirk_render(dev, integrator, flags, size=QUIRK_SIZE, spp=QUIRK_SPP,
                 seed=QUIRK_SEED):
    """One quirk case: ``cpt.render`` (through ``render_batch``) of
    cornell_with_sphere_mesh(subdiv=2) with ``flags`` set. -> (state, its
    finalized (H, W, 3) u8 image)."""
    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch.models import procedural

    scene = procedural.to_scene(procedural.cornell_with_sphere_mesh(subdiv=2),
                                dev)
    cfg = cpt.RenderConfig(width=size, height=size, spp=spp,
                           integrator=integrator, samples_per_call=spp,
                           **flags)
    st = cpt.render(scene, cpt.make_camera(width=size, height=size,
                                           device=dev), cfg, seed=seed,
                    device=dev)
    return st, cpt.finalize_image(st, cfg)


def quirk_cpu_render(integrator, flags, size, spp):
    """``quirk_render`` on the CPU with one torch thread, in a worker
    process of phase 16. -> (accumulators (3, R), u8 image)."""
    torch.set_num_threads(1)
    st, img = quirk_render("cpu", integrator, flags, size, spp)
    return np.stack([c.numpy() for c in st.img]), img


def worst_rel(got, want):
    """Largest |got - want| / |want| over the values with want != 0, and
    the count of values past rtol 3e-6 (the per-pixel tests' rtol)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap = np.abs(got - want)
    nz = want != 0
    rel = float((gap[nz] / np.abs(want[nz])).max()) if nz.any() else 0.0
    return rel, int((gap > 1e-7 + 3e-6 * np.abs(want)).sum())


def entry_phase(dev, kernels, check_batch, runs=ENTRY_RUNS,
                quirk_size=QUIRK_SIZE, quirk_spp=QUIRK_SPP,
                workers=QUIRK_WORKERS):
    """Phase 16: the graft entry points of the port
    (``cudapathtracer_tpu_torch/entry.py``) and the quirk flags. (a)
    ``entry()`` on the card: one warm run, ``runs`` timed by CUDA events
    (median ms, Mrays/s), K1 alone; the image against ``entry("cpu")``'s
    under ``image_rule``; K1 against its plain version on the entry's
    primary and bounce batches. (b) The dry run: one rank over NCCL, two
    gloo ranks sharing this card and two on the CPU; finite losses within
    DRYRUN_RTOL of each other, K1 launched on every card rank and nothing
    else. (c) Each QUIRK_CASES render on the card against the same case on
    the CPU (worker processes, started after (a)'s timing) under
    ``image_rule``; a flag must change the CPU image, and the card's in
    the same pixels; K1 alone. -> (K1's numbers on the entry's bounce
    batch, extra keys, K1's launches in the timed entry runs)."""
    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch import entry as E
    from cudapathtracer_tpu_torch.ops import packets
    from cudapathtracer_tpu_torch.render import renderer

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    extra = {}

    # ---- (a) entry(): the forward step, K1 ---------------------------------
    fn, args = E.entry(device=dev)
    scene, bvh, cam, base_key, state = args
    cfg = E.ENTRY_CFG
    K, C = bvh.cl_tri.shape
    route = packets.route(K, C, cfg.two_level_cull, cfg.super_factor)
    P = renderer.resolve_tile_size(cfg, scene.num_tris)
    print(f"entry: scene tris={scene.num_tris} clusters={K} C={C} P={P} "
          f"route={route.cull}/{route.kernel}")
    if route.kernel != "resident":
        raise AssertionError(f"entry: took the {route.kernel} route")
    fn(*args)
    sync()
    reset_counts(kernels)
    ms = []
    for _ in range(runs):
        st, t = cuda_ms_once(lambda: fn(*args))
        ms.append(t)
    launches, _ = path_counts("entry", kernels, "k1")
    med = float(np.median(ms))
    rays = cfg.num_pixels * cfg.spp * (cfg.num_bounces + 1)
    img = cpt.finalize_image(st, cfg)
    finite = all(bool(torch.isfinite(c).all()) for c in st.img)
    print(f"entry: {cfg.width}x{cfg.height} spp={cfg.spp} "
          f"bounces={cfg.num_bounces} runs={runs} run_ms="
          f"{[round(m, 3) for m in ms]} median_ms={med:.3f} "
          f"mrays_per_s={rays / med / 1e3:.3f} n={st.n} finite={finite} "
          f"k1_launches={launches['k1']} (per run "
          f"{launches['k1'] / runs:.2f}) other_launches="
          f"{sum(v for n, v in launches.items() if n != 'k1')}")
    if st.n != 1 or not finite or img.max() == 0:
        raise AssertionError("entry: the image is not one finite, lit "
                             "sample")
    extra.update(entry_ms=med, entry_run_ms=ms,
                 entry_mrays_per_s=rays / med / 1e3)

    # K1 against its plain version on the entry's batches
    prep = renderer.make_packet_prep(scene, bvh)
    trace_fn = renderer.make_trace_fn(scene, cfg, bvh, prep=prep)
    gaps = []
    for bname, batch in record_batches(scene, trace_fn, cam, cfg,
                                       base_key).items():
        res = check_batch(f"entry/{bname}", "k1", batch, scene, prep, cfg,
                          P, None, full_plain=True)
        gaps.append(res["max_abs"])
    res["max_abs"] = max(gaps)

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        # BDPT's CPU renders take longest: first
        order = sorted(QUIRK_CASES, key=lambda c: c[0] != "bdpt")
        futs = {quirk_label(*c): pool.submit(quirk_cpu_render, *c,
                                             quirk_size, quirk_spp)
                for c in order}

        # the card's image against entry("cpu")'s, here, one torch thread
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            t0 = time.perf_counter()
            cfn, cargs = E.entry(device="cpu")
            cst = cfn(*cargs)
            cpu_s = time.perf_counter() - t0
        finally:
            torch.set_num_threads(threads)
        frac = image_rule("entry: card vs cpu", img,
                          cpt.finalize_image(cst, cfg))
        rel, off = worst_rel(np.stack([c.cpu().numpy() for c in st.img]),
                             np.stack([c.numpy() for c in cst.img]))
        print(f"entry: card_vs_cpu channels_off_by_more_than_2={frac:.4%} "
              f"(limit 0.5%) worst_rel_gap={rel:.3g} values_past_rtol_3e-6="
              f"{off} of {3 * cfg.num_pixels} cpu_s={cpu_s:.2f}")
        extra.update(entry_card_vs_cpu_worst_rel=rel,
                     entry_card_vs_cpu_channels_off=frac)

        # ---- (b) the dry run: NCCL, two gloo ranks on this card, the CPU --
        with ThreadPoolExecutor(1) as ex:
            cpu_ranks = ex.submit(E.dryrun_ranks, 2, "cpu")
            t0 = time.perf_counter()
            one = E.dryrun_ranks(1, device=dev.type)
            one_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            two = E.dryrun_ranks(2, device=str(dev), backend="gloo")
            two_s = time.perf_counter() - t0
            cpu2 = cpu_ranks.result()
        losses = {}
        for name, ranks, wall in (("nccl1" if dev.type == "cuda" else
                                   "gloo1", one, one_s),
                                  ("gloo2_card", two, two_s),
                                  ("gloo2_cpu", cpu2, None)):
            losses[name] = E.dryrun_loss(len(ranks), ranks)
            for r, out in enumerate(ranks):
                counts = {k: int(out[k]) for k in ("k1_launches",
                                                   "k2_launches",
                                                   "k3_launches",
                                                   "plain_calls")}
                print(f"dryrun[{name}]: rank={r} " + " ".join(
                    f"{k}={v}" for k, v in counts.items())
                    + ("" if wall is None else f" wall_s={wall:.2f}"))
                on_card = dev.type == "cuda" and name != "gloo2_cpu"
                ran = counts["k1_launches" if on_card else "plain_calls"]
                if ran <= 0 or (on_card and (counts["plain_calls"]
                                             or counts["k2_launches"]
                                             or counts["k3_launches"])):
                    raise AssertionError(f"dryrun[{name}]: rank {r} did not "
                                         "run through K1 alone")
            extra[f"dryrun_{name}_k1_launches"] = [
                int(out["k1_launches"]) for out in ranks]
        ref = losses["gloo2_cpu"]
        worst = max(abs(v - ref) / abs(ref) for v in losses.values())
        print("dryrun: losses " + " ".join(
            f"{k}={v:.6f}" for k, v in losses.items())
            + f" worst_rel_gap={worst:.3g} (limit {DRYRUN_RTOL})")
        if worst > DRYRUN_RTOL:
            raise AssertionError("dryrun: the losses disagree")
        extra.update({f"dryrun_loss_{k}": v for k, v in losses.items()})

        # ---- (c) the quirk flags on the card against the CPU --------------
        reset_counts(kernels)
        card = {}
        for case in QUIRK_CASES:
            card[quirk_label(*case)] = quirk_render(dev, *case, quirk_size,
                                                    quirk_spp)
        sync()
        qlaunches, _ = path_counts("quirks", kernels, "k1")
        cpu = {k: f.result() for k, f in futs.items()}
    quirks = {}
    for integ, flags in QUIRK_CASES:
        label = quirk_label(integ, flags)
        cst, cimg = card[label]
        acc, pimg = cpu[label]
        got = np.stack([c.cpu().numpy() for c in cst.img])
        finite = bool(np.isfinite(got).all())
        frac = image_rule(f"quirk[{label}]: card vs cpu", cimg, pimg)
        rel, off = worst_rel(got, acc)
        line = (f"quirk[{label}]: {quirk_size}x{quirk_size} spp={quirk_spp} "
                f"finite={finite} channels_off_by_more_than_2={frac:.4%} "
                f"(limit 0.5%) worst_rel_gap={rel:.3g} "
                f"values_past_rtol_3e-6={off} of {got.size}")
        q = dict(channels_off=frac, worst_rel=rel)
        if flags:
            base = quirk_label(integ, {})
            m_card = (got != np.stack([
                c.cpu().numpy() for c in card[base][0].img])).any(0)
            m_cpu = (acc != cpu[base][0]).any(0)
            d_card, d_cpu = int(m_card.sum()), int(m_cpu.sum())
            same = bool(np.array_equal(m_card, m_cpu))
            line += (f" pixels_differing_from_default: card={d_card} "
                     f"cpu={d_cpu} same_pixels={same}")
            q.update(differing_card=d_card, differing_cpu=d_cpu)
            if d_cpu == 0 or not same:
                raise AssertionError(f"quirk[{label}]: the flag changes no "
                                     "pixel, or other pixels on the card "
                                     "than on the CPU")
        print(line)
        if not finite or got.max() <= 0:
            raise AssertionError(f"quirk[{label}]: not finite and lit")
        quirks[label] = q
    print(f"quirks: cases={len(QUIRK_CASES)} k1_launches={qlaunches['k1']} "
          f"other_launches="
          f"{sum(v for n, v in qlaunches.items() if n != 'k1')}")
    extra.update(quirks=quirks, quirk_k1_launches=qlaunches["k1"])
    wall = time.perf_counter() - t_phase
    print(f"entry: phase_wall_s={wall:.1f}")
    extra["phase_wall_s"] = wall
    return res, extra, launches["k1"]


def bench_values(label, result, keys):
    """A bench line's ``keys`` present and every number finite and above
    0."""
    if set(result) != keys:
        raise AssertionError(f"{label}: keys {sorted(result)}, expected "
                             f"{sorted(keys)}")
    for k, v in result.items():
        if k in ("metric", "unit"):
            continue
        if not isinstance(v, (int, float)) or not np.isfinite(v) or v <= 0:
            raise AssertionError(f"{label}: {k} = {v!r}")


def run_module(label, module, args=(), env=None, timeout=900):
    """``python -m module *args`` from the repository, ``env`` added and an
    import of jax failing (a module named jax that raises, first on the
    path). -> (its one JSON line on stdout, its standard error); raises
    unless it exits 0 with exactly one line on stdout."""
    from cudapathtracer_tpu_torch.utils.build import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as blocked:
        os.makedirs(os.path.join(blocked, "jax"))
        with open(os.path.join(blocked, "jax", "__init__.py"), "w") as f:
            f.write("raise ImportError('jax is blocked here')\n")
        full = dict(os.environ, **(env or {}))
        full["PYTHONPATH"] = os.pathsep.join(
            p for p in (blocked, REPO, full.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", module, *args],
                              cwd=REPO, env=full, capture_output=True,
                              text=True, timeout=timeout)
        wall = time.perf_counter() - t0
    sys.stderr.write(proc.stderr)
    lines = proc.stdout.splitlines()
    print(f"{label}: python -m {module} {' '.join(args)} exit="
          f"{proc.returncode} stdout_lines={len(lines)} "
          f"process_wall_s={wall:.2f}")
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"{label}: exit {proc.returncode}, stdout "
                             f"{proc.stdout[-2000:]!r}")
    return json.loads(lines[0]), proc.stderr


def rank_counts(label, stderr, want_ranks):
    """The ``# ... rank r: window_s=... k1_launches=...`` lines of
    bench_scaling's standard error: each rank's windows must have run K1
    alone. -> K1's launches by rank."""
    k1 = []
    for line in stderr.splitlines():
        if line.startswith("# ") and " window_s=" in line:
            counts = dict(kv.split("=") for kv in line.split()
                          if kv.split("=")[0] in ("k1_launches",
                                                  "k2_launches",
                                                  "k3_launches",
                                                  "plain_calls"))
            counts = {k: int(v) for k, v in counts.items()}
            if counts["k1_launches"] <= 0 or counts["k2_launches"] or \
                    counts["k3_launches"] or counts["plain_calls"]:
                raise AssertionError(f"{label}: a rank did not run K1 "
                                     f"alone: {line}")
            k1.append(counts["k1_launches"])
    if len(k1) != want_ranks:
        raise AssertionError(f"{label}: {len(k1)} rank lines, expected "
                             f"{want_ranks}")
    return k1


def trace_kernel_events(prof_dir, name):
    """The ``torch.profiler`` traces under ``prof_dir``: (files, the CUDA
    kernel events whose name holds ``name``, every CUDA kernel event)."""
    import glob

    files = sorted(glob.glob(os.path.join(prof_dir, "*.pt.trace.json")))
    hits = kernels = 0
    for path in files:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        for e in events:
            if e.get("cat") == "kernel":
                kernels += 1
                hits += name in e.get("name", "")
    return files, hits, kernels


def bench_phase(dev, kernels, check_batch, base_key):
    """Phase 17: the port's bench harnesses (cudapathtracer_tpu_torch/
    bench.py and bench_scaling.py). (a) ``bench.parts`` at bench.py's
    defaults in this process, the counts at 0 before each part and read
    after it (BENCH_PART_KERNEL: K1 alone, K2 alone at subdiv 6, no plain
    version); the assembled line printed as ``bench:`` and held to its keys,
    finite values above 0 and its baselines' formulas; each part's
    kernel on its bounce batch as step 5 checks a batch (sampled tiles).
    (b) The super knobs: K3 alone, and on its bounce batch. (c) ``python -m
    cudapathtracer_tpu_torch.bench`` in a fresh process, headline only,
    where jax cannot be imported: one JSON line with the headline's keys.
    (d) ``python -m cudapathtracer_tpu_torch.bench_scaling`` at its
    defaults (world 1 over NCCL: value 1.0, the five keys, K1 alone, a
    trace holding K1's kernel events), then two gloo ranks sharing this
    card (the gathered image world 1's bit for bit). -> {kernel: (launches
    on the path, its numbers on the bounce batch, extra keys)}."""
    from cudapathtracer_tpu_torch import bench as B
    from cudapathtracer_tpu_torch.ops import packets
    from cudapathtracer_tpu_torch.render import renderer
    from cudapathtracer_tpu_torch.utils.build import BUILD_DIR

    t_phase = time.perf_counter()

    def bounce_check(label, want, m):
        prep = renderer.make_packet_prep(m.scene, m.bvh)
        trace_fn = renderer.make_trace_fn(m.scene, m.cfg, m.bvh, prep=prep)
        batch = record_batches(m.scene, trace_fn, m.cam, m.cfg,
                               base_key)["bounce1"]
        P = renderer.resolve_tile_size(m.cfg, m.scene.num_tris)
        F = m.cfg.super_factor if want == "k3" else None
        return check_batch(f"{label}/bounce1", want, batch, m.scene,
                           prep, m.cfg, P, F, full_plain=False)

    def run_parts(label, env):
        """``bench.parts(dev, env)`` part by part. -> (the line, launches by
        part, the headline's and BDPT's unrounded Mrays/s, the bounce-batch
        numbers by kernel)."""
        result, launches, mrays, res = {}, {}, {}, {}
        reset_counts(kernels)
        for part, keys, m in B.parts(dev, env):
            torch.cuda.synchronize()
            want = ("k3" if env.get("BENCH_TWO_LEVEL") == "super"
                    else BENCH_PART_KERNEL[part])
            counts, _ = path_counts(f"{label}/{part}", kernels, want)
            launches[part] = counts[want]
            result.update(keys)
            mrays[part] = m.mrays
            K, C = m.bvh.cl_tri.shape
            route = packets.route(K, C, m.cfg.two_level_cull,
                                  m.cfg.super_factor)
            print(f"{label}/{part}: {m.cfg.width}x{m.cfg.height} "
                  f"spp={m.cfg.spp} integrator={m.cfg.integrator} "
                  f"sample_batch={m.cfg.sample_batch} tris={m.scene.num_tris}"
                  f" clusters={K} C={C} route={route.cull}/{route.kernel} "
                  f"window_s={[round(s, 4) for s in m.seconds]} "
                  f"mrays_per_s={m.mrays:.3f} {want}_launches={counts[want]}"
                  f" (per window {counts[want] / (B.REPEATS + 1):.2f}) "
                  f"keys={json.dumps(keys)}")
            if part in ("headline", "mrays_1310k") and want not in res:
                res[want] = bounce_check(f"{label}/{part}", want, m)
            del m
            torch.cuda.empty_cache()
            reset_counts(kernels)
        return result, launches, mrays, res

    # ---- (a) bench.py's defaults, part by part -----------------------------
    result, launches, mrays, res = run_parts("bench", {})
    print(f"bench: {json.dumps(result)}")
    bench_values("bench", result, BENCH_KEYS)
    for key, part, value in (
            ("vs_baseline", "headline", mrays["headline"]),
            ("bdpt_vs_baseline", "bdpt", mrays["bdpt"]),
            ("mrays_328k_vs_baseline", "mrays_328k", result["mrays_328k"])):
        if result[key] != round(value / B.BASELINE_MRAYS, 3):
            raise AssertionError(f"bench: {key} = {result[key]}, not "
                                 f"round({value} / {B.BASELINE_MRAYS}, 3)")
    k1_parts = [p for p, k in BENCH_PART_KERNEL.items() if k == "k1"]
    out = {"k1": (sum(launches[p] for p in k1_parts), res["k1"],
                  dict(bench=result, launches_by_part={
                      p: launches[p] for p in k1_parts})),
           "k2": (launches["mrays_1310k"], res["k2"],
                  dict(mrays_1310k=result["mrays_1310k"]))}

    # ---- (b) the super knobs: K3 -------------------------------------------
    sresult, slaunches, _, sres = run_parts("bench_super", BENCH_SUPER_ENV)
    print(f"bench_super: {json.dumps(sresult)}")
    bench_values("bench_super", sresult, BENCH_HEADLINE_KEYS)
    out["k3"] = (slaunches["headline"], sres["k3"], dict(bench=sresult))

    # ---- (c) the bench from a fresh process --------------------------------
    fresh, err = run_module("bench/fresh", "cudapathtracer_tpu_torch.bench",
                            env=BENCH_HEADLINE_ONLY)
    print(f"bench/fresh: {json.dumps(fresh)}")
    bench_values("bench/fresh", fresh, BENCH_HEADLINE_KEYS)
    if f"device={dev.type}" not in err:
        raise AssertionError("bench/fresh: the context line names no card")
    out["k1"][2]["fresh"] = fresh

    # ---- (d) bench_scaling: world 1 over NCCL, two gloo ranks on the card --
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as prof:
        scaling, err = run_module(
            "scaling", "cudapathtracer_tpu_torch.bench_scaling",
            env={"SCALE_PROFILE_DIR": prof})
        bench_values("scaling", {k: v for k, v in scaling.items()
                                 if k != "profile_artifact"},
                     SCALING_KEYS - {"profile_artifact"})
        k1_ranks = rank_counts("scaling", err, 1)
        files, hits, n_kernels = trace_kernel_events(
            scaling["profile_artifact"] or "", "dense_resident_kernel")
        print(f"scaling: {json.dumps(scaling)} k1_launches={k1_ranks} "
              f"trace_files={len(files)} trace_kernel_events={n_kernels} "
              f"k1_events={hits}")
        if (set(scaling) != SCALING_KEYS or scaling["value"] != 1.0
                or scaling["metric"] != "scaling efficiency 1->1 "
                f"({'gpu' if dev.type == 'cuda' else 'cpu'})"
                or scaling["profile_artifact"] != prof or len(files) != 1
                or hits <= 0):
            raise AssertionError("scaling: not the world-1 line with a "
                                 "trace of K1")
    shared, err = run_module(
        "scaling/gloo2", "cudapathtracer_tpu_torch.bench_scaling",
        ("--world", "2", "--backend", "gloo", "--device", str(dev)),
        env={"SCALE_PROFILE_DIR": ""})
    rank_counts("scaling/gloo2", err, 3)
    same = "# sharded vs 1-rank image max |delta| = 0.0 " in err
    print(f"scaling/gloo2: {json.dumps(shared)} image_bit_identical={same} "
          "(the efficiency: two ranks sharing one card, not a scaling "
          "number)")
    if not same or set(shared) != SCALING_KEYS:
        raise AssertionError("scaling/gloo2: the gathered image differs "
                             "from world 1's")
    wall = time.perf_counter() - t_phase
    print(f"bench: phase_wall_s={wall:.1f}")
    out["k1"][2].update(scaling=scaling, scaling_gloo2_card=shared,
                        phase_wall_s=wall)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {smi}")

    import cudapathtracer_tpu_torch as cpt
    from cudapathtracer_tpu_torch.accel import native
    from cudapathtracer_tpu_torch.models import procedural
    from cudapathtracer_tpu_torch.ops import packets, traversal
    from cudapathtracer_tpu_torch.ops.kernels import dense as k2
    from cudapathtracer_tpu_torch.ops.kernels import dense_resident as k1
    from cudapathtracer_tpu_torch.ops.kernels import dense_super as k3
    from cudapathtracer_tpu_torch.ops.kernels import fma as kfma
    from cudapathtracer_tpu_torch.ops.kernels import threefry as kt
    from cudapathtracer_tpu_torch.ops.kernels.dense_resident import (
        intersector_of)
    from cudapathtracer_tpu_torch.ops.kernels.work import (OPS_PER_TEST,
                                                           needed_work)
    from cudapathtracer_tpu_torch.ops.rng import (pixel_keys, prng_key,
                                                  sample_key)
    from cudapathtracer_tpu_torch.render import renderer
    from cudapathtracer_tpu_torch.render.camera import camera_rays
    from cudapathtracer_tpu_torch.utils.build import BUILD_LOG
    from cudapathtracer_tpu_torch.utils.constants import EPS_VISIBILITY
    from cudapathtracer_tpu_torch.utils.profiling import falsecolor_state

    kernels = {
        "k1": (k1.build, k1.dense_intersect_resident,
               k1.dense_intersect_resident_plain),
        "k2": (k2.build, k2.dense_intersect, k2.dense_intersect_plain),
        "k3": (k3.build, k3.dense_intersect_super,
               k3.dense_intersect_super_plain),
        "fma": (kfma.build, kfma.fma, kfma.fma_plain),
        "threefry": (kt.build, kt.threefry, kt.threefry_plain),
    }

    # ---- 2. build: every nvcc and the BVH builder at once ------------------
    def timed_build(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels) + 2) as pool:
        futs = {n: pool.submit(timed_build, b)
                for n, (b, _, _) in kernels.items()}
        futs["bvh_builder"] = pool.submit(timed_build, native.load)
        futs["obj_parser"] = pool.submit(timed_build, native.load_obj_parser)
        build_s = {n: f.result() for n, f in futs.items()}
    print("build: " + " ".join(f"{n}_s={s:.2f}" for n, s in build_s.items())
          + f" wall_s={time.perf_counter() - t0:.2f}")
    for lib, log in BUILD_LOG.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas[{lib}]: {line.strip()}")

    base_key = prng_key(1234, dev)

    # ---- 3. the five goldens on the card -----------------------------------
    def golden(name, scene, size, **cfg_kw):
        cfg = cpt.RenderConfig(width=size, height=size, **cfg_kw)
        st = cpt.render(scene, cpt.make_camera(width=size, height=size,
                                               device=dev), cfg, seed=1234,
                        device=dev)
        frac = check_golden(cpt.finalize_image(st, cfg),
                            os.path.join(GOLDENS, f"{name}.ppm"))
        print(f"golden: {name} integrator={cfg.integrator} "
              f"channels_off_by_more_than_2={frac:.4%} (limit 0.5%)")

    def cornell():
        return procedural.to_scene(procedural.cornell_box(), dev)

    golden("cornell_pt_nee_64_spp16", cornell(), 64, spp=16,
           integrator="pt_nee", samples_per_call=16)
    golden("cornell_pt_nee_128_spp8", cornell(), 128, spp=8,
           integrator="pt_nee", samples_per_call=8)
    # analytic spheres: ray_sphere on the card
    golden("cornell_sphere_pt_nee_32_spp8",
           procedural.cornell_with_analytic_sphere(device=dev), 32, spp=8,
           integrator="pt_nee", samples_per_call=8)
    # the default integrator, BDPT
    golden("cornell_bdpt_32_spp8", cornell(), 32, spp=8, samples_per_call=8)
    # the fine-BVH walk with its visit counts, on the card
    fscene = procedural.to_scene(procedural.colonnade(subdiv=2), dev)
    fcfg = cpt.RenderConfig(width=64, height=64, spp=1, samples_per_call=1,
                            integrator="pt_nee")
    fst, fstats = falsecolor_state(
        fscene, renderer.build_bvh_for_scene(fscene, fcfg.leaf_size),
        cpt.make_camera(pos=(0.0, 2.0, 3.4), width=64, height=64,
                        focal_length=2.0, device=dev), fcfg, seed=1234)
    frac = check_golden(cpt.finalize_image(fst, fcfg),
                        os.path.join(GOLDENS,
                                     "colonnade_bvh_falsecolor_64.ppm"))
    print(f"golden: colonnade_bvh_falsecolor_64 walk_steps="
          f"{int(fstats.steps)} max_ray_visits="
          f"{int(fstats.ray_visits.max())} channels_off_by_more_than_2="
          f"{frac:.4%} (limit 0.5%)")

    # ---- 4. the bvh and brute engines: no fold kernel ----------------------
    reset_counts(kernels)
    imgs = {}
    for tr in ("bvh", "brute"):
        cfg = cpt.RenderConfig(width=ENGINE_SIZE, height=ENGINE_SIZE,
                               spp=ENGINE_SPP, integrator="pt_nee",
                               samples_per_call=ENGINE_SPP, traversal=tr)
        st, ms = host_ms(lambda: cpt.render(
            cornell(), cpt.make_camera(width=ENGINE_SIZE,
                                       height=ENGINE_SIZE, device=dev),
            cfg, seed=1234, device=dev))
        imgs[tr] = torch.stack(list(st.img), dim=1)
        print(f"engines: traversal={tr} {ENGINE_SIZE}x{ENGINE_SIZE} "
              f"spp={ENGINE_SPP} wall_ms={ms:.1f}")
    launched = {n: w.launches for n, (_, w, _) in kernels.items()}
    plain_calls = sum(p.calls for _, _, p in kernels.values())
    same = torch.equal(imgs["bvh"].view(torch.int32),
                       imgs["brute"].view(torch.int32))
    lit = bool(torch.isfinite(imgs["bvh"]).all()) and \
        float(imgs["bvh"].max()) > 0
    print(f"engines: bvh_vs_brute_bit_identical={same} finite_and_lit={lit} "
          + " ".join(f"{n}_launches={v}" for n, v in launched.items())
          + f" plain_calls={plain_calls}")
    if not (same and lit) or plain_calls or any(
            v for n, v in launched.items() if n not in GLUE_KERNELS):
        raise AssertionError("the bvh and brute engines' images differ, or "
                             "a fold kernel ran")

    # ---- 4b. fma: the glue's FMA kernel against its plain version ----------
    fma_rows = fma_phase(dev)

    # ---- 4c. threefry: the RNG's kernel against its plain version ---------
    threefry_rows = threefry_phase(dev)

    def setup(label, subdiv, size=HEADLINE_SIZE, integrator="pt_nee",
              **cfg_kw):
        scene = procedural.to_scene(procedural.colonnade(subdiv=subdiv), dev)
        cfg = cpt.RenderConfig(width=size, height=size, spp=PATH_SPP,
                               integrator=integrator,
                               samples_per_call=PATH_SPP,
                               reuse_primary_hit=True, **cfg_kw)
        t0 = time.perf_counter()
        bvh = renderer.build_bvh_for_scene(scene, cfg.leaf_size,
                                           cluster_size=cfg.cluster_size)
        torch.cuda.synchronize()
        t_accel = time.perf_counter() - t0
        cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                              focal_length=2.0, device=dev)
        P = renderer.resolve_tile_size(cfg, scene.num_tris)
        K, C = bvh.cl_tri.shape
        kern = packets.route(K, C, cfg.two_level_cull,
                             cfg.super_factor).kernel
        print(f"{label}: scene tris={scene.num_tris} clusters={K} C={C} "
              f"P={P} route={kern} accel_s={t_accel:.2f}")
        return scene, cfg, bvh, cam, P, kern

    def variant(scene, cfg, bvh, cam, spp, intersector):
        """One intersector's render of a path: its config, packet prep
        (the intersector's pack), trace closure and window."""
        cfg = dataclasses.replace(cfg, spp=spp, samples_per_call=spp,
                                  intersector=intersector)
        prep = renderer.make_packet_prep(scene, bvh, intersector)
        trace_fn = renderer.make_trace_fn(scene, cfg, bvh, prep=prep)

        def window():
            return cpt.render_batch(scene, bvh, cam, cfg, base_key,
                                    cpt.init_accum(cfg, device=dev), spp,
                                    prep=prep)

        return cfg, prep, trace_fn, window

    def schedule_check(label, name, fn, part, pack, group):
        """The counting instance's clusters folded on the sampled tiles
        against a plain count of the kernel's schedule (groups of ``group``
        rays), tile by tile."""
        args = (part.ids, part.counts, part.entries, part.rays, *pack)
        counts = torch.empty((part.ids.shape[0], k1.COUNT_COLS),
                             dtype=torch.int64, device=dev)
        fn(*args, counts_out=counts)
        want = k1.fold_schedule(*args, group)[2]
        same = torch.equal(counts[:, 0], want)
        print(f"{label}: {name} clusters_folded={int(counts[:, 0].sum())} "
              f"plain_schedule={int(want.sum())} (groups of {group} rays, "
              f"{part.ids.shape[0]} sampled tiles) equal_per_tile={same}")
        if not same:
            raise AssertionError(f"{label}: {name} did not fold what its "
                                 "schedule folds")

    def check_batch(label, want, batch, scene, prep, cfg, P, F, full_plain,
                    equal_flat=False, two_level=False):
        """One batch of one path: the kernel against its plain version, its
        yardstick on the same rays timed in turns (K1: K2 on the same
        shortlists, which must agree bit for bit; K2: K1, the same; K3: K1
        on the flat shortlists, bit for bit too with ``equal_flat``), both
        counting instances, the schedule's folds and the bound; every
        kernel with the pack's intersector. ``two_level``: the shortlists
        of the capped two-level cull (``cfg.super_factor``,
        ``cfg.super_slots``), in cluster units. -> the numbers of the
        kernel's JSON entry."""
        isect = cfg.intersector
        _, wrap, plain = kernels[want]
        other = "k2" if want == "k1" else "k1"
        _, owrap, _ = kernels[other]

        def wrapper(*a, **kw):
            return wrap(*a, intersector=isect, **kw)

        def owrapper(*a, **kw):
            return owrap(*a, intersector=isect, **kw)

        extra = (F,) if F else ()
        pd, pack = prep.pdata, prep.resident_pack
        lists = (dict(super_factor=cfg.super_factor,
                      super_slots=cfg.super_slots) if two_level
                 else dict(super_factor=F))
        sl, sl_ms = host_ms(lambda: sorted_shortlists(batch, pd, P, cfg,
                                                      **lists))
        args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
        got = wrapper(*args, *extra)
        flat = sorted_shortlists(batch, pd, P, cfg) if F else sl
        oargs = (flat.ids, flat.counts, flat.entries, flat.rays, *pack)
        ref = owrapper(*oargs)
        (o_a, o_b), (ms_a, ms_b) = in_turns(
            lambda: owrapper(*oargs), lambda: wrapper(*args, *extra), 3)
        ms, o_ms = (ms_a + ms_b) / 2, (o_a + o_b) / 2
        same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        print(f"kernel[{label}]: {want} vs {other} on all {sl.ids.shape[0]} "
              f"tiles ({isect}): bit_identical={same} "
              f"differing_ids={int((got[1] != ref[1]).sum())} "
              f"{want}_ms={ms:.4f} ({ms_a:.4f}, {ms_b:.4f}) "
              f"{other}_ms={o_ms:.4f} ({o_a:.4f}, {o_b:.4f}; in turns "
              f"{other}, {want}, {want}, {other}) "
              f"{other}_over_{want}={o_ms / ms:.3f} ({other} on the "
              f"{'flat' if F else 'same'} shortlists)")
        # K1 and K2 fold one function on one input; K3 and K1 fold
        # different lists, each exact against the plain fold
        if (not F or equal_flat) and not same:
            raise AssertionError(f"{label}: {want} and {other} differ")
        part = sl if full_plain else sample_tiles(sl, SAMPLE_TILES)
        pargs = (part.ids, part.counts, part.entries, part.rays, *pack)
        want_p, plain_ms = host_ms(lambda: plain(*pargs, *extra))
        _, gap = agreement(
            f"kernel[{label}] {want} vs plain on {part.ids.shape[0]} "
            f"{'' if full_plain else 'sampled '}tiles",
            got if full_plain else wrapper(*pargs, *extra), want_p,
            part.rays)
        tests, touched, nbytes = needed_work(sl, got[0], pack,
                                             scene.num_tris, F)
        bnd = bound(tests, nbytes, OPS_PER_TEST[intersector_of(pack[0])])
        print(f"kernel[{label}]: tiles={sl.ids.shape[0]} "
              f"slots={sl.ids.shape[1]} "
              f"mean_count={float(sl.counts.float().mean()):.2f} "
              f"{want}_ms={ms:.4f} plain_ms={plain_ms:.1f} (on "
              f"{part.ids.shape[0]} tiles) sort_cull_topk_ms={sl_ms:.3f} "
              f"tests={tests} clusters_touched={touched} bytes={nbytes} "
              f"ops_per_test={OPS_PER_TEST[isect]} "
              f"bound_ms={bnd[0]:.4f} bound_by={bnd[1]} "
              f"share_of_bound={bnd[0] / ms:.1%}")
        # the counting instances; K1 counts a cluster once per block of up
        # to 128 rays that folds it, K3 per member
        k1_group = k1.k1_group(P)
        groups = {"k1": P // k1_group, "k2": 1, "k3": F}
        _, issued = fold_counts(
            f"fold[{label}]", want,
            lambda *a, **kw: wrapper(*a, *extra, **kw), args, got,
            int(sl.counts.sum()) * groups[want], tests)
        o_needed = (needed_work(flat, ref[0], pack, scene.num_tris)[0] if F
                    else tests)
        fold_counts(f"fold[{label}]", other, owrapper, oargs, ref,
                    int(flat.counts.sum()) * groups[other], o_needed)
        if not F:
            schedule_check(
                f"fold[{label}]", want, wrapper,
                sample_tiles(sl, SAMPLE_TILES) if full_plain else part,
                pack, k1_group if want == "k1" else P)
        return dict(ms=ms, plain_ms=plain_ms, bound=bnd, max_abs=gap,
                    tiles=sl.ids.shape[0], plain_tiles=part.ids.shape[0],
                    issued=issued, needed=tests)

    def fallback_check(label, scene, bvh, prep, P, intersector):
        """The fine-BVH fallback on the card: 64x64 primary rays through
        the packet engine with a one-cluster shortlist, so that the
        fallback walk runs; the hits must equal brute force's, both with
        ``intersector``."""
        pd, fs = prep.pdata, FALLBACK_SIZE
        fidx = torch.arange(fs * fs, dtype=torch.int64, device=dev)
        fcam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=fs, height=fs,
                               focal_length=2.0, device=dev)
        fo, fd = camera_rays(fcam, fidx, pixel_keys(
            sample_key(base_key, 0), fidx), lens=False)
        fmask = torch.ones(fs * fs, dtype=torch.bool, device=dev)
        hit = packets.trace_packets(
            fo, fd, pd, fine_td=traversal.make_trace_data(scene, bvh.fine),
            mask=fmask, tile_size=P, max_clusters=1,
            resident_pack=prep.resident_pack, intersector=intersector)
        brute = traversal.trace_bruteforce(fo, fd, scene,
                                           intersector=intersector)
        # unsorted, so the tiles are those of build_shortlists in ray
        # order; a ray took the fallback exactly when its final t is not
        # below U
        u = packets.build_shortlists(fo, fd, fmask, pd, P, 1).U
        n_fb = int((hit.t >= u.repeat_interleave(P)[:fs * fs]).sum())
        id_bad = int((hit.tri != brute.tri).sum())
        t_bad = int((hit.t != brute.t).sum())
        print(f"fallback[{label}]: intersector={intersector} rays="
              f"{fs * fs} max_clusters=1 fallback_rays={n_fb} "
              f"id_mismatches={id_bad} t_mismatches={t_bad}")
        if n_fb == 0 or id_bad or t_bad:
            raise AssertionError("the fallback did not run, or its hits "
                                 "differ from brute force")

    def mt_holds(label, batch, scene, bvh, prep, cfg, P):
        """The mt path's own holds on one batch (its bounce batch): K3's
        Moller-Trumbore instance on super shortlists of BDPT_SUPER_F
        clusters against its plain version and, bit for bit, K1's on the
        flat shortlists; Moller-Trumbore against Baldwin-Weber on the same
        rays (t within MT_BW_RTOL where both hit, hit/miss flips under
        MT_BW_FLIPS_MAX of the live rays); K1's Moller-Trumbore visibility
        instance with caps near each ray's hit, t bit for bit its
        closest-hit instance's with -3e38 exactly below the floor."""
        check_batch(f"{label}/super{BDPT_SUPER_F}", "k3", batch, scene, prep,
                    cfg, P, BDPT_SUPER_F, False, equal_flat=True)
        pd, pack = prep.pdata, prep.resident_pack
        sl = sorted_shortlists(batch, pd, P, cfg)
        head = (sl.ids, sl.counts, sl.entries)
        tm, im = k1.dense_intersect_resident(*head, sl.rays, *pack,
                                             intersector="mt")
        tb, ib = k1.dense_intersect_resident(
            *head, sl.rays, *k1.pack_clusters(pd, "bw"))
        live = sl.rays[:, 6] > 0.5
        both = live & (im >= 0) & (ib >= 0)
        rel = float(((tm - tb).abs() / tb.abs())[both].max())
        flips = int((live & ((im >= 0) != (ib >= 0))).sum())
        n_live = int(live.sum())
        print(f"mt_vs_bw[{label}]: live_rays={n_live} both_hit="
              f"{int(both.sum())} max_rel_dt={rel:.3g} (limit {MT_BW_RTOL}) "
              f"hit_miss_flips={flips} ({flips / n_live:.4%}, limit "
              f"{MT_BW_FLIPS_MAX:.0%}) differing_ids="
              f"{int((both & (im != ib)).sum())}")
        if rel > MT_BW_RTOL or flips >= MT_BW_FLIPS_MAX * n_live:
            raise AssertionError(f"{label}: Moller-Trumbore and "
                                 "Baldwin-Weber disagree")
        rays = band_caps(sl.rays, tm, im)
        args = (*head, rays, *pack)
        closest = k1.dense_intersect_resident(*args, intersector="mt")
        vis = k1.dense_intersect_resident(*args, vis_band=VIS_BAND,
                                          intersector="mt")
        want = torch.where(closest[0] < rays[:, 7] - VIS_BAND,
                           k1.MASKED_T_INIT, closest[0])
        keep = vis[0] != k1.MASKED_T_INIT
        whole = (torch.equal(vis[0].view(torch.int32),
                             want.view(torch.int32))
                 and torch.equal(vis[1][keep], closest[1][keep]))
        print(f"vis[{label}]: k1 mt live_rays={n_live} "
              f"retired={int((~keep & live).sum())} "
              f"t_bit_identical_to_closest_below_floor={whole}")
        if not whole or int((~keep & live).sum()) == 0:
            raise AssertionError(f"{label}: K1's Moller-Trumbore visibility "
                                 "instance differs")

    def vis_instances(label, batch, scene, prep, cfg, P, bvh):
        """The visibility instances of K1, K2 (on the flat shortlists) and
        K3 (on super shortlists of BDPT_SUPER_F clusters) on one capped
        batch, each beside its closest-hit instance on the same lists:
        t bit for bit the closest hit's, -3e38 exactly below the floor
        cap - vis_band, ids the closest hit's elsewhere (whole batch); t and
        the kept ids equal to the plain visibility version (sampled tiles);
        K1's and K2's folds equal to the plain count of their schedule with
        retirement; both instances timed in turns; K3's bound on the super
        lists. Then the packet engine's visibility query against its
        closest-hit query on the same rays: every decision |t - len| <= eps
        equal, with len = t_cap - 2 eps. -> the ms of each instance, and
        K3's bound, for the JSON line."""
        band = 3.0 * EPS_VISIBILITY
        pd, pack = prep.pdata, prep.resident_pack
        F = BDPT_SUPER_F
        if pd.num_clusters <= 2 * F:
            raise AssertionError(f"{label}: K = {pd.num_clusters} allows no "
                                 f"super shortlists of {F}")
        flat = sorted_shortlists(batch, pd, P, cfg)
        sup = sorted_shortlists(batch, pd, P, cfg, super_factor=F)
        out = {}
        for name, sl, extra, group in (("k1", flat, (), k1.k1_group(P)),
                                       ("k2", flat, (), P),
                                       ("k3", sup, (F,), None)):
            _, wrapper, plain = kernels[name]
            args = (sl.ids, sl.counts, sl.entries, sl.rays, *pack)
            closest = wrapper(*args, *extra)
            vis = wrapper(*args, *extra, vis_band=band)
            want = torch.where(closest[0] < sl.rays[:, 7] - band,
                               k1.MASKED_T_INIT, closest[0])
            keep = vis[0] != k1.MASKED_T_INIT
            live = sl.rays[:, 6] > 0.5
            whole = (torch.equal(vis[0].view(torch.int32),
                                 want.view(torch.int32))
                     and torch.equal(vis[1][keep], closest[1][keep]))
            part = sample_tiles(sl, SAMPLE_TILES)
            pargs = (part.ids, part.counts, part.entries, part.rays, *pack)
            pv, plain_ms = host_ms(lambda: plain(*pargs, *extra,
                                                 vis_band=band))
            kv = wrapper(*pargs, *extra, vis_band=band)
            pk = kv[0] != k1.MASKED_T_INIT
            vs_plain = (torch.equal(kv[0].view(torch.int32),
                                    pv[0].view(torch.int32))
                        and torch.equal(kv[1][pk], pv[1][pk]))
            folds = ""
            if group is not None:
                counts = torch.empty((part.ids.shape[0], k1.COUNT_COLS),
                                     dtype=torch.int64, device=dev)
                wrapper(*pargs, counts_out=counts, vis_band=band)
                sched = k1.fold_schedule(*pargs, group, vis_band=band)[2]
                if not torch.equal(counts[:, 0], sched):
                    raise AssertionError(f"{label}: {name}'s visibility "
                                         "instance did not fold what its "
                                         "schedule folds")
                folds = (f" clusters_folded={int(counts[:, 0].sum())} "
                         f"plain_schedule={int(sched.sum())} (groups of "
                         f"{group}, {part.ids.shape[0]} sampled tiles)")
            else:
                # the closest-hit query's work on the super lists
                tests, _, nbytes = needed_work(sl, closest[0], pack,
                                               scene.num_tris, F)
                bnd = bound(tests, nbytes, OPS_PER_TEST["bw"])
                out["k3_vis_bound_ms"] = bnd[0]
                folds = (f" tests_needed={tests} bound_ms={bnd[0]:.4f} "
                         f"bound_by={bnd[1]}")
            (c_a, c_b), (v_a, v_b) = in_turns(
                lambda: wrapper(*args, *extra),
                lambda: wrapper(*args, *extra, vis_band=band), 3)
            c_ms, v_ms = (c_a + c_b) / 2, (v_a + v_b) / 2
            print(f"vis[{label}]: {name} tiles={sl.ids.shape[0]} "
                  f"live_rays={int(live.sum())} "
                  f"retired={int((~keep & live).sum())} "
                  f"t_bit_identical_to_closest_below_floor={whole} "
                  f"vs_plain_on_{part.ids.shape[0]}_tiles={vs_plain} "
                  f"plain_ms={plain_ms:.1f}{folds} vis_ms={v_ms:.4f} "
                  f"({v_a:.4f}, {v_b:.4f}) closest_ms={c_ms:.4f} "
                  f"({c_a:.4f}, {c_b:.4f}; in turns closest, vis, vis, "
                  f"closest) closest_over_vis={c_ms / v_ms:.3f}")
            if not (whole and vs_plain):
                raise AssertionError(f"{label}: {name}'s visibility instance "
                                     "differs")
            out[f"{name}_vis_ms"] = v_ms
            out[f"{name}_closest_ms"] = c_ms
        o, d, mask, cap = batch
        kw = dict(fine_td=traversal.make_trace_data(scene, bvh.fine),
                  mask=mask, tile_size=P, max_clusters=cfg.max_clusters,
                  sort=True, resident_pack=pack, t_cap=cap)
        hc = packets.trace_packets(o, d, pd, **kw)
        hv = packets.trace_packets(o, d, pd, vis_band=band, **kw)
        ln = cap - 2.0 * EPS_VISIBILITY
        dc = (hc.t - ln).abs() <= EPS_VISIBILITY
        dv = (hv.t - ln).abs() <= EPS_VISIBILITY
        occluded = hv.t == -1.0
        same = (torch.equal(dc, dv)
                and torch.equal(hv.t[~occluded], hc.t[~occluded]))
        print(f"vis[{label}]: trace_packets rays={mask.shape[0]} "
              f"bright={int(mask.sum())} visible={int(dc.sum())} "
              f"occluded_report={int(occluded.sum())} "
              f"decisions_equal_to_closest_hit={same}")
        if not same:
            raise AssertionError(f"{label}: the visibility query's "
                                 "decisions differ from the closest hit's")
        return out

    # ---- 5.-9. the render paths --------------------------------------------
    resident_src = "cudapathtracer_tpu/ops/pallas/dense_resident.py:999"
    super_cfg = dict(cluster_size=256, two_level_cull="super",
                     super_factor=8, super_list=255)
    paths = (
        # label, subdiv, RenderConfig knobs, route, kernel, spp, windows,
        # the Moller-Trumbore variant: (label, spp, windows) or None
        ("headline", 3, {}, "resident", "k1", HEADLINE_SPP,
         HEADLINE_WINDOWS, ("mt", MT_SPP, MT_WINDOWS)),
        ("resident_82k", 4, {}, "resident", "k1", PATH_SPP, PATH_WINDOWS,
         None),
        ("resident_wide", 5, {}, "resident", "k1", PATH_SPP, PATH_WINDOWS,
         None),
        ("stream", 6, {}, "stream", "k2", PATH_SPP, PATH_WINDOWS,
         ("stream_mt", PATH_SPP, MT_VARIANT_WINDOWS)),
        ("super", 5, super_cfg, "super", "k3", PATH_SPP, PATH_WINDOWS,
         ("super_mt", PATH_SPP, MT_VARIANT_WINDOWS)),
    )
    sources = {"k1": ("dense_resident", "dense_resident.cu", resident_src),
               "k2": ("dense", "dense.cu",
                      "cudapathtracer_tpu/ops/pallas/dense.py:343"),
               "k3": ("dense_super", "dense_super.cu",
                      "cudapathtracer_tpu/ops/pallas/dense_resident.py:913")}
    mt_pallas = {"k1": "cudapathtracer_tpu/ops/pallas/dense_resident.py:1107",
                 "k2": "cudapathtracer_tpu/ops/pallas/dense.py:424",
                 "k3": "cudapathtracer_tpu/ops/pallas/dense_resident.py:983"}
    entries = []
    for (label, subdiv, cfg_kw, route, want, spp, windows,
         mt_variant) in paths:
        scene, cfg0, bvh, cam, P, kern = setup(label, subdiv, **cfg_kw)
        if kern != route:
            raise AssertionError(f"{label} path took the {kern} route, "
                                 f"expected {route}")
        F = cfg0.super_factor if route == "super" else None
        variants = [(label, "bw", spp, windows)]
        if mt_variant:
            variants.append((mt_variant[0], "mt", *mt_variant[1:]))
        for lab, isect, vspp, vwin in variants:
            cfg, prep, trace_fn, window = variant(scene, cfg0, bvh, cam,
                                                  vspp, isect)
            batches = record_batches(scene, trace_fn, cam, cfg, base_key)
            res, gaps = {}, []
            for bname, batch in batches.items():
                # the plain version on the full batch: the headline's
                # batches and the mt path's primary; else sampled tiles
                full = lab == "headline" or (lab == "mt"
                                             and bname == "primary")
                res = check_batch(f"{lab}/{bname}", want, batch, scene, prep,
                                  cfg, P, F, full_plain=full)
                gaps.append(res["max_abs"])
            # the JSON line keeps the bounce batch's numbers and the largest
            # gap to the plain version over both batches
            res["max_abs"] = max(gaps)
            if lab == "headline":
                fallback_check(lab, scene, bvh, prep, P, "bw")
            if lab == "mt":
                mt_holds(f"{lab}/bounce1", batches["bounce1"], scene, bvh,
                         prep, cfg, P)
                fallback_check(lab, scene, bvh, prep, P, "mt")
            trace_breakdown(lab, scene, trace_fn, cam, cfg, base_key)
            launches = render_windows(lab, kernels, want, window, cfg, vspp,
                                      vwin)
            name, source, replaces = sources[want]
            if isect == "mt":
                name, replaces = f"{name}_mt", mt_pallas[want]
            if lab == "headline":
                # the FMA's entry: its launches in the main path's windows
                head = fma_rows[f"{HEADLINE_SIZE ** 2}/contiguous"]
                entries.append({
                    "name": "fma", "route": "cuda",
                    "source": "cudapathtracer_tpu_torch/csrc/fma.cu",
                    "replaces": None, "launches": launches["fma"],
                    "launches_per_sample": launches["fma"] / (vwin * vspp),
                    "max_abs_err": 0.0, "ms": head["ms"],
                    "plain_ms": head["plain_ms"],
                    "bound_ms": head["bound_ms"], "bound_by": "bytes",
                    "library": "torch.addcmul",
                    "library_ms": head["library_ms"], "sizes": fma_rows})
                head = threefry_rows[f"uniform_sites/{HEADLINE_SIZE ** 2}/6"]
                entries.append({
                    "name": "threefry", "route": "cuda",
                    "source": "cudapathtracer_tpu_torch/csrc/threefry.cu",
                    "replaces": None, "launches": launches["threefry"],
                    "launches_per_sample": launches["threefry"]
                    / (vwin * vspp),
                    "max_abs_err": 0.0, "ms": head["ms"],
                    "plain_ms": head["plain_ms"],
                    "bound_ms": head["bound_ms"],
                    "bound_by": head["bound_by"], "library": None,
                    "library_ms": None, "sizes": threefry_rows})
            entries.append(kernel_entry(
                f"{name}/{lab}" if want == "k1" else name, source, replaces,
                launches[want], res))
            del prep, trace_fn, window, batches
        del scene, bvh
        torch.cuda.empty_cache()

    # ---- 10. bdpt: the default integrator at the JAX bench's BDPT size -----
    scene, cfg, bvh, cam, P, kern = setup("bdpt", 3, size=BDPT_SIZE,
                                          integrator="bdpt")
    if kern != "resident":
        raise AssertionError(f"bdpt path took the {kern} route")
    cfg, prep, trace_fn, window = variant(scene, cfg, bvh, cam, BDPT_SPP,
                                          "bw")
    batches = record_batches(scene, trace_fn, cam, cfg, base_key)
    R = cfg.num_pixels
    sizes = {n: b[0].x.shape[0] for n, b in batches.items()}
    if sizes != {"primary": R, "subpath": 2 * R, "connection": 4 * R} or \
            batches["connection"][3] is None:
        raise AssertionError(f"bdpt batches {sizes}: expected R, 2R and a "
                             "capped 4R")
    res = {}
    for bname, batch in batches.items():
        res[bname] = check_batch(f"bdpt/{bname}", "k1", batch, scene, prep,
                                 cfg, P, None, full_plain=bname == "primary")
    conn = dict(res["connection"])
    conn["max_abs"] = max(r["max_abs"] for r in res.values())
    vis_ms = vis_instances("bdpt/connection", batches["connection"], scene,
                           prep, cfg, P, bvh)
    trace_breakdown("bdpt", scene, trace_fn, cam, cfg, base_key)
    # windows with vis_dropout off and on, in turns: the same image

    def bdpt_window(c):
        return lambda: cpt.render_batch(scene, bvh, cam, c, base_key,
                                        cpt.init_accum(c, device=dev),
                                        c.spp, prep=prep)

    wins = windows_in_turns(
        "bdpt", kernels, "k1",
        {"vis_dropout_off": bdpt_window(cfg),
         "vis_dropout_on": bdpt_window(dataclasses.replace(
             cfg, vis_dropout=True))},
        cfg.num_pixels * cfg.spp * (cfg.num_bounces + 1), PATH_WINDOWS)
    launches = sum(w["launches"] for w in wins.values())
    samples = 2 * PATH_WINDOWS * cfg.spp
    print(f"bdpt: k1_launches_per_sample={launches / samples:.2f} "
          "fma_launches_per_sample="
          f"{sum(w['fma_launches'] for w in wins.values()) / samples:.2f}")
    entry = kernel_entry("dense_resident/bdpt", "dense_resident.cu",
                         resident_src, launches, conn)
    entry.update(vis_ms)
    entries.append(entry)
    del scene, bvh, prep, trace_fn, window, batches
    torch.cuda.empty_cache()

    # ---- 12. train: the differentiable pass, K1 in forward and recompute --
    res, extra, launches = train_phase(dev, kernels)
    entry = kernel_entry("dense_resident/train", "dense_resident.cu",
                         resident_src, launches, res)
    entry.update(extra)
    entries.append(entry)

    # ---- 13. cli: host I/O, checkpoints and the CLI ------------------------
    torch.cuda.empty_cache()
    res, extra, launches, live_png = cli_phase(dev, kernels, check_batch,
                                               base_key)
    entry = kernel_entry("dense_resident/cli", "dense_resident.cu",
                         resident_src, launches, res)
    entry.update(extra)
    entries.append(entry)

    # ---- 14. sharded: torch.distributed, checkpoints, the CLI's --sharded -
    torch.cuda.empty_cache()
    res, extra, launches = sharded_phase(dev, kernels, check_batch, base_key,
                                         live_png)
    entry = kernel_entry("dense_resident/sharded", "dense_resident.cu",
                         resident_src, launches, res)
    entry.update(extra)
    entries.append(entry)

    # ---- 15. twolevel: the capped two-level cull, sample batches, rounds --
    torch.cuda.empty_cache()
    res, extra, launches = twolevel_phase(dev, kernels, check_batch, base_key)
    entry = kernel_entry("dense/twolevel", "dense.cu",
                         "cudapathtracer_tpu/ops/pallas/dense.py:343",
                         launches, res)
    entry.update(extra)
    entries.append(entry)

    # ---- 16. entry: the graft entry points and the quirk flags -------------
    torch.cuda.empty_cache()
    res, extra, launches = entry_phase(dev, kernels, check_batch)
    entry = kernel_entry("dense_resident/entry", "dense_resident.cu",
                         resident_src, launches, res)
    entry.update(extra)
    entries.append(entry)

    # ---- 17. bench: the bench harnesses, bench.py's defaults ---------------
    torch.cuda.empty_cache()
    for k, (launches, res, extra) in bench_phase(dev, kernels, check_batch,
                                                 base_key).items():
        name, source, replaces = sources[k]
        entry = kernel_entry(f"{name}/bench", source, replaces, launches, res)
        entry.update(extra)
        entries.append(entry)

    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
