// K1: dense closest-hit over each ray tile's entry-sorted cluster shortlist,
// for scenes whose cluster pack stays resident.
//
// Replaces the Pallas TPU kernel
// cudapathtracer_tpu/ops/pallas/dense_resident.py:dense_intersect_resident
// (_make_kernel, _bw_fold_pc, _box_hit_row). It computes the same result:
// for every ray of a tile, the closest Baldwin-Weber hit with 0 < t over the
// clusters of the tile's shortlist, exact-t ties to the lower triangle id.
// The fold starts at min(cap, MAX_FLOAT) for live lanes (cap = the ray's
// scene-exit distance, row 7 of the ray block) and at -3e38 for masked
// lanes, which therefore never update. A ray that finds nothing below its
// cap returns t = cap with id -1; the caller restores the miss sentinel.
//
// What bounds it on an H100: the fold is float32 ALU work, about 35
// operations per ray-triangle test, with no use for the tensor cores (the
// contraction is 3 deep). On the resident route every pack fits in the 50 MB
// L2 (1.5 MB at colonnade subdiv 3, 6.3 MB at subdiv 4, 24.5 MB at subdiv
// 5), so a cluster's rows cost an L2 read, and the levers are the work that
// can be skipped and the cost of each test. K1 runs the gated fold's block
// schedule, the code K2 runs (gated_fold.cuh:gated_tile, one cluster per
// slot): the rays that pass a cluster's gate are compacted into a list and
// each thread tests one triangle against them, so a test costs 2 shared
// loads, and waste (lane tests issued over tests needed) is 1.04-1.17 at the
// three resident shapes. The one difference is the launch: a block folds at
// most kBlockRays = 128 rays of a tile, with its own votes, gates and
// lists over the tile's whole shortlist. At P = 256 (subdiv 3 and 4) that
// halves the warps each barrier waits for, and the tile's two halves stop
// at their own depth; at P = 128 (subdiv 5) the launch is K2's.
//
// tools/tune_gated_fold.py times this kernel against K2's in turns (one
// H100 80GB HBM3, 700 W; PERF.md): blocks of 128 rays were 1.19x and 1.12x
// faster than K2's block per tile on the subdiv-3 primary and bounce
// batches, 1.13x and 1.03x at subdiv 4, and K2's own launch at subdiv 5.
// Against the ray-stationary K1 it replaces, that is 1.3x, 1.5x and 3.8x on
// the primary and 4.2x, 5.7x and 9.7x on the bounce batches of subdiv 3, 4
// and 5. Two other designs were timed against it and dropped: a warp
// schedule (every warp votes, gates and folds alone), as fast at subdiv 3
// and 4 but 10% slower than K2 at subdiv 5 (C = 1024, P = 128), and an early
// out of the tests past the ray's t, 6-9% slower everywhere.
//
// The kernel keeps the plain version's result bit for bit: the tests form,
// with fmaf, exactly the fused multiply-adds that XLA forms for the JAX
// package's formulas, -fmad=false keeps the compiler from fusing anything
// else, and the 64-bit atomicMin keys keep (t, id)'s lexicographic minimum
// in any order. Dropped from the TPU kernel as TPU workarounds: ids as
// floats id + 2^23, the 16-boxes-per-row SMEM packing, the float gate
// bitmask, the VMEM budget, the count ladder, warm start and ray subgroups
// (a block of 128 rays is a ray subgroup of the tile, gated on its own).
//
// Counting instance (kCount, for measurements only; the timed instance is
// compiled without it): gated_fold.cuh's columns, with column 0 the
// clusters folded summed over the blocks of the tile that fold them.
//
// Visibility instance (kVis, launched where the caller's vis_band > 0:
// BDPT's connection rays with vis_dropout): the TPU kernel's _vis_drop
// (dense_resident.py:330-347), gated_fold.cuh's note. A ray whose t falls
// below cap - vis_band retires at that member's merge, so it stops gating,
// folding and holding its block's exit vote open.
//
// Moller-Trumbore instance (a pack of 9 rows, the intersector "mt"): the TPU
// kernel's other test body, _mt_fold_pc (dense_resident.py:198-247), which
// dense_resident.py:1107 picks with bw=False, through gated_fold.cuh's MT
// policy and bw_fold.cuh:mt_test. The fold is the same; a test costs 47
// arithmetic operations against Baldwin-Weber's 33 and loads 9 rows instead of
// 12.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_fold.cuh"

namespace {

// rays per block at most (ops/kernels/dense_resident.py:K1_BLOCK_RAYS)
constexpr int kBlockRays = 128;

template <class Test, bool kCount, bool kVis>
__global__ void dense_resident_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ counts,
    const float* __restrict__ entries, const float* __restrict__ rays,
    const float* __restrict__ packed, const int32_t* __restrict__ tri,
    const float* __restrict__ boxes, float* __restrict__ t_out,
    int32_t* __restrict__ tri_out, long long* __restrict__ counts_out,
    int M, int P, int C, int K, float vis_band) {
  // a slot is one cluster: F = 1
  gfold::gated_tile<Test, kCount, kVis>(ids, counts, entries, rays, packed,
                                        tri, boxes, t_out, tri_out,
                                        counts_out, M, P, C, 1, K, vis_band);
}

template <class Test>
int launch(const void* ids, const void* counts, const void* entries,
           const void* rays, const void* packed, const void* tri,
           const void* boxes, void* t_out, void* tri_out, void* counts_out,
           int Tl, int M, int P, int C, int K, float vis_band, void* stream) {
  // blocks of B = min(kBlockRays, P) rays, halved until B divides P
  int B = kBlockRays < P ? kBlockRays : P;
  while (P % B != 0) B /= 2;
  // the instance per call: counting or timed, visibility or closest hit
  const bool vis = vis_band > 0.0f;
  auto kernel =
      counts_out ? (vis ? &dense_resident_kernel<Test, true, true>
                        : &dense_resident_kernel<Test, true, false>)
                 : (vis ? &dense_resident_kernel<Test, false, true>
                        : &dense_resident_kernel<Test, false, false>);
  const size_t smem = gfold::shared_bytes(B, 1);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(Tl) * (P / B), B, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(counts),
      static_cast<const float*>(entries), static_cast<const float*>(rays),
      static_cast<const float*>(packed), static_cast<const int32_t*>(tri),
      static_cast<const float*>(boxes), static_cast<float*>(t_out),
      static_cast<int32_t*>(tri_out), static_cast<long long*>(counts_out),
      M, P, C, K, vis_band);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `rows`, the pack's row count, picks the triangle test: 12 Baldwin-Weber,
// 9 Moller-Trumbore.
extern "C" int dense_resident_launch(
    const void* ids, const void* counts, const void* entries,
    const void* rays, const void* packed, const void* tri, const void* boxes,
    void* t_out, void* tri_out, void* counts_out, int Tl, int M, int P,
    int C, int K, int rows, float vis_band, void* stream) {
  if (rows == gfold::BW::kRows)
    return launch<gfold::BW>(ids, counts, entries, rays, packed, tri, boxes,
                             t_out, tri_out, counts_out, Tl, M, P, C, K,
                             vis_band, stream);
  if (rows == gfold::MT::kRows)
    return launch<gfold::MT>(ids, counts, entries, rays, packed, tri, boxes,
                             t_out, tri_out, counts_out, Tl, M, P, C, K,
                             vis_band, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
