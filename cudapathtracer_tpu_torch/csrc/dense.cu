// K2: dense closest-hit over each ray tile's entry-sorted cluster shortlist,
// for scenes too large to stay in cache.
//
// Replaces the Pallas TPU kernel
// cudapathtracer_tpu/ops/pallas/dense.py:dense_intersect (_make_kernel): the
// function of K1 (dense_resident.cu), for scenes whose cluster blocks the
// TPU could not keep in VMEM and streamed from HBM through an 8-deep DMA
// ring, gated before the fetch. Same inputs, same layout (pack_clusters),
// same result as K1, bit for bit.
//
// What bounds it on an H100: at colonnade subdiv 6 (1,311,124 triangles,
// C = 1024, P = 128) the pack is 92 MB, more than the 50 MB L2, and the
// tests the rays need are float32 ALU work (about 35 operations each), which
// sets the bound. The ray-stationary fold that this kernel ran before (K1's,
// on a cp.async chunk ring) issued 1.49x the tests the bounce batch needs and
// was no faster than K1. The design is the gated fold (gated_fold.cuh) with
// one member per slot:
//   * the rays that pass a slot's gate are compacted into a list, and each
//     thread tests one triangle, held in registers, against the listed rays
//     only: 1.02x the tests needed, and 2 shared loads per test, not 13;
//   * nothing is staged but the chunk's boxes: a block keeps 40 bytes per
//     ray and 8 KB of shared memory, and at 64 registers a thread an SM
//     holds 8 blocks of 128, which hide each other's loads from device
//     memory. Within a block the next round's triangle is loaded before
//     this round's tests.
// On one H100 80GB HBM3 at a 700 W limit it takes 2.31-2.39 ms on the
// subdiv-6 bounce batch, where the ray-stationary fold took 13.40 ms on the
// same shortlists and this kernel took 13.73 before (18% of its operations
// bound), and 1.93-1.95 ms on the primary batch (chip_smoke.py, PERF.md).
// K1 now runs this kernel's code (gated_fold.cuh:gated_tile) in blocks of at
// most 128 rays, so at P = 128 the two are one launch; both keep the plain
// fold's result bit for bit. Its visibility instance (vis_band > 0) is the
// TPU kernel's vis_band mode (dense.py:79), gated_fold.cuh's note.
//
// Moller-Trumbore instance (a pack of 9 rows, the intersector "mt"): the TPU
// kernel's other test body, _mt_fold_pc (dense_resident.py:198-247), which
// dense.py:424 picks with bw=False, through gated_fold.cuh's MT policy and
// bw_fold.cuh:mt_test. The fold is the same; a test costs 47 arithmetic
// operations against Baldwin-Weber's 33 and loads 9 rows instead of 12.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_fold.cuh"

namespace {

template <class Test, bool kCount, bool kVis>
__global__ void dense_stream_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ counts,
    const float* __restrict__ entries, const float* __restrict__ rays,
    const float* __restrict__ packed, const int32_t* __restrict__ tri,
    const float* __restrict__ boxes, float* __restrict__ t_out,
    int32_t* __restrict__ tri_out, long long* __restrict__ counts_out,
    int M, int C, int K, float vis_band) {
  // a slot is one cluster: F = 1
  gfold::gated_tile<Test, kCount, kVis>(ids, counts, entries, rays, packed,
                                        tri, boxes, t_out, tri_out,
                                        counts_out, M, blockDim.x, C, 1, K,
                                        vis_band);
}

template <class Test>
int launch(const void* ids, const void* counts, const void* entries,
           const void* rays, const void* packed, const void* tri,
           const void* boxes, void* t_out, void* tri_out, void* counts_out,
           int Tl, int M, int P, int C, int K, float vis_band, void* stream) {
  // the instance per call: counting or timed, visibility or closest hit
  const bool vis = vis_band > 0.0f;
  auto kernel = counts_out ? (vis ? &dense_stream_kernel<Test, true, true>
                                  : &dense_stream_kernel<Test, true, false>)
                           : (vis ? &dense_stream_kernel<Test, false, true>
                                  : &dense_stream_kernel<Test, false, false>);
  const size_t smem = gfold::shared_bytes(P, 1);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<Tl, P, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(counts),
      static_cast<const float*>(entries), static_cast<const float*>(rays),
      static_cast<const float*>(packed), static_cast<const int32_t*>(tri),
      static_cast<const float*>(boxes), static_cast<float*>(t_out),
      static_cast<int32_t*>(tri_out), static_cast<long long*>(counts_out),
      M, C, K, vis_band);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `rows`, the pack's row count, picks the triangle test: 12 Baldwin-Weber,
// 9 Moller-Trumbore.
extern "C" int dense_stream_launch(
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
