// K3: dense closest-hit over each ray tile's entry-sorted SUPERcluster
// shortlist.
//
// Replaces the Pallas TPU kernel
// cudapathtracer_tpu/ops/pallas/dense_resident.py:
// dense_intersect_resident_super (_make_kernel_super). A shortlist slot is a
// supercluster: F clusters consecutive in the flat BVH's preorder, member
// sid = min(sup * F + j, K); ids past K clamp to the sentinel cluster K,
// whose box is a far point box and whose triangles are all degenerate. The
// result is K1's (dense_resident.cu) over every member of every listed
// super: no member is dropped, so the shortlist shrinks by F without the
// capped two-level cull's lost candidates.
//
// What bounds it on an H100: as K1, float32 ALU work in the tests the rays
// need (about 35 operations each); at colonnade subdiv 5 with C = 256 the
// pack is 24 MB and stays in the 50 MB L2. The ray-stationary fold that it
// ran before (K1's, one member at a time, staged synchronously with two
// barriers per member) was 14% slower than K1 on the flat shortlists of the
// same bounce rays: a warp ran all C tests for one passing ray, 30% of them
// on padding triangles. The design is the gated fold (gated_fold.cuh):
//   * each super slot takes K1's early-exit vote against the super's entry,
//     which is valid because a super's box contains its members' boxes, so
//     its entry lower-bounds theirs;
//   * each ray gates the F members at the super's start, in the same pass
//     as that vote, against boxes staged in shared memory; the block visits
//     only members some ray passed, and a ray that folded since gates again
//     with its current t (the gate is monotone in t), so it folds exactly
//     what member-by-member gating folds;
//   * each visited member compacts its passing rays into a list and is
//     folded triangle-stationary against the list only, padding skipped,
//     the member's triangles loaded into registers before the list's
//     barrier.
// On one H100 80GB HBM3 at a 700 W limit it takes 1.18 ms on the subdiv-5
// bounce batch, where K1 takes 5.34 ms on the flat shortlists of the same
// rays and this kernel took 6.12 before (8% of its operations bound), and
// 0.66 ms on the primary batch (K1 1.04; tools/time_kernels.py, PERF.md). Its
// visibility instance (vis_band > 0) is _make_kernel_super's vis_band mode
// (dense_resident.py:699-703), gated_fold.cuh's note: a ray that retires
// inside a super gates again at -3e38 and passes no further member.
//
// Moller-Trumbore instance (a pack of 9 rows, the intersector "mt"): the TPU
// kernel's other test body, _mt_fold_pc (dense_resident.py:198-247), which
// dense_resident.py:983 picks with bw=False, through gated_fold.cuh's MT
// policy and bw_fold.cuh:mt_test. The fold is the same; a test costs 47
// arithmetic operations against Baldwin-Weber's 33 and loads 9 rows instead of
// 12.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_fold.cuh"

namespace {

template <class Test, bool kCount, bool kVis>
__global__ void dense_super_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ counts,
    const float* __restrict__ entries, const float* __restrict__ rays,
    const float* __restrict__ packed, const int32_t* __restrict__ tri,
    const float* __restrict__ boxes, float* __restrict__ t_out,
    int32_t* __restrict__ tri_out, long long* __restrict__ counts_out,
    int M, int C, int F, int K, float vis_band) {
  gfold::gated_tile<Test, kCount, kVis>(ids, counts, entries, rays, packed,
                                        tri, boxes, t_out, tri_out,
                                        counts_out, M, blockDim.x, C, F, K,
                                        vis_band);
}

template <class Test>
int launch(const void* ids, const void* counts, const void* entries,
           const void* rays, const void* packed, const void* tri,
           const void* boxes, void* t_out, void* tri_out, void* counts_out,
           int Tl, int M, int P, int C, int F, int K, float vis_band,
           void* stream) {
  // the instance per call: counting or timed, visibility or closest hit
  const bool vis = vis_band > 0.0f;
  auto kernel = counts_out ? (vis ? &dense_super_kernel<Test, true, true>
                                  : &dense_super_kernel<Test, true, false>)
                           : (vis ? &dense_super_kernel<Test, false, true>
                                  : &dense_super_kernel<Test, false, false>);
  const size_t smem = gfold::shared_bytes(P, F);
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
      M, C, F, K, vis_band);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `rows`, the pack's row count, picks the triangle test: 12 Baldwin-Weber,
// 9 Moller-Trumbore.
extern "C" int dense_super_launch(
    const void* ids, const void* counts, const void* entries,
    const void* rays, const void* packed, const void* tri, const void* boxes,
    void* t_out, void* tri_out, void* counts_out, int Tl, int M, int P,
    int C, int F, int K, int rows, float vis_band, void* stream) {
  if (F < 1 || F > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == gfold::BW::kRows)
    return launch<gfold::BW>(ids, counts, entries, rays, packed, tri, boxes,
                             t_out, tri_out, counts_out, Tl, M, P, C, F, K,
                             vis_band, stream);
  if (rows == gfold::MT::kRows)
    return launch<gfold::MT>(ids, counts, entries, rays, packed, tri, boxes,
                             t_out, tri_out, counts_out, Tl, M, P, C, F, K,
                             vis_band, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
