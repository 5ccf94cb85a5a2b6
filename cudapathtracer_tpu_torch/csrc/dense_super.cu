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
// What bounds it on an H100: as K1, float32 ALU work in the fold (about 35
// operations per ray-triangle test); at colonnade subdiv 5 with C = 256 the
// pack is 24 MB and stays in the 50 MB L2. The design:
//   * one block per ray tile, one thread per ray;
//   * each super slot first takes K1's early-exit block vote against the
//     super's entry, which is valid because a super's box contains its
//     members' boxes, so its entry lower-bounds theirs;
//   * then, member by member: each ray gates the member's box against its
//     own best t, a block vote skips the member when no ray passes, else
//     the block stages the member's cluster in shared memory and the rays
//     that passed fold it (K1's gate, staging and fold, bw_fold.cuh).
// Dropped from the TPU kernel as TPU workarounds: the f32 gate bitmask and
// its groups * F + 1 <= 24 budget, and the count ladder (schedule only).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bw_fold.cuh"

namespace {

using bwfold::kRows;

__global__ void dense_super_kernel(
    const int32_t* __restrict__ ids,       // (Tl, M) shortlist super ids
    const int32_t* __restrict__ counts,    // (Tl,) valid slots per tile
    const float* __restrict__ entries,     // (Tl, M) ascending super entry
    const float* __restrict__ rays,        // (Tl, 8, P) o, d, mask, cap
    const float* __restrict__ packed,      // (K+1, 12, C) BW rows
    const int32_t* __restrict__ tri,       // (K+1, C) triangle ids
    const float* __restrict__ boxes,       // (K+1, 6) lo.xyz, hi.xyz
    float* __restrict__ t_out,             // (Tl, P)
    int32_t* __restrict__ tri_out,         // (Tl, P)
    int M, int C, int F, int K) {
  extern __shared__ float smem[];
  float* cl = smem;                                   // kRows * C
  int32_t* cl_id = reinterpret_cast<int32_t*>(smem + kRows * C);  // C

  const int P = blockDim.x;
  const int lane = threadIdx.x;
  const int64_t tile = blockIdx.x;
  float t;
  int32_t best = -1;
  const bwfold::Ray r = bwfold::load_ray(rays, tile, P, lane, &t);

  const int cnt = counts[tile];
  for (int s = 0; s < cnt; ++s) {
    if (!__syncthreads_or(r.live && t >= entries[tile * M + s])) break;
    const int64_t first = static_cast<int64_t>(ids[tile * M + s]) * F;
    for (int j = 0; j < F; ++j) {
      const int sid = static_cast<int>(
          first + j < K ? first + j : static_cast<int64_t>(K));
      const bool pass = bwfold::box_gate(
          boxes + static_cast<int64_t>(sid) * 6, r, t);
      if (!__syncthreads_or(pass)) continue;
      bwfold::stage_cluster(cl, cl_id, packed, tri, sid, C, lane, P);
      __syncthreads();
      if (pass) bwfold::bw_fold(cl, cl_id, C, C, r, t, best);
      __syncthreads();  // the next member's load overwrites shared memory
    }
  }
  t_out[tile * P + lane] = t;
  tri_out[tile * P + lane] = best;
}

}  // namespace

extern "C" int dense_super_launch(
    const void* ids, const void* counts, const void* entries,
    const void* rays, const void* packed, const void* tri, const void* boxes,
    void* t_out, void* tri_out, int Tl, int M, int P, int C, int F, int K,
    void* stream) {
  const size_t smem = static_cast<size_t>(kRows + 1) * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dense_super_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_super_kernel<<<Tl, P, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(counts),
      static_cast<const float*>(entries), static_cast<const float*>(rays),
      static_cast<const float*>(packed), static_cast<const int32_t*>(tri),
      static_cast<const float*>(boxes), static_cast<float*>(t_out),
      static_cast<int32_t*>(tri_out), M, C, F, K);
  return static_cast<int>(cudaGetLastError());
}
