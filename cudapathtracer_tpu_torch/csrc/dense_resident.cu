// Dense closest-hit over each ray tile's entry-sorted cluster shortlist.
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
// contraction is 3 deep). The scene is small next to the 50 MB L2 (1.5 MB
// at 20,884 triangles), so each folded slot reads 13*C*4 bytes from L2 and
// then only shared memory. The work that can be skipped is the lever:
//   * one block per ray tile, one thread per ray (blockDim = P);
//   * a block vote ends the tile when no live ray's best t reaches the next
//     slot's entry distance (entries ascend; >= keeps equal-t hits, which
//     the lower-id tie-break may still need);
//   * each ray tests the cluster's box against its own best t; a block vote
//     skips the slot when no ray passes, so the cluster is never loaded;
//   * the rays that pass fold the C triangles from shared memory, where
//     every thread reads the same word at once (a broadcast, no bank
//     conflicts).
// Dropped from the TPU kernel as TPU workarounds: ids as floats id + 2^23,
// the 16-boxes-per-row SMEM packing, the float gate bitmask, the VMEM
// budget, the count ladder, warm start and ray subgroups (the last three
// change only the schedule). The fold forms, with fmaf, exactly the fused
// multiply-adds that XLA forms for the JAX package's formulas, and the
// plain version emulates them exactly; -fmad=false keeps the compiler from
// fusing anything else, so the two round alike bit for bit. The gate, the
// staging and the fold live in bw_fold.cuh, shared with K2 and K3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bw_fold.cuh"

namespace {

using bwfold::kRows;

__global__ void dense_resident_kernel(
    const int32_t* __restrict__ ids,       // (Tl, M) shortlist cluster ids
    const int32_t* __restrict__ counts,    // (Tl,) valid slots per tile
    const float* __restrict__ entries,     // (Tl, M) ascending entry t
    const float* __restrict__ rays,        // (Tl, 8, P) o, d, mask, cap
    const float* __restrict__ packed,      // (K+1, 12, C) BW rows
    const int32_t* __restrict__ tri,       // (K+1, C) triangle ids
    const float* __restrict__ boxes,       // (K+1, 6) lo.xyz, hi.xyz
    float* __restrict__ t_out,             // (Tl, P)
    int32_t* __restrict__ tri_out,         // (Tl, P)
    int M, int C) {
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
    const int sid = ids[tile * M + s];
    const bool pass = bwfold::box_gate(
        boxes + static_cast<int64_t>(sid) * 6, r, t);
    if (!__syncthreads_or(pass)) continue;
    bwfold::stage_cluster(cl, cl_id, packed, tri, sid, C, lane, P);
    __syncthreads();
    if (pass) bwfold::bw_fold(cl, cl_id, C, C, r, t, best);
    __syncthreads();  // the next slot's load overwrites shared memory
  }
  t_out[tile * P + lane] = t;
  tri_out[tile * P + lane] = best;
}

}  // namespace

extern "C" int dense_resident_launch(
    const void* ids, const void* counts, const void* entries,
    const void* rays, const void* packed, const void* tri, const void* boxes,
    void* t_out, void* tri_out, int Tl, int M, int P, int C, void* stream) {
  const size_t smem = static_cast<size_t>(kRows + 1) * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dense_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_resident_kernel<<<Tl, P, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(counts),
      static_cast<const float*>(entries), static_cast<const float*>(rays),
      static_cast<const float*>(packed), static_cast<const int32_t*>(tri),
      static_cast<const float*>(boxes), static_cast<float*>(t_out),
      static_cast<int32_t*>(tri_out), M, C);
  return static_cast<int>(cudaGetLastError());
}
