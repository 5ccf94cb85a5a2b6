// K2: dense closest-hit over each ray tile's entry-sorted cluster shortlist,
// for scenes too large to stay in cache.
//
// Replaces the Pallas TPU kernel
// cudapathtracer_tpu/ops/pallas/dense.py:dense_intersect (_make_kernel): the
// function of K1 (dense_resident.cu), for scenes whose cluster blocks the
// TPU could not keep in VMEM and streamed from HBM through an 8-deep DMA
// ring, gated before the fetch. Same inputs, same layout (pack_clusters),
// same result as K1, bit for bit: the hits of every ray, and the order of
// its folds.
//
// What bounds it on an H100: at colonnade subdiv 6 (1,311,124 triangles,
// C = 1024) the pack is 92 MB, more than the 50 MB L2, so a folded slot
// reads 13*C*4 = 53,248 bytes from device memory, which K1 stages
// synchronously. The fold is float32 ALU work, about 35 operations per
// ray-triangle test, and it is the bound: on an H100 80GB HBM3 at a 700 W
// limit this kernel runs at 3-18% of its operations bound there, and K1 on
// the same shortlists is 2-9% faster (chip_smoke.py, PERF.md), as other
// blocks' folds already hide K1's staging. The design:
//   * one block per ray tile, one thread per ray, as in K1;
//   * slots are taken in groups of kGroup. The group is gated against the
//     rays' best t at its start, one block vote per slot; t only falls, so
//     every slot K1 would fold is gated in (the gate is monotone in t);
//   * every gated-in cluster is copied with cp.async (16-byte copies) in
//     chunks of kChunk triangles (13 KB) through a ring of kStages chunk
//     stages in shared memory; the block folds a chunk while the next
//     kStages - 1 land. A cluster of C = 1024 is 53 KB, so whole clusters
//     would give a ring of 4 at most; chunks keep the ring 4 deep at 53 KB
//     of shared memory, which leaves room for 4 blocks on an SM;
//   * at each fetched slot the block takes K1's early-exit vote and K1's
//     per-ray gate with the current t, so it folds exactly what K1 folds, in
//     the same order. A block that exits while copies are in flight waits
//     for them first (cp.async.wait_all).
// The fold, gate and ray state are K1's (bw_fold.cuh); -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bw_fold.cuh"

namespace {

using bwfold::kRows;

constexpr int kGroup = 8;     // slots gated together (the TPU's ring depth)
constexpr int kStages = 4;    // chunk stages in the shared-memory ring
constexpr int kChunk = 256;   // triangles per chunk at most

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copies of triangles [c0, c0 + n) of cluster sid into a stage
// laid out as 12 rows and one id row, W words apart. vec: 16-byte copies
// (C and W multiples of 4, 16-byte aligned arrays), else 4-byte copies.
__device__ __forceinline__ void start_chunk(
    float* stage, int W, const float* __restrict__ packed,
    const int32_t* __restrict__ tri, int sid, int C, int c0, int n,
    bool vec, int lane, int P) {
  const float* src = packed + static_cast<int64_t>(sid) * kRows * C + c0;
  const int32_t* src_id = tri + static_cast<int64_t>(sid) * C + c0;
  int32_t* stage_id = reinterpret_cast<int32_t*>(stage + kRows * W);
  if (vec) {
    const int q = n >> 2;                     // 16-byte pieces per row
    for (int i = lane; i < (kRows + 1) * q; i += P) {
      const int row = i / q;
      const int col = (i - row * q) << 2;
      if (row < kRows)
        cp_async16(stage + row * W + col, src + static_cast<int64_t>(row) * C
                                              + col);
      else
        cp_async16(stage_id + col, src_id + col);
    }
  } else {
    for (int i = lane; i < (kRows + 1) * n; i += P) {
      const int row = i / n;
      const int col = i - row * n;
      if (row < kRows)
        cp_async4(stage + row * W + col, src + static_cast<int64_t>(row) * C
                                             + col);
      else
        cp_async4(stage_id + col, src_id + col);
    }
  }
}

__global__ void dense_stream_kernel(
    const int32_t* __restrict__ ids,       // (Tl, M) shortlist cluster ids
    const int32_t* __restrict__ counts,    // (Tl,) valid slots per tile
    const float* __restrict__ entries,     // (Tl, M) ascending entry t
    const float* __restrict__ rays,        // (Tl, 8, P) o, d, mask, cap
    const float* __restrict__ packed,      // (K+1, 12, C) BW rows
    const int32_t* __restrict__ tri,       // (K+1, C) triangle ids
    const float* __restrict__ boxes,       // (K+1, 6) lo.xyz, hi.xyz
    float* __restrict__ t_out,             // (Tl, P)
    int32_t* __restrict__ tri_out,         // (Tl, P)
    int M, int C, int W, int vec) {
  extern __shared__ float smem[];          // kStages * (kRows + 1) * W
  const int P = blockDim.x;
  const int lane = threadIdx.x;
  const int64_t tile = blockIdx.x;
  float t;
  int32_t best = -1;
  const bwfold::Ray r = bwfold::load_ray(rays, tile, P, lane, &t);
  const int32_t* sl = ids + tile * M;
  const float* ent = entries + tile * M;
  const int nch = (C + W - 1) / W;         // chunks per cluster
  const int stage_words = (kRows + 1) * W;
  const int cnt = counts[tile];

  for (int g0 = 0; g0 < cnt; g0 += kGroup) {
    // K1's exit vote at the group's first slot; as a barrier it also
    // ends every thread's reads of the ring before the group refills it
    if (!__syncthreads_or(r.live && t >= ent[g0])) break;
    const int gn = min(kGroup, cnt - g0);
    unsigned fetch = 0;                    // gated-in slots of the group
    for (int j = 0; j < gn; ++j) {
      const float* b = boxes + static_cast<int64_t>(sl[g0 + j]) * 6;
      if (__syncthreads_or(bwfold::box_gate(b, r, t))) fetch |= 1u << j;
    }
    const int total = __popc(fetch) * nch;

    // producer cursor: chunk ic of slot g0 + (lowest bit of im)
    unsigned im = fetch;
    int ic = 0;
    auto start = [&](int q) {
      const int j = __ffs(im) - 1;
      const int c0 = ic * W;
      start_chunk(smem + (q % kStages) * stage_words, W, packed, tri,
                  sl[g0 + j], C, c0, min(W, C - c0), vec != 0, lane, P);
      if (++ic == nch) {
        ic = 0;
        im &= im - 1;
      }
    };
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < total) start(q);
      cp_async_commit();                   // one group per chunk, or empty
    }

    // consumer cursor: chunk cc of slot g0 + (lowest bit of cm)
    unsigned cm = fetch;
    int cc = 0;
    bool pass = false, any = false, stop = false;
    for (int q = 0; q < total; ++q) {
      const int s = g0 + __ffs(cm) - 1;
      if (cc == 0) {
        // K1's exit vote and gate at this slot, with the current t
        if (!__syncthreads_or(r.live && t >= ent[s])) {
          stop = true;
          break;
        }
        pass = bwfold::box_gate(boxes + static_cast<int64_t>(sl[s]) * 6, r,
                                t);
        any = __syncthreads_or(pass);
      }
      // groups committed: kStages - 1 + q; chunk q is group q
      cp_async_wait<kStages - 2>();
      __syncthreads();   // chunk q visible; everyone is done with q - 1
      if (q + kStages - 1 < total) start(q + kStages - 1);
      cp_async_commit();
      if (any && pass) {
        const float* stage = smem + (q % kStages) * stage_words;
        bwfold::bw_fold(stage, reinterpret_cast<const int32_t*>(
                                   stage + kRows * W),
                        W, min(W, C - cc * W), r, t, best);
      }
      if (++cc == nch) {
        cc = 0;
        cm &= cm - 1;
      }
    }
    cp_async_wait_all();                   // no copy outlives its group
    if (stop) break;
  }
  t_out[tile * P + lane] = t;
  tri_out[tile * P + lane] = best;
}

}  // namespace

extern "C" int dense_stream_launch(
    const void* ids, const void* counts, const void* entries,
    const void* rays, const void* packed, const void* tri, const void* boxes,
    void* t_out, void* tri_out, int Tl, int M, int P, int C, int vec,
    void* stream) {
  const int W = C < kChunk ? C : kChunk;
  const size_t smem = static_cast<size_t>(kStages) * (kRows + 1) * W
                      * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dense_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_stream_kernel<<<Tl, P, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(counts),
      static_cast<const float*>(entries), static_cast<const float*>(rays),
      static_cast<const float*>(packed), static_cast<const int32_t*>(tri),
      static_cast<const float*>(boxes), static_cast<float*>(t_out),
      static_cast<int32_t*>(tri_out), M, C, W, vec);
  return static_cast<int>(cudaGetLastError());
}
