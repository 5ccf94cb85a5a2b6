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
// fusing anything else, so the two round alike bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaxFloat = 100000.0f;       // reference miss sentinel
constexpr float kEpsParallel = 1e-5f;        // modelLoader.h:64
constexpr float kMaskedInit = -3.0e38f;      // masked lanes never update
constexpr int kRows = 12;                    // n, v0, m1, m2 (xyz each)

__device__ __forceinline__ float guarded_inv(float d) {
  // a zero direction component would give 0*inf = NaN in the slab test,
  // whose comparisons are false: the gate would skip a plausible cluster
  float g = fabsf(d) < 1e-30f ? (d < 0.0f ? -1e-30f : 1e-30f) : d;
  return 1.0f / g;
}

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
  const float* r = rays + tile * 8 * P;
  const float ox = r[0 * P + lane], oy = r[1 * P + lane];
  const float oz = r[2 * P + lane];
  const float dx = r[3 * P + lane], dy = r[4 * P + lane];
  const float dz = r[5 * P + lane];
  const bool live = r[6 * P + lane] > 0.5f;
  const float cap = r[7 * P + lane];
  float t = live ? (cap < kMaxFloat ? cap : kMaxFloat) : kMaskedInit;
  int32_t best = -1;
  const float idx = guarded_inv(dx), idy = guarded_inv(dy);
  const float idz = guarded_inv(dz);

  const int cnt = counts[tile];
  for (int s = 0; s < cnt; ++s) {
    if (!__syncthreads_or(live && t >= entries[tile * M + s])) break;
    const int sid = ids[tile * M + s];
    const float* b = boxes + static_cast<int64_t>(sid) * 6;
    const float tx0 = (b[0] - ox) * idx, tx1 = (b[3] - ox) * idx;
    const float ty0 = (b[1] - oy) * idy, ty1 = (b[4] - oy) * idy;
    const float tz0 = (b[2] - oz) * idz, tz1 = (b[5] - oz) * idz;
    const float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                             fminf(tz0, tz1));
    const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                             fmaxf(tz0, tz1));
    const bool pass = live && tmin <= tmax && tmax >= 0.0f && tmin <= t;
    if (!__syncthreads_or(pass)) continue;

    const float* src = packed + static_cast<int64_t>(sid) * kRows * C;
    for (int i = lane; i < kRows * C; i += P) cl[i] = src[i];
    const int32_t* src_id = tri + static_cast<int64_t>(sid) * C;
    for (int i = lane; i < C; i += P) cl_id[i] = src_id[i];
    __syncthreads();

    if (pass) {
      for (int c = 0; c < C; ++c) {
        const float nx = cl[0 * C + c], ny = cl[1 * C + c];
        const float nz = cl[2 * C + c];
        const float sx = ox - cl[3 * C + c], sy = oy - cl[4 * C + c];
        const float sz = oz - cl[5 * C + c];
        // a.x*b.x + a.y*b.y + a.z*b.z as fma(a.z, b.z, fma(a.x, b.x,
        // a.y*b.y)) and s + d*t as fma(d, t, s): the fused multiply-adds
        // that XLA forms for the reference's formulas (ops/vecmath.py)
        const float nd = __fmaf_rn(dz, nz, __fmaf_rn(dx, nx, dy * ny));
        const bool parallel = fabsf(nd) < kEpsParallel;
        const float inv = 1.0f / nd;
        const float tt =
            -__fmaf_rn(sz, nz, __fmaf_rn(sx, nx, sy * ny)) * inv;
        const float wx = __fmaf_rn(dx, tt, sx);
        const float wy = __fmaf_rn(dy, tt, sy);
        const float wz = __fmaf_rn(dz, tt, sz);
        const float bu = __fmaf_rn(cl[8 * C + c], wz,
                                   __fmaf_rn(cl[6 * C + c], wx,
                                             cl[7 * C + c] * wy));
        const float bv = __fmaf_rn(cl[11 * C + c], wz,
                                   __fmaf_rn(cl[9 * C + c], wx,
                                             cl[10 * C + c] * wy));
        const float bw = 1.0f - bu - bv;
        // all-zero padding and sentinel triangles have n = 0: parallel
        const bool reject = parallel || bu < 0.0f || bv < 0.0f
                            || bw < 0.0f || tt <= 0.0f;
        const float ts = reject ? kMaxFloat : tt;
        const int32_t id = cl_id[c];
        if (ts < t || (ts == t && id < best)) {
          t = ts;
          best = id;
        }
      }
    }
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
