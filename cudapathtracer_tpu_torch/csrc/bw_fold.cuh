// Device functions shared by the three dense cluster kernels (K1
// dense_resident.cu, K2 dense.cu, K3 dense_super.cu): the ray's state, the
// per-ray cluster box gate, the synchronous staging of one cluster into
// shared memory and the Baldwin-Weber closest-hit fold.
//
// All three kernels fold through the same function, built with -fmad=false,
// so they round alike: the fold forms, with __fmaf_rn, exactly the fused
// multiply-adds that XLA forms for the JAX package's formulas, the plain
// PyTorch version (ops/kernels/dense_resident.py) emulates them exactly, and
// the compiler fuses nothing else.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bwfold {

constexpr float kMaxFloat = 100000.0f;       // reference miss sentinel
constexpr float kEpsParallel = 1e-5f;        // modelLoader.h:64
constexpr float kMaskedInit = -3.0e38f;      // masked lanes never update
constexpr int kRows = 12;                    // n, v0, m1, m2 (xyz each)

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float idx, idy, idz;                       // guarded reciprocals of d
  bool live;
};

__device__ __forceinline__ float guarded_inv(float d) {
  // a zero direction component would give 0*inf = NaN in the slab test,
  // whose comparisons are false: the gate would skip a plausible cluster
  float g = fabsf(d) < 1e-30f ? (d < 0.0f ? -1e-30f : 1e-30f) : d;
  return 1.0f / g;
}

// Ray `lane` of tile `tile` from the (Tl, 8, P) block [o, d, mask, cap];
// *t gets the fold's init: min(cap, MAX_FLOAT) for live lanes, -3e38 for
// masked ones.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int64_t tile, int P, int lane,
                                        float* t) {
  const float* r = rays + tile * 8 * P;
  Ray ray;
  ray.ox = r[0 * P + lane];
  ray.oy = r[1 * P + lane];
  ray.oz = r[2 * P + lane];
  ray.dx = r[3 * P + lane];
  ray.dy = r[4 * P + lane];
  ray.dz = r[5 * P + lane];
  ray.live = r[6 * P + lane] > 0.5f;
  const float cap = r[7 * P + lane];
  *t = ray.live ? (cap < kMaxFloat ? cap : kMaxFloat) : kMaskedInit;
  ray.idx = guarded_inv(ray.dx);
  ray.idy = guarded_inv(ray.dy);
  ray.idz = guarded_inv(ray.dz);
  return ray;
}

// A live ray whose slab interval meets box b = [lo.xyz, hi.xyz] at or
// before its best t. Monotone in t: a gate that fails at t fails at any
// smaller t, which lets K2 gate ahead with a t that is not yet final.
__device__ __forceinline__ bool box_gate(const float* __restrict__ b,
                                         const Ray& r, float t) {
  const float tx0 = (b[0] - r.ox) * r.idx, tx1 = (b[3] - r.ox) * r.idx;
  const float ty0 = (b[1] - r.oy) * r.idy, ty1 = (b[4] - r.oy) * r.idy;
  const float tz0 = (b[2] - r.oz) * r.idz, tz1 = (b[5] - r.oz) * r.idz;
  const float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1));
  const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fmaxf(tz0, tz1));
  return r.live && tmin <= tmax && tmax >= 0.0f && tmin <= t;
}

// Copy cluster sid's 12 BW rows and C ids into shared memory, all threads
// of the block together (the caller synchronises before reading).
__device__ __forceinline__ void stage_cluster(
    float* cl, int32_t* cl_id, const float* __restrict__ packed,
    const int32_t* __restrict__ tri, int sid, int C, int lane, int P) {
  const float* src = packed + static_cast<int64_t>(sid) * kRows * C;
  for (int i = lane; i < kRows * C; i += P) cl[i] = src[i];
  const int32_t* src_id = tri + static_cast<int64_t>(sid) * C;
  for (int i = lane; i < C; i += P) cl_id[i] = src_id[i];
}

// Fold n triangles into (t, best): row k of triangle c is cl[k * ld + c].
// Keeps the lexicographic minimum of (t, id), i.e. exact-t ties go to the
// lower triangle id.
__device__ __forceinline__ void bw_fold(const float* cl,
                                        const int32_t* cl_id, int ld, int n,
                                        const Ray& r, float& t,
                                        int32_t& best) {
  for (int c = 0; c < n; ++c) {
    const float nx = cl[0 * ld + c], ny = cl[1 * ld + c];
    const float nz = cl[2 * ld + c];
    const float sx = r.ox - cl[3 * ld + c], sy = r.oy - cl[4 * ld + c];
    const float sz = r.oz - cl[5 * ld + c];
    // a.x*b.x + a.y*b.y + a.z*b.z as fma(a.z, b.z, fma(a.x, b.x, a.y*b.y))
    // and s + d*t as fma(d, t, s): the fused multiply-adds that XLA forms
    // for the reference's formulas (ops/vecmath.py)
    const float nd = __fmaf_rn(r.dz, nz, __fmaf_rn(r.dx, nx, r.dy * ny));
    const bool parallel = fabsf(nd) < kEpsParallel;
    const float inv = 1.0f / nd;
    const float tt = -__fmaf_rn(sz, nz, __fmaf_rn(sx, nx, sy * ny)) * inv;
    const float wx = __fmaf_rn(r.dx, tt, sx);
    const float wy = __fmaf_rn(r.dy, tt, sy);
    const float wz = __fmaf_rn(r.dz, tt, sz);
    const float bu = __fmaf_rn(cl[8 * ld + c], wz,
                               __fmaf_rn(cl[6 * ld + c], wx,
                                         cl[7 * ld + c] * wy));
    const float bv = __fmaf_rn(cl[11 * ld + c], wz,
                               __fmaf_rn(cl[9 * ld + c], wx,
                                         cl[10 * ld + c] * wy));
    const float bw = 1.0f - bu - bv;
    // all-zero padding and sentinel triangles have n = 0: parallel
    const bool reject = parallel || bu < 0.0f || bv < 0.0f || bw < 0.0f
                        || tt <= 0.0f;
    const float ts = reject ? kMaxFloat : tt;
    const int32_t id = cl_id[c];
    if (ts < t || (ts == t && id < best)) {
      t = ts;
      best = id;
    }
  }
}

}  // namespace bwfold
