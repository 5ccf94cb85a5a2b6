// Device functions shared by the three dense cluster kernels (K1
// dense_resident.cu, K2 dense.cu, K3 dense_super.cu): the ray's state, the
// per-ray cluster box gate and the two tests of one ray against one
// triangle, Baldwin-Weber (bw_test, on the precomputed rows n, v0, m1, m2)
// and Moller-Trumbore (mt_test, on v0, e1, e2: the reference's own test,
// modelLoader.h:49-123).
//
// Every kernel tests through these, built with -fmad=false, so they round
// alike: each test forms, with __fmaf_rn, exactly the fused multiply-adds
// that XLA forms for the JAX package's formulas, the plain PyTorch version
// (ops/kernels/dense_resident.py) emulates them exactly, and the compiler
// fuses nothing else. All three fold through gated_fold.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bwfold {

constexpr float kMaxFloat = 100000.0f;       // reference miss sentinel
constexpr float kEpsParallel = 1e-5f;        // modelLoader.h:64
constexpr float kMaskedInit = -3.0e38f;      // masked lanes never update

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

// One triangle's 12 Baldwin-Weber rows: n, v0, m1, m2.
struct Tri {
  float nx, ny, nz, vx, vy, vz, ax, ay, az, bx, by, bz;
};

// The ray's hit distance on triangle q, or MAX_FLOAT where it misses.
__device__ __forceinline__ float bw_test(const Tri& q, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz) {
  const float sx = ox - q.vx, sy = oy - q.vy, sz = oz - q.vz;
  // a.x*b.x + a.y*b.y + a.z*b.z as fma(a.z, b.z, fma(a.x, b.x, a.y*b.y))
  // and s + d*t as fma(d, t, s): the fused multiply-adds that XLA forms
  // for the reference's formulas (ops/vecmath.py)
  const float nd = __fmaf_rn(dz, q.nz, __fmaf_rn(dx, q.nx, dy * q.ny));
  const bool parallel = fabsf(nd) < kEpsParallel;
  const float inv = 1.0f / nd;
  const float tt = -__fmaf_rn(sz, q.nz, __fmaf_rn(sx, q.nx, sy * q.ny)) * inv;
  const float wx = __fmaf_rn(dx, tt, sx);
  const float wy = __fmaf_rn(dy, tt, sy);
  const float wz = __fmaf_rn(dz, tt, sz);
  const float bu = __fmaf_rn(q.az, wz, __fmaf_rn(q.ax, wx, q.ay * wy));
  const float bv = __fmaf_rn(q.bz, wz, __fmaf_rn(q.bx, wx, q.by * wy));
  const float bw = 1.0f - bu - bv;
  // all-zero padding and sentinel triangles have n = 0: parallel
  const bool reject = parallel || bu < 0.0f || bv < 0.0f || bw < 0.0f
                      || tt <= 0.0f;
  return reject ? kMaxFloat : tt;
}

// One triangle's 9 Moller-Trumbore rows: v0, e1 = v1 - v0, e2 = v2 - v0.
struct TriMT {
  float vx, vy, vz, ax, ay, az, bx, by, bz;
};

// The ray's hit distance on triangle q by Moller-Trumbore (the JAX
// package's _mt_fold_pc, dense_resident.py:198-247), or MAX_FLOAT where it
// misses. Its fused multiply-adds are XLA's for those formulas, which are
// ops/vecmath.py's cross and dot: a.y*b.z - a.z*b.y as
// fma(a.y, b.z, -(a.z*b.y)), a dot as fma(a.z, b.z, fma(a.x, b.x, a.y*b.y)).
// 1/a is unguarded: where |a| < EPS_PARALLEL the lane rejects, and a NaN
// from a = 0 never escapes a comparison.
__device__ __forceinline__ float mt_test(const TriMT& q, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz) {
  // q = d x e2
  const float px = __fmaf_rn(dy, q.bz, -(dz * q.by));
  const float py = __fmaf_rn(dz, q.bx, -(dx * q.bz));
  const float pz = __fmaf_rn(dx, q.by, -(dy * q.bx));
  const float a = __fmaf_rn(q.az, pz, __fmaf_rn(q.ax, px, q.ay * py));
  const bool parallel = fabsf(a) < kEpsParallel;
  const float inv_a = 1.0f / a;
  // s = (o - v0) / a, r = s x e1
  const float sx = (ox - q.vx) * inv_a;
  const float sy = (oy - q.vy) * inv_a;
  const float sz = (oz - q.vz) * inv_a;
  const float rx = __fmaf_rn(sy, q.az, -(sz * q.ay));
  const float ry = __fmaf_rn(sz, q.ax, -(sx * q.az));
  const float rz = __fmaf_rn(sx, q.ay, -(sy * q.ax));
  const float b0 = __fmaf_rn(sz, pz, __fmaf_rn(sx, px, sy * py));
  const float b1 = __fmaf_rn(rz, dz, __fmaf_rn(rx, dx, ry * dy));
  const float b2 = 1.0f - b0 - b1;
  const float t = __fmaf_rn(q.bz, rz, __fmaf_rn(q.bx, rx, q.by * ry));
  // all-zero padding and sentinel triangles have e1 = e2 = 0: a = 0
  const bool reject = parallel || b0 < 0.0f || b1 < 0.0f || b2 < 0.0f
                      || t <= 0.0f;
  return reject ? kMaxFloat : t;
}

}  // namespace bwfold
