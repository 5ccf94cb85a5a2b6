// The gated, triangle-stationary fold shared by the dense cluster kernels:
// the closest hit of every ray of a tile over its entry-sorted shortlist.
// gated_tile is the code of all three kernels, K1
// (dense_resident.cu), K2 (dense.cu) and K3 (dense_super.cu): a slot is a
// super of F clusters consecutive in preorder (member sid =
// min(slot * F + j, K)); K1 and K2 are the case F = 1. The whole block
// votes, gates and folds each member together. K2 and K3 run a block per
// tile; K1 runs blocks of at most 128 rays of a tile.
//
// Rays own the control flow: thread i holds ray i, takes the exit vote at
// every slot (t >= entry) and gates each member's box against its own best
// t. What differs from a ray-stationary fold is who folds:
//   * compaction: the rays that pass a member's gate are appended to a list
//     in shared memory (ballot), each entry its o, d, t at the member's start
//     and its index. A member no ray passes costs no fold;
//   * triangle-stationary fold: thread c takes triangle c of the member
//     straight into registers (coalesced: the pack's rows are SoA, (K+1,
//     rows, C)), then tests it against every listed ray, reading each ray
//     with two 16-byte broadcast loads from shared memory; the threads
//     stride over the C triangles in rounds. Work per folded member is
//     n_pass * C tests, not 32 * C per warp that holds one passing ray, and
//     a test needs 2 shared loads, not 13. The next round's triangle is
//     loaded before this round's tests (a register double buffer), and the
//     first round's before the list is complete;
//   * padding triangles (the sentinel row's id T with all-zero rows: a zero
//     normal, or zero edges) are skipped: their test always rejects, and T,
//     the largest id, never wins a tie. Where a third of a cluster is
//     padding (C = 256 at colonnade subdiv 3 and 5) this spares whole
//     warps, whose 1 / 0 would take the IEEE division's slow path in every
//     test;
//   * the closest hit is an exact 64-bit atomicMin in shared memory on each
//     ray's key (fold_key): the key's signed order is the lexicographic
//     order of (t, id), so the minimum is what a sequential
//     ts < t || (ts == t && id < best) computes from (cap, -1), whatever
//     order the tests run in. A thread reads the ray's t at the member's
//     start and does the atomic only where its ts could win;
//   * supers (F > 1): each ray gates all F members at the super's start,
//     one block-wide OR of those masks names the members to visit, and a
//     ray whose t fell since then (it folded a member) gates again before
//     the next member. The gate is monotone in t, so every
//     member is folded for exactly the rays whose gate passes at their
//     current t, in member order: what member-by-member gating folds.
// The triangle test is a policy (BW, MT below: its rows, their load, the
// padding skip and the test), picked per call by the pack's row count; the
// visibility and counting flags are orthogonal to it, and each kernel
// compiles the eight instances.
// Occupancy: the wrappers build it with at most 64 registers a thread
// (ops/kernels/dense_resident.py:GATED_FOLD_FLAGS), so an SM holds 1024
// threads; uncapped, K3 took 82 and fit two blocks of 256 on an SM, and ran
// 1.3-1.7x slower, and K1 1.2-1.3x (tools/time_kernels.py, one H100
// 80GB HBM3, 700 W).
//
// Members are folded in order and gated with the t each ray has after the
// previous one, so every ray folds exactly the clusters whose gate it passes
// at its t, and the result is the plain fold's bit for bit. A block ends at
// the first slot whose entry no live ray of it reaches.
//
// The member ids and boxes and the slots' entries are staged in shared
// memory kChunk members at a time, so a slot's gates and exit vote wait on
// no load from device memory. Barriers: one per slot (the exit vote,
// which also publishes the member mask), one per visited member (the list),
// one per folded member (the keys) and two per chunk. The list lengths and
// member masks rotate through three words, so each word is reset by thread 0
// while no thread can still read or write it. Thread c takes triangles c,
// c + B, ... of a member, so with B = C the padding at a cluster's end falls
// to whole warps that skip their tests and wait at the keys' barrier (46% of
// the cycles at C = P = 256); blocks of 128 rays spread it over the rounds.
//
// Visibility instance (kVis, selected per call where vis_band > 0; the
// closest-hit instance is compiled without it): the JAX package's _vis_drop
// (ops/pallas/dense_resident.py:330-347). Each ray holds the floor
// lo = cap - vis_band, cap from row 7 of its ray block. After each member's
// merge, a ray that folded the member and whose t fell below lo is occluded
// whatever the rest of its shortlist holds: it sets t = -3e38, which
// retires it, since its gates (tmin <= t) and its exit vote (t >= entry)
// fail from then on. Its id stays the occluder found then, which depends on
// the schedule; on output a t below lo (a retired ray, or one whose init was
// already below its floor) is -3e38, so the t written is the same for every
// schedule: -3e38 exactly where the closest hit lies below the floor.
//
// Counting instance (kCount, for measurements only; the timed instance is
// compiled without it): per tile, into counts_out (Tl, kCountCols), which
// the caller zeroes:
//   0: members folded, summed over the tile's blocks that fold each;
//   1: lane tests issued, 32 * n_pass for every round of a warp that holds
//      a triangle it tests (a warp that runs n_pass tests issues 32 *
//      n_pass, used or not);
//   2-6: clock64() cycles of each phase, summed over the tile's warps
//      (lane 0 of each): the gates and exit votes (chunk staging included),
//      the list (compaction up to its barrier), the wait for the member's
//      first triangle after that barrier, the tests, and the barrier after
//      them (the key merge).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bw_fold.cuh"

namespace gfold {

constexpr int kCountCols = 7;
enum Phase { kGateVote, kList, kWait, kTests, kMerge, kPhases };

// The counting instance's phase clocks: mark(p) adds the cycles since the
// last mark to phase p. Compiled away where kOn is false.
template <bool kOn>
struct Spans {
  long long acc[kPhases] = {};
  long long last = 0;
  __device__ __forceinline__ void start() {
    if (kOn) last = clock64();
  }
  __device__ __forceinline__ void mark(int p) {
    if (kOn) {
      const long long now = clock64();
      acc[p] += now - last;
      last = now;
    }
  }
  // lane 0 of each warp adds its warp's cycles to the tile's row
  __device__ __forceinline__ void flush(long long* row, int wl) {
    if (kOn && wl == 0)
      for (int p = 0; p < kPhases; ++p)
        atomicAdd(reinterpret_cast<unsigned long long*>(row + 2 + p),
                  static_cast<unsigned long long>(acc[p]));
  }
};

// (t, id) -> one 64-bit integer whose signed order is the lexicographic
// order of (t, id). High word: t's bits, the low 31 flipped for negative t,
// so the words order as the floats (for t >= 0 they are t's bits); low
// word: id + 1, unsigned, so the init's -1 lies below every id.
__device__ __forceinline__ long long fold_key(float t, int32_t id) {
  const int b = __float_as_int(t);
  const unsigned hi = static_cast<unsigned>(b ^ ((b >> 31) & 0x7fffffff));
  return static_cast<long long>(
      (static_cast<unsigned long long>(hi) << 32)
      | static_cast<unsigned>(id + 1));
}

__device__ __forceinline__ float key_t(long long k) {
  const int hi = static_cast<int>(static_cast<unsigned long long>(k) >> 32);
  return __int_as_float(hi ^ ((hi >> 31) & 0x7fffffff));
}

__device__ __forceinline__ int32_t key_id(long long k) {
  return static_cast<int32_t>(static_cast<unsigned>(k)) - 1;
}

// The triangle tests as policies of the fold. Each gives its triangle
// type, its rows in the pack, the load of triangle c of a cluster whose
// rows start at `rows` (row k at k * C, through the read-only cache), the
// sum of its fields (the counting instance's wait span), the padding skip
// (the sentinel id T with rows on which the test rejects whatever the ray)
// and the test.
struct BW {                      // rows n, v0, m1, m2
  using Tri = bwfold::Tri;
  static constexpr int kRows = 12;
  static __device__ __forceinline__ Tri load(const float* __restrict__ rows,
                                             int C, int c) {
    Tri q;
    q.nx = __ldg(rows + 0 * C + c);
    q.ny = __ldg(rows + 1 * C + c);
    q.nz = __ldg(rows + 2 * C + c);
    q.vx = __ldg(rows + 3 * C + c);
    q.vy = __ldg(rows + 4 * C + c);
    q.vz = __ldg(rows + 5 * C + c);
    q.ax = __ldg(rows + 6 * C + c);
    q.ay = __ldg(rows + 7 * C + c);
    q.az = __ldg(rows + 8 * C + c);
    q.bx = __ldg(rows + 9 * C + c);
    q.by = __ldg(rows + 10 * C + c);
    q.bz = __ldg(rows + 11 * C + c);
    return q;
  }
  static __device__ __forceinline__ float sum(const Tri& q) {
    return q.nx + q.ny + q.nz + q.vx + q.vy + q.vz + q.ax + q.ay + q.az
           + q.bx + q.by + q.bz;
  }
  // n = 0: n . d = 0, parallel
  static __device__ __forceinline__ bool is_pad(const Tri& q, int32_t id,
                                                int32_t pad) {
    return id == pad && q.nx == 0.0f && q.ny == 0.0f && q.nz == 0.0f;
  }
  static __device__ __forceinline__ float test(const Tri& q, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz) {
    return bwfold::bw_test(q, ox, oy, oz, dx, dy, dz);
  }
};

struct MT {                      // rows v0, e1, e2
  using Tri = bwfold::TriMT;
  static constexpr int kRows = 9;
  static __device__ __forceinline__ Tri load(const float* __restrict__ rows,
                                             int C, int c) {
    Tri q;
    q.vx = __ldg(rows + 0 * C + c);
    q.vy = __ldg(rows + 1 * C + c);
    q.vz = __ldg(rows + 2 * C + c);
    q.ax = __ldg(rows + 3 * C + c);
    q.ay = __ldg(rows + 4 * C + c);
    q.az = __ldg(rows + 5 * C + c);
    q.bx = __ldg(rows + 6 * C + c);
    q.by = __ldg(rows + 7 * C + c);
    q.bz = __ldg(rows + 8 * C + c);
    return q;
  }
  static __device__ __forceinline__ float sum(const Tri& q) {
    return q.vx + q.vy + q.vz + q.ax + q.ay + q.az + q.bx + q.by + q.bz;
  }
  // e1 = e2 = 0: a = e1 . (d x e2) = 0, parallel
  static __device__ __forceinline__ bool is_pad(const Tri& q, int32_t id,
                                                int32_t pad) {
    return id == pad && q.ax == 0.0f && q.ay == 0.0f && q.az == 0.0f
           && q.bx == 0.0f && q.by == 0.0f && q.bz == 0.0f;
  }
  static __device__ __forceinline__ float test(const Tri& q, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz) {
    return bwfold::mt_test(q, ox, oy, oz, dx, dy, dz);
  }
};

// The counting instance's wait span ends here: a use of every field of q
// (and of id) that the compiler cannot drop, so the thread waits until its
// triangle's loads have landed. The store never happens (ids are >= 0).
template <class Test>
__device__ __forceinline__ void await_tri(const typename Test::Tri& q,
                                          int32_t id, long long* sink) {
  const float s = Test::sum(q);
  if (id == INT32_MIN && __float_as_int(s) == 0x7fbfffff) *sink = -1;
}

// Members whose ids and boxes are staged in shared memory together, with
// their slots' entries: kChunk / F slots at a time.
constexpr int kChunk = 256;

__host__ __device__ inline int chunk_slots(int F) {
  return F < kChunk ? kChunk / F : 1;
}

// Dynamic shared memory of a block of P rays: the keys, the two halves of
// the ray list, a chunk's member boxes, member ids and slot entries, three
// list lengths and three member masks.
inline size_t shared_bytes(int P, int F) {
  return static_cast<size_t>(P) * (sizeof(long long) + 2 * sizeof(float4))
         + kChunk * 7 * sizeof(float) + chunk_slots(F) * sizeof(float)
         + 6 * sizeof(int);
}

// Fold the n listed rays against a member's C triangles by Test, thread
// `lane` taking triangles lane, lane + P, ...; (q, id) is its first
// triangle, already loaded, and `pad` the padding triangles' id. -> the
// lane tests its warp issued (kCount only).
template <class Test, bool kCount>
__device__ __forceinline__ long long fold_listed(
    typename Test::Tri q, int32_t id, const float* __restrict__ rows,
    const int32_t* __restrict__ tid, int C, int P, int lane, int n,
    int32_t pad, const float4* ray_a, const float4* ray_b, long long* key) {
  long long issued = 0;
  for (int c = lane; c - lane < C; c += P) {
    typename Test::Tri qn = q;
    int32_t idn = 0;
    if (c + P < C) {              // next round's triangle, ahead of the tests
      qn = Test::load(rows, C, c + P);
      idn = __ldg(tid + c + P);
    }
    const bool test = c < C && !Test::is_pad(q, id, pad);
    if (kCount && __ballot_sync(0xffffffffu, test)) issued += 32LL * n;
    if (test) {
#pragma unroll 2
      for (int k = 0; k < n; ++k) {
        const float4 a = ray_a[k];      // o.xyz, d.x
        const float4 b = ray_b[k];      // d.y, d.z, t at start, index
        const float ts = Test::test(q, a.x, a.y, a.z, a.w, b.x, b.y);
        if (ts <= b.z) atomicMin(&key[__float_as_int(b.w)], fold_key(ts, id));
      }
    }
    q = qn;
    id = idn;
  }
  return issued;
}

// Which rays a block folds: tile blockIdx.x / (P / B) of P rays, its B =
// blockDim.x rays from r0 = (blockIdx.x % (P / B)) * B on. K2 and K3 run a
// block per tile (B = P); K1 may split a tile into blocks of B rays, each
// with its own votes, gates and folds over the tile's whole shortlist.
struct Part {
  int64_t tile;
  int r0;
};

__device__ __forceinline__ Part block_part(int P) {
  const int subs = P / static_cast<int>(blockDim.x);
  return {static_cast<int64_t>(blockIdx.x / subs),
          static_cast<int>(blockIdx.x % subs) * static_cast<int>(blockDim.x)};
}

// One block of B = blockDim.x rays of a tile of P, testing by Test.
template <class Test, bool kCount, bool kVis>
__device__ __forceinline__ void gated_tile(
    const int32_t* __restrict__ ids,       // (Tl, M) shortlist slot ids
    const int32_t* __restrict__ counts,    // (Tl,) valid slots per tile
    const float* __restrict__ entries,     // (Tl, M) ascending entry t
    const float* __restrict__ rays,        // (Tl, 8, P) o, d, mask, cap
    const float* __restrict__ packed,      // (K+1, Test::kRows, C) rows
    const int32_t* __restrict__ tri,       // (K+1, C) triangle ids
    const float* __restrict__ boxes,       // (K+1, 6) lo.xyz, hi.xyz
    float* __restrict__ t_out,             // (Tl, P)
    int32_t* __restrict__ tri_out,         // (Tl, P)
    long long* __restrict__ counts_out,    // (Tl, kCountCols) or null
    int M, int P, int C, int F, int K, float vis_band) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = blockDim.x;
  const int lane = threadIdx.x;
  const int wl = lane & 31;
  const Part part = block_part(P);
  const int64_t tile = part.tile;
  const int G = chunk_slots(F);
  long long* key = reinterpret_cast<long long*>(smem);       // (B,)
  float4* ray_a = reinterpret_cast<float4*>(key + B);        // (B,) list
  float4* ray_b = ray_a + B;                                 // (B,) list
  float* box_s = reinterpret_cast<float*>(ray_b + B);        // (G * F, 6)
  int* sid_s = reinterpret_cast<int*>(box_s + kChunk * 6);   // (G * F,)
  float* ent_s = reinterpret_cast<float*>(sid_s + kChunk);   // (G,)
  int* n_list = reinterpret_cast<int*>(ent_s + G);           // [3]
  unsigned* cand = reinterpret_cast<unsigned*>(n_list + 3);  // [3]
  long long* row = kCount ? counts_out + tile * kCountCols : nullptr;
  Spans<kCount> sp;

  float t;
  int32_t best = -1;
  const bwfold::Ray r = bwfold::load_ray(rays, tile, P, part.r0 + lane, &t);
  // the visibility floor: the ray is occluded once its t is below it
  const float lo =
      kVis ? rays[tile * 8 * P + 7 * P + part.r0 + lane] - vis_band : 0.0f;
  key[lane] = fold_key(t, best);
  if (lane < 3) {
    n_list[lane] = 0;
    cand[lane] = 0u;
  }
  __syncthreads();

  const int32_t* sl = ids + tile * M;
  const float* ent = entries + tile * M;
  const unsigned below = (1u << wl) - 1u;
  const int32_t pad = __ldg(tri + static_cast<int64_t>(K) * C);
  long long folded = 0, issued = 0;
  int epoch = 0;                 // list barriers so far
  const int cnt = counts[tile];
  sp.start();
  for (int s = 0; s < cnt; ++s) {
    const int g = s % G;
    if (g == 0) {
      // stage the next chunk's member ids and boxes and its slots' entries,
      // so that a slot's gates wait on no load from device memory
      __syncthreads();           // every thread is done with the last chunk
      const int ns = min(G, cnt - s);
      for (int i = lane; i < ns * F * 6; i += B) {
        const int m = i / 6;
        const int64_t mid = static_cast<int64_t>(sl[s + m / F]) * F + m % F;
        const int64_t sid = mid < K ? mid : K;
        box_s[i] = __ldg(boxes + sid * 6 + (i - m * 6));
        if (i == m * 6) sid_s[m] = static_cast<int>(sid);
      }
      for (int i = lane; i < ns; i += B) ent_s[i] = ent[s + i];
      __syncthreads();
    }
    const float* bx = box_s + g * F * 6;
    const int* sids = sid_s + g * F;
    unsigned mine = 0u;          // this ray's member gates at its current t
    for (int j = 0; j < F; ++j)
      if (bwfold::box_gate(bx + j * 6, r, t)) mine |= 1u << j;
    const unsigned warp_mine = __reduce_or_sync(0xffffffffu, mine);
    if (wl == 0 && warp_mine) atomicOr(&cand[s % 3], warp_mine);
    if (lane == 0) cand[(s + 1) % 3] = 0u;
    // the exit vote; as a barrier it also publishes the member mask
    if (!__syncthreads_or(r.live && t >= ent_s[g])) break;
    sp.mark(kGateVote);
    unsigned todo = cand[s % 3];
    bool refold = false;         // t fell since `mine`: gate again
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int64_t sid = sids[j];
      bool pass = (mine >> j) & 1u;
      if (pass && refold) pass = bwfold::box_gate(bx + j * 6, r, t);
      const float* rows = packed + sid * Test::kRows * C;
      const int32_t* tid = tri + sid * C;
      typename Test::Tri q = {};
      int32_t id = 0;
      if (lane < C) {            // the first round's triangle, ahead
        q = Test::load(rows, C, lane);
        id = __ldg(tid + lane);
      }
      const unsigned bal = __ballot_sync(0xffffffffu, pass);
      int base = 0;
      if (wl == 0 && bal) base = atomicAdd(&n_list[epoch % 3], __popc(bal));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (pass) {
        const int pos = base + __popc(bal & below);
        ray_a[pos] = make_float4(r.ox, r.oy, r.oz, r.dx);
        ray_b[pos] = make_float4(r.dy, r.dz, t, __int_as_float(lane));
      }
      if (lane == 0) n_list[(epoch + 1) % 3] = 0;
      __syncthreads();           // the list is complete
      const int n = n_list[epoch % 3];
      ++epoch;
      sp.mark(kList);
      if (n == 0) continue;
      if (kCount) {
        await_tri<Test>(q, id, row);
        sp.mark(kWait);
      }
      issued += fold_listed<Test, kCount>(q, id, rows, tid, C, B, lane, n,
                                          pad, ray_a, ray_b, key);
      sp.mark(kTests);
      __syncthreads();           // every key is final for this member
      sp.mark(kMerge);
      if (pass) {
        const long long k = key[lane];
        t = key_t(k);
        best = key_id(k);
        refold = true;
        if (kVis && t < lo) t = bwfold::kMaskedInit;   // occluded: retire
      }
      if (kCount) folded += 1;
    }
  }
  if (kVis && t < lo) t = bwfold::kMaskedInit;
  t_out[tile * P + part.r0 + lane] = t;
  tri_out[tile * P + part.r0 + lane] = best;
  if (kCount) {
    if (lane == 0 && folded)
      atomicAdd(reinterpret_cast<unsigned long long*>(row),
                static_cast<unsigned long long>(folded));
    if (wl == 0 && issued)
      atomicAdd(reinterpret_cast<unsigned long long*>(row + 1),
                static_cast<unsigned long long>(issued));
    sp.flush(row, wl);
  }
}

}  // namespace gfold
