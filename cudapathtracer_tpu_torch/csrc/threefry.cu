// Threefry-2x32: one launch for each call of ops/rng.py (fold_in, uniform,
// uniform_site, uniform_sites, split, the draws of randint, uniform_1),
// bit for bit the int64 code that serves CPU tensors
// (ops/kernels/threefry.py:threefry_plain), and so jax.random's bits.
//
// Replaces no Pallas kernel. The JAX package hashes inside its jitted glue,
// and XLA fuses the whole hash there into the surrounding fusion. Eager
// PyTorch has no uint32 arithmetic that wraps, so the port computed it in
// int64 tensors masked with 0xFFFFFFFF: about 171 ops for one hash, each a
// launch on the card and each intermediate a full tensor in device memory.
// The hash was about 1,760 of the 2,650 glue ops of a PT+NEE sample. Over
// the 1024^2 x 6 uniforms of a bounce, every intermediate was 50 MB.
//
// What bounds it on an H100: integer work, then bytes. A hash is about 73
// int32 ops (20 rounds of add, rotate and xor; 5 key injections of 2 adds;
// the first 2 adds and the third key word), on the integer pipe's 64 ops
// a clock on each of 132 SMs (about 16.7 T ops/s at 1.98 GHz). A draw reads
// 16 bytes of key (two int64 words) and writes 4 bytes of float or 16 of
// key pair. At the largest call, 1,048,576 lanes x 6 uniforms behind one
// fold, that is 7 hashes a lane: about 32 us of integer work and 41 MB,
// 12 us at 3.35 TB/s. Every other call is smaller. All of it is under what
// the host takes to issue a call from the glue, so the design keeps every
// call to one launch and keeps the host's part short:
//   * the hash runs in registers: __funnelshift_l rotates, the rounds and
//     the key schedule unrolled, no intermediate leaves the thread;
//   * the whole chain of a call is one launch: up to two fold_in words,
//     then n counters (0, i) or one word, then what the call returns: the
//     key pair, the xor of the two words, or the float (y0 ^ y1) >> 9 |
//     0x3F800000 less 1, or 1 less that;
//   * a call that folds hashes each lane's fold chain once, in the thread
//     that then hashes that lane's n counters; a call that does not gives
//     each thread one counter (one key and 65,536 counters fill the card);
//   * the output of uniform_sites is (n, R), row by row, so each row the
//     glue reads is stride 1 and a warp's stores are coalesced;
//   * keys are read in place: int64 words through a lane stride (0 for the
//     one key that pixel_keys expands to every lane) and a word stride; a
//     fold word is read through its own stride or comes by value. Nothing
//     is expanded or copied before the launch.
// All of it is uint32 arithmetic and one float32 subtraction, which is
// exact, so the bits are those of the int64 code on every input. Built with
// the package's flags, without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks on each of 132 SMs
constexpr int kMaxFolds = 2;

// What a hash writes (ops/kernels/threefry.py names them alike).
enum Kind { kUniform = 0, kOneMinusUniform = 1, kPair = 2, kXor = 3 };

// word of lane r: the low 32 bits of p[r * stride], or value where p is null
struct Word {
  const long long* p;
  long long stride;
  unsigned value;
};

__device__ __forceinline__ unsigned word_at(const Word& w, long long r) {
  return w.p ? static_cast<unsigned>(__ldg(w.p + r * w.stride)) : w.value;
}

__device__ __forceinline__ unsigned rotl(unsigned v, int r) {
  return __funnelshift_l(v, v, r);
}

// threefry2x32 of the counter (x0, x1) under the key (k0, k1), 20 rounds:
// the schedule of jax.random's threefry (Salmon et al. 2011).
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1,
                                             unsigned& x0, unsigned& x1) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<unsigned>(i + 1);
  }
}

struct Params {
  const long long* key;  // word 0 of lane 0
  long long key_stride, word_stride;
  Word fold[kMaxFolds];
  int folds;
  Word last;     // the last hash's word, where counters is 0
  int counters;  // the last hash takes the counters (0, i), i < n
  long long lanes, n, per;  // per: counters a thread hashes
  int kind;
  int by_counter;  // out is (n, lanes) row by row, else (lanes, n)
  void* out;
};

__device__ __forceinline__ float mantissa_uniform(unsigned bits) {
  // the top 23 bits as a mantissa in [1, 2), less 1: exact
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__global__ void threefry_kernel(Params p) {
  const long long blocks_n = (p.n + p.per - 1) / p.per;
  const long long total = p.lanes * blocks_n;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += step) {
    long long r, b;
    if (blocks_n == 1) {
      r = t, b = 0;
    } else if (p.lanes == 1) {
      r = 0, b = t;
    } else if (p.by_counter) {
      r = t % p.lanes, b = t / p.lanes;
    } else {
      r = t / blocks_n, b = t % blocks_n;
    }
    const long long* kp = p.key + r * p.key_stride;
    unsigned k0 = static_cast<unsigned>(__ldg(kp));
    unsigned k1 = static_cast<unsigned>(__ldg(kp + p.word_stride));
    for (int f = 0; f < p.folds; ++f) {  // fold_in(key, word)
      unsigned x0 = 0, x1 = word_at(p.fold[f], r);
      threefry2x32(k0, k1, x0, x1);
      k0 = x0, k1 = x1;
    }
    const long long i_end = min(p.n, (b + 1) * p.per);
    for (long long i = b * p.per; i < i_end; ++i) {
      unsigned x0 = 0;
      unsigned x1 = p.counters ? static_cast<unsigned>(i)
                               : word_at(p.last, r);
      threefry2x32(k0, k1, x0, x1);
      const long long e = p.by_counter ? i * p.lanes + r : r * p.n + i;
      switch (p.kind) {
        case kUniform:
          static_cast<float*>(p.out)[e] = mantissa_uniform(x0 ^ x1);
          break;
        case kOneMinusUniform:
          static_cast<float*>(p.out)[e] = 1.0f - mantissa_uniform(x0 ^ x1);
          break;
        case kPair:
          static_cast<longlong2*>(p.out)[e] = make_longlong2(x0, x1);
          break;
        default:
          static_cast<long long*>(p.out)[e] = x0 ^ x1;
      }
    }
  }
}

}  // namespace

// One call of ops/rng.py on the stream: for each of `lanes` keys (int64
// words key[r * key_stride] and key[r * key_stride + word_stride]), fold
// in `folds` words (each a pointer to int64 words with a lane stride, or
// null and a value), then hash the counters (0, i), i < n (counters != 0),
// or the one word `last`, and write each hash as `kind` says into `out`:
// (n, lanes) where by_counter != 0, else (lanes, n); per: counters a thread
// hashes. Returns cudaGetLastError() after the launch.
extern "C" int threefry_launch(
    const void* key, long long key_stride, long long word_stride, int folds,
    const void* w0, long long w0_stride, unsigned w0_value,
    const void* w1, long long w1_stride, unsigned w1_value,
    const void* last, long long last_stride, unsigned last_value,
    int counters, long long lanes, long long n, long long per, int kind,
    int by_counter, void* out, void* stream) {
  if (lanes <= 0 || n <= 0 || per <= 0 || folds < 0 || folds > kMaxFolds ||
      kind < kUniform || kind > kXor)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.key = static_cast<const long long*>(key);
  p.key_stride = key_stride;
  p.word_stride = word_stride;
  p.fold[0] = Word{static_cast<const long long*>(w0), w0_stride, w0_value};
  p.fold[1] = Word{static_cast<const long long*>(w1), w1_stride, w1_value};
  p.folds = folds;
  p.last = Word{static_cast<const long long*>(last), last_stride,
                last_value};
  p.counters = counters;
  p.lanes = lanes;
  p.n = n;
  p.per = per;
  p.kind = kind;
  p.by_counter = by_counter;
  p.out = out;
  const long long total = lanes * ((n + per - 1) / per);
  const long long wanted = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(wanted < kMaxBlocks ? wanted
                                                          : kMaxBlocks);
  threefry_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
