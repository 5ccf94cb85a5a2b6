// FMA: the float32 fused multiply-add of ops/vecmath.py:fma, a * b + c
// rounded once (__fmaf_rn), element by element.
//
// Replaces no Pallas kernel. The JAX package writes a * b + c inside its
// jitted glue, and XLA fuses it there into the surrounding fusion with one
// rounding. Eager PyTorch has no float32 op that rounds a * b + c once, so
// the port emulated it in float64 (ops/kernels/fma.py:fma_plain: the exact
// product, a sum rounded to odd, one rounding to float32): 27 ops for each
// FMA, about 25 of them launches on the card, and the glue runs 123 FMAs a
// PT+NEE sample and 148 a BDPT sample. This kernel gives the same bits in
// one launch.
//
// What bounds it on an H100: bytes. An element reads 12 bytes, writes 4 and
// does one FMA: at 1,048,576 elements the bound is 16.8 MB / 3.35 TB/s =
// 5.0 us, at 262,144 1.25 us, at 65,536 0.31 us, all at or under the cost
// of the launch itself, and the glue that calls it is paced by the host. So
// the design keeps every call to one launch, moves no byte twice and keeps
// the host's part short:
//   * each operand is read in place through one element stride: 1 for a
//     contiguous tensor, 9 or 15 for a column of a gathered table, 0 for a
//     one-element tensor; a Python number comes by value. Nothing is copied
//     before the launch;
//   * one grid-stride loop over at most kMaxBlocks blocks of kThreads, one
//     float at a time: about half the glue's FMAs read a strided column,
//     and the device time is not what a call waits for.
// Built with the package's flags and without --use_fast_math or -ftz: a
// subnormal result is kept and rounded as the emulation rounds it.
//
// Why not torch.addcmul(c, a, b): on the card it gives these bits (PERF.md
// section 6), but only because the compiler contracts its a * b + c into
// one FMA. Its contract is input + value * tensor1 * tensor2, with no
// promise of a single rounding, and the port's parity with the JAX package
// rests on that rounding. This kernel states it: __fmaf_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks on each of 132 SMs

// element i of an operand: p[i * stride], or value where p is null
struct Operand {
  const float* p;
  long long stride;
  float value;
};

__device__ __forceinline__ float at(const Operand& o, long long i) {
  return o.p ? __ldg(o.p + i * o.stride) : o.value;
}

__global__ void fma_kernel(Operand a, Operand b, Operand c,
                           float* __restrict__ out, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step)
    out[i] = __fmaf_rn(at(a, i), at(b, i), at(c, i));
}

}  // namespace

// out[i] = fma(a[i], b[i], c[i]) for i < n on the stream; each operand is
// (pointer or null, element stride, value). Returns cudaGetLastError()
// after the launch.
extern "C" int fma_launch(const void* a, long long a_stride, float a_value,
                          const void* b, long long b_stride, float b_value,
                          const void* c, long long c_stride, float c_value,
                          void* out, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Operand oa{static_cast<const float*>(a), a_stride, a_value};
  const Operand ob{static_cast<const float*>(b), b_stride, b_value};
  const Operand oc{static_cast<const float*>(c), c_stride, c_value};
  const long long wanted = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(wanted < kMaxBlocks ? wanted
                                                          : kMaxBlocks);
  fma_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      oa, ob, oc, static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
