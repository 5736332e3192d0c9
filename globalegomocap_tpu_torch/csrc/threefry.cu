// JAX's threefry random draws, one launch a draw, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: JAX's draw is XLA's own fusion of
// `jax.random`'s threefry2x32 and its bits-to-float transforms.  It was
// added because the port's plain draw (ops/random.py::plain_draw, a chain
// of int64 PyTorch ops) took milliseconds on the card for the noise a
// train step draws, where this kernel takes microseconds.
//
// One thread an element (a grid-stride loop): element i of a draw hashes
// its flat index start + i as the counter words (hi, lo) under the key
// (k0, k1), threefry2x32 with JAX's rotations and key schedule, and keeps
// bits0 ^ bits1 (its low 8 bits for bfloat16, JAX's 8-bit stream).  Then,
// by kind:
//
//   BITS       the word (masked to `width` bits), as int64;
//   UNIFORM    the top mantissa bits under exponent 1, less 1, scaled to
//              [lo, hi) and held at lo;
//   NORMAL     sqrt(2) * erf_inv(u) of that uniform (lo = nextafter(-1, 0),
//              hi = 1);
//   TRUNCATED  the same of a uniform on [erf(lower/sqrt2), erf(upper/
//              sqrt2)), clamped to [clip_lo, clip_hi].
//
// The float arithmetic is the plain version's, operation for operation,
// with explicit _rn intrinsics so that nvcc contracts nothing: in float32
// the uniform's scale is one fused multiply-add (XLA fuses it, and the
// plain version computes it exactly in float64); bfloat16 rounds after
// each operation, as PyTorch's and XLA's bf16 elementwise ops do;
// erf_inv is XLA's float32 polynomial with each Horner step a float64
// multiply and add rounded to float32, around log1pf and sqrtf (the
// functions PyTorch's CUDA log1p and sqrt call), so the kernel and the
// plain version on the card give the same floats.
//
// Bound on the H100: bytes, at the port's shapes.  A draw writes 4 bytes
// an element (2 in bf16, 8 for bits) and reads nothing; the hash is about
// 100 32-bit integer operations an element and erf_inv about 25 float64
// ones, so at 3.35 TB/s the writes and at the card's integer rate the
// hash are of one order; below about a million elements the launch floor
// (about 1 us) is the limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Kind { kBits = 0, kUniform = 1, kNormal = 2, kTruncated = 3 };
enum Out { kInt64 = 0, kFloat32 = 1, kBfloat16 = 2 };

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four threefry rounds with the rotations r0..r3.
#define THREEFRY_ROUNDS(r0, r1, r2, r3) \
  x0 += x1; x1 = rotl(x1, r0) ^ x0;     \
  x0 += x1; x1 = rotl(x1, r1) ^ x0;     \
  x0 += x1; x1 = rotl(x1, r2) ^ x0;     \
  x0 += x1; x1 = rotl(x1, r3) ^ x0;

// threefry2x32 of (x0, x1) under (k0, k1): 20 rounds, a key injection
// after each four.  Returns bits0 ^ bits1.
__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k1; x1 += k2 + 1u;
  THREEFRY_ROUNDS(17, 29, 16, 24)
  x0 += k2; x1 += k0 + 2u;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k0; x1 += k1 + 3u;
  THREEFRY_ROUNDS(17, 29, 16, 24)
  x0 += k1; x1 += k2 + 4u;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef THREEFRY_ROUNDS

// XLA's ErfInv32 coefficients as float32 bit patterns (the plain
// version's float32 constants), for w < 5 and w >= 5.
__constant__ uint32_t kErfInvLt5[9] = {
    0x32f16588u, 0x34b84b36u, 0xb66c7357u, 0xb6935ac1u, 0x396532dbu,
    0xbaa45408u, 0xbb88e4efu, 0x3e7c8f63u, 0x3fc02e2fu};
__constant__ uint32_t kErfInvGe5[9] = {
    0xb951f09bu, 0x38d3b56bu, 0x3ab0dc72u, 0xbb70bde7u, 0x3bbc127bu,
    0xbbf9c5d7u, 0x3c1aa57eu, 0x3f8036dbu, 0x40354f7eu};

constexpr uint32_t kSqrt2F32 = 0x3fb504f3u;  // float32(sqrt 2)
constexpr uint16_t kSqrt2Bf16 = 0x3fb5u;     // bfloat16(sqrt 2)

__device__ __forceinline__ float erf_inv(float x) {
  const float w = -log1pf(__fmul_rn(-x, x));
  const bool small = w < 5.0f;
  const float t = small ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  const uint32_t* c = small ? kErfInvLt5 : kErfInvGe5;
  const double wd = static_cast<double>(t);
  double p = static_cast<double>(__uint_as_float(c[0]));
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const double ci = static_cast<double>(__uint_as_float(c[i]));
    p = static_cast<double>(
        __double2float_rn(__dadd_rn(ci, __dmul_rn(p, wd))));
  }
  const float out = __fmul_rn(static_cast<float>(p), x);
  return fabsf(x) == 1.0f ? __fmul_rn(x, 3.402823466e38f) : out;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float f32_value(int kind, uint32_t word, float lo,
                                           float span, float clip_lo,
                                           float clip_hi) {
  const float unit = __uint_as_float((word >> 9) | 0x3F800000u);
  const float f = __fsub_rn(unit, 1.0f);
  const float u = fmaxf(lo, __fmaf_rn(f, span, lo));
  if (kind == kUniform) return u;
  float out = __fmul_rn(erf_inv(u), __uint_as_float(kSqrt2F32));
  if (kind == kTruncated) out = fminf(fmaxf(out, clip_lo), clip_hi);
  return out;
}

__device__ __forceinline__ float bf16_value(int kind, uint32_t word, float lo,
                                            float span, float clip_lo,
                                            float clip_hi) {
  const uint32_t b8 = word & 0xFFu;
  const float unit = __uint_as_float(((b8 >> 1) | 0x3F80u) << 16);
  const float f = bf16_round(__fsub_rn(unit, 1.0f));
  const float scaled = bf16_round(__fadd_rn(bf16_round(__fmul_rn(f, span)),
                                            lo));
  const float u = fmaxf(lo, scaled);
  if (kind == kUniform) return u;
  const float e = bf16_round(erf_inv(u));
  const float sqrt2 = __uint_as_float(static_cast<uint32_t>(kSqrt2Bf16)
                                      << 16);
  float out = bf16_round(__fmul_rn(e, sqrt2));
  if (kind == kTruncated) out = fminf(fmaxf(out, clip_lo), clip_hi);
  return out;
}

__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(int kind, int out_type, int width, uint32_t k0,
                     uint32_t k1, unsigned long long start, long long n,
                     float lo, float span, float clip_lo, float clip_hi,
                     void* out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned long long idx = start + static_cast<unsigned long long>(i);
    const uint32_t word = threefry_word(k0, k1,
                                        static_cast<uint32_t>(idx >> 32),
                                        static_cast<uint32_t>(idx));
    if (out_type == kInt64) {
      const uint32_t mask = width >= 32 ? 0xFFFFFFFFu : (1u << width) - 1u;
      static_cast<long long*>(out)[i] = static_cast<long long>(word & mask);
    } else if (out_type == kFloat32) {
      static_cast<float*>(out)[i] =
          f32_value(kind, word, lo, span, clip_lo, clip_hi);
    } else {
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(
          bf16_value(kind, word, lo, span, clip_lo, clip_hi));
    }
  }
}

}  // namespace

extern "C" {

// One draw of n elements from flat index `start` under the key (k0, k1)
// into `out`: kind 0 bits (out_type 0, int64, `width` 8, 16 or 32), 1
// uniform, 2 normal, 3 truncated normal (out_type 1 float32, 2 bfloat16);
// lo and hi the uniform's bounds and clip_lo, clip_hi the truncated
// normal's clamp, each a value of the output type.  Returns
// cudaGetLastError() after the launch.
int threefry_draw_launch(int kind, int out_type, int width, uint32_t k0,
                         uint32_t k1, long long start, long long n, float lo,
                         float hi, float clip_lo, float clip_hi, void* out,
                         void* stream) {
  if (n <= 0 || start < 0 || kind < kBits || kind > kTruncated ||
      out_type < kInt64 || out_type > kBfloat16 ||
      (kind == kBits) != (out_type == kInt64) ||
      (kind == kBits && width != 8 && width != 16 && width != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  // the uniform's span hi - lo, rounded as the plain version rounds it
  float span = hi - lo;
  if (out_type == kBfloat16)
    span = __bfloat162float(__float2bfloat16_rn(span));
  long long blocks = (n + kThreads - 1) / kThreads;
  // enough blocks to fill the card many times; the loop takes the rest
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  threefry_draw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      kind, out_type, width, k0, k1, static_cast<unsigned long long>(start),
      n, lo, span, clip_lo, clip_hi, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
