// The 2 x 2 taps of bilinear sampling with the triangle kernel
// tri(a) = max(0, 1 - |a|) (align_corners, zero padding), shared by
// csrc/heatmap_sample.cu (kernel 3) and csrc/energy_core.cuh (kernels 1,
// 2 and 5).
//
// Along one axis of `size` cells, a coordinate i can give a non-zero
// weight or a non-zero a.e. derivative only at c0 = floor(i) and c0 + 1:
// every other cell c has |i - c| >= 1, also after rounding, so both are
// exactly 0 there.  A sum over those two taps therefore equals the dense
// sum over all cells bit for bit when it adds them in the dense order (a
// NaN coordinate reads no tap and gives 0, where the dense sum is NaN).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

// a map element as float32 (all math is float32)
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// triangle weight max(0, 1 - |a|)
__device__ __forceinline__ float tri(float a) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(a)));
}

// a.e. derivative of the triangle weight: -sign(a) inside |a| < 1, else 0
// (so 0 at an integer offset, and 0 for a NaN)
__device__ __forceinline__ float tri_grad(float a) {
  if (!(fabsf(a) < 1.f)) return 0.f;
  return a > 0.f ? -1.f : (a < 0.f ? 1.f : 0.f);
}

// The (at most) two taps of one axis: integer positions c0 = floor(i) and
// c0 + 1, whether each lies in [0, size - 1], and the offsets i - c.
struct Axis {
  int c0;
  bool in0, in1;
  float a0, a1;
};

// The range test runs on floats, and c0 becomes an int only after it: a
// NaN or huge coordinate (a point behind the camera or near its axis)
// has both taps out of range and reads nothing.
__device__ __forceinline__ Axis axis_taps(float i, int size) {
  const float f0 = floorf(i);
  const float f1 = f0 + 1.f;
  const float hi = static_cast<float>(size - 1);
  Axis ax;
  ax.in0 = f0 >= 0.f && f0 <= hi;
  ax.in1 = f1 >= 0.f && f1 <= hi;
  ax.c0 = (ax.in0 || ax.in1) ? static_cast<int>(f0) : 0;
  ax.a0 = __fsub_rn(i, f0);
  ax.a1 = __fsub_rn(i, f1);
  return ax;
}

// Tap (row ay.c0 + row1, column ax.c0 + col1) of a map whose element
// (h, w) lies at base[(h * W + w) * stride], or 0 for a tap outside it.
template <typename T>
__device__ __forceinline__ float tap(const T* base, int W, size_t stride,
                                     const Axis& ay, bool row1,
                                     const Axis& ax, bool col1) {
  const bool in = (row1 ? ay.in1 : ay.in0) && (col1 ? ax.in1 : ax.in0);
  if (!in) return 0.f;
  const int h = ay.c0 + (row1 ? 1 : 0);
  const int w = ax.c0 + (col1 ? 1 : 0);
  return load_f32(base + (static_cast<size_t>(h) * W + w) * stride);
}

}  // namespace
