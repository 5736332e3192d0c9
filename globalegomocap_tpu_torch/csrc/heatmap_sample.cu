// Bilinear heatmap sampling, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of globalegomocap_tpu/ops/pallas/
// heatmap_sample.py: `heatmap_sample_pallas` (forward `_fwd_kernel`,
// reached through `_forward`) and its custom VJP (`_bwd_kernel`, reached
// through `_bwd_rule`).  Same function: maps (N, H, W) float or bf16
// (upcast, all math float32), points (R, N, 2) in [-1, 1] with
// align_corners=True and zero padding; probe row r samples map n at
// points[r, n].
//
//   ix = (px + 1) * (W - 1) / 2,  iy = (py + 1) * (H - 1) / 2
//   out  = sum_h tri(iy - h) * sum_w map[h, w] * tri(ix - w)
//   dout/dix = sum_h tri(iy - h) * sum_w map[h, w] * tri'(ix - w), etc.
//
// with tri(a) = max(0, 1 - |a|) and the TPU backward's a.e. derivative
// tri'(a) = -sign(a) inside |a| < 1, else 0 (so 0 at an exact integer
// coordinate).  The maps get no gradient: they are constants of the solve.
//
// Design: the TPU kernel contracts each whole H x W map against dense
// triangle weights on the MXU.  Here one thread takes one (r, n) point and
// reads only the 2 x 2 taps that can be non-zero: columns floor(ix) and
// floor(ix) + 1, rows likewise (every other column has |ix - c| >= 1 after
// rounding too, so its weight and derivative are exactly 0).  The tap
// weights and the coordinates are computed with the same float32 operations
// as the plain PyTorch version (explicit _rn intrinsics, so nvcc contracts
// nothing into an FMA): kernel and plain version take the same side of
// every kink.
//
// Bound on the H100: each point reads its 2 x 2 taps (two 32-byte sectors
// of map), its coordinates and writes its sample; a handful of float32
// operations per point, so bytes bound it, and the taps are scattered
// (one point per map per probe row, the R rows of a map hit the same
// sectors in L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// triangle weight max(0, 1 - |a|)
__device__ __forceinline__ float tri(float a) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(a)));
}

// a.e. derivative of the triangle weight: -sign(a) inside |a| < 1, else 0
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

template <typename MapT>
__device__ __forceinline__ float tap(const MapT* map, int W, const Axis& ay,
                                     bool row1, const Axis& ax, bool col1) {
  const bool in = (row1 ? ay.in1 : ay.in0) && (col1 ? ax.in1 : ax.in0);
  if (!in) return 0.f;
  const int h = ay.c0 + (row1 ? 1 : 0);
  const int w = ax.c0 + (col1 ? 1 : 0);
  return load_f32(map + static_cast<size_t>(h) * W + w);
}

// sum over the two taps of one axis: m0 * w0 + m1 * w1
__device__ __forceinline__ float pair(float m0, float w0, float m1,
                                      float w1) {
  return __fadd_rn(__fmul_rn(m0, w0), __fmul_rn(m1, w1));
}

template <typename MapT>
__global__ void heatmap_sample_fwd_kernel(const MapT* __restrict__ maps,
                                          const float* __restrict__ pts,
                                          float* __restrict__ out, int RN,
                                          int N, int H, int W) {
  const float sx = 0.5f * static_cast<float>(W - 1);
  const float sy = 0.5f * static_cast<float>(H - 1);
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < RN;
       p += gridDim.x * blockDim.x) {
    const int n = p % N;
    const float2 pt = reinterpret_cast<const float2*>(pts)[p];
    const Axis ax = axis_taps(__fmul_rn(__fadd_rn(pt.x, 1.f), sx), W);
    const Axis ay = axis_taps(__fmul_rn(__fadd_rn(pt.y, 1.f), sy), H);
    const MapT* map = maps + static_cast<size_t>(n) * H * W;
    const float wx0 = tri(ax.a0), wx1 = tri(ax.a1);
    const float in0 = pair(tap(map, W, ay, false, ax, false), wx0,
                           tap(map, W, ay, false, ax, true), wx1);
    const float in1 = pair(tap(map, W, ay, true, ax, false), wx0,
                           tap(map, W, ay, true, ax, true), wx1);
    out[p] = pair(in0, tri(ay.a0), in1, tri(ay.a1));
  }
}

template <typename MapT>
__global__ void heatmap_sample_bwd_kernel(const MapT* __restrict__ maps,
                                          const float* __restrict__ pts,
                                          const float* __restrict__ g,
                                          float* __restrict__ dpts, int RN,
                                          int N, int H, int W) {
  const float sx = 0.5f * static_cast<float>(W - 1);
  const float sy = 0.5f * static_cast<float>(H - 1);
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < RN;
       p += gridDim.x * blockDim.x) {
    const int n = p % N;
    const float2 pt = reinterpret_cast<const float2*>(pts)[p];
    const Axis ax = axis_taps(__fmul_rn(__fadd_rn(pt.x, 1.f), sx), W);
    const Axis ay = axis_taps(__fmul_rn(__fadd_rn(pt.y, 1.f), sy), H);
    const MapT* map = maps + static_cast<size_t>(n) * H * W;
    const float m00 = tap(map, W, ay, false, ax, false);
    const float m01 = tap(map, W, ay, false, ax, true);
    const float m10 = tap(map, W, ay, true, ax, false);
    const float m11 = tap(map, W, ay, true, ax, true);
    const float wx0 = tri(ax.a0), wx1 = tri(ax.a1);
    const float wy0 = tri(ay.a0), wy1 = tri(ay.a1);
    const float dwx0 = tri_grad(ax.a0), dwx1 = tri_grad(ax.a1);
    const float dwy0 = tri_grad(ay.a0), dwy1 = tri_grad(ay.a1);
    // d/dix: rows weighted by tri(iy - h), columns by tri'(ix - w)
    const float dix = pair(pair(m00, dwx0, m01, dwx1), wy0,
                           pair(m10, dwx0, m11, dwx1), wy1);
    // d/diy: rows weighted by tri'(iy - h), columns by tri(ix - w)
    const float diy = pair(pair(m00, wx0, m01, wx1), dwy0,
                           pair(m10, wx0, m11, wx1), dwy1);
    const float gp = g[p];
    float2 d;
    d.x = __fmul_rn(__fmul_rn(gp, dix), sx);
    d.y = __fmul_rn(__fmul_rn(gp, diy), sy);
    reinterpret_cast<float2*>(dpts)[p] = d;
  }
}

int blocks_for(int RN) {
  const int b = (RN + kThreads - 1) / kThreads;
  return b > 0 ? b : 1;
}

}  // namespace

extern "C" {

// Forward: out (R*N) float.  maps_bf16 selects the map element type.
// Returns cudaGetLastError() after the launch.
int heatmap_sample_fwd_launch(const void* maps, int maps_bf16,
                              const void* pts, void* out, int R, int N,
                              int H, int W, void* stream) {
  const int RN = R * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (maps_bf16)
    heatmap_sample_fwd_kernel<__nv_bfloat16><<<blocks_for(RN), kThreads, 0,
                                              st>>>(
        static_cast<const __nv_bfloat16*>(maps),
        static_cast<const float*>(pts), static_cast<float*>(out), RN, N, H,
        W);
  else
    heatmap_sample_fwd_kernel<float><<<blocks_for(RN), kThreads, 0, st>>>(
        static_cast<const float*>(maps), static_cast<const float*>(pts),
        static_cast<float*>(out), RN, N, H, W);
  return static_cast<int>(cudaGetLastError());
}

// Backward: dpts (R*N, 2) float from the cotangent g (R*N).
int heatmap_sample_bwd_launch(const void* maps, int maps_bf16,
                              const void* pts, const void* g, void* dpts,
                              int R, int N, int H, int W, void* stream) {
  const int RN = R * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (maps_bf16)
    heatmap_sample_bwd_kernel<__nv_bfloat16><<<blocks_for(RN), kThreads, 0,
                                              st>>>(
        static_cast<const __nv_bfloat16*>(maps),
        static_cast<const float*>(pts), static_cast<const float*>(g),
        static_cast<float*>(dpts), RN, N, H, W);
  else
    heatmap_sample_bwd_kernel<float><<<blocks_for(RN), kThreads, 0, st>>>(
        static_cast<const float*>(maps), static_cast<const float*>(pts),
        static_cast<const float*>(g), static_cast<float*>(dpts), RN, N, H,
        W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
