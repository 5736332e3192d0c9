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

#include "taps.cuh"

namespace {

constexpr int kThreads = 256;

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
    const float in0 = pair(tap(map, W, 1, ay, false, ax, false), wx0,
                           tap(map, W, 1, ay, false, ax, true), wx1);
    const float in1 = pair(tap(map, W, 1, ay, true, ax, false), wx0,
                           tap(map, W, 1, ay, true, ax, true), wx1);
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
    const float m00 = tap(map, W, 1, ay, false, ax, false);
    const float m01 = tap(map, W, 1, ay, false, ax, true);
    const float m10 = tap(map, W, 1, ay, true, ax, false);
    const float m11 = tap(map, W, 1, ay, true, ax, true);
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
