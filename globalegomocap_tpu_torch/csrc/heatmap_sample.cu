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
//   dix  = sum_h tri(iy - h) * sum_w map[h, w] * tri'(ix - w)
//   diy  = sum_h tri'(iy - h) * sum_w map[h, w] * tri(ix - w)
//   dpts = (g * dix * sx, g * diy * sy),  sx = (W - 1) / 2,
//                                         sy = (H - 1) / 2
//
// with tri(a) = max(0, 1 - |a|) and the TPU backward's a.e. derivative
// tri'(a) = -sign(a) inside |a| < 1, else 0 (so 0 at an exact integer
// coordinate).  The maps get no gradient: they are constants of the solve.
//
// Design: the TPU kernel contracts each whole H x W map against dense
// triangle weights on the MXU, and its backward does so again.  Here one
// thread takes one (r, n) point and reads only the 2 x 2 taps that can be
// non-zero: columns floor(ix) and floor(ix) + 1, rows likewise (every
// other column has |ix - c| >= 1 after rounding too, so its weight and
// derivative are exactly 0).  The tap weights and the coordinates are
// computed with the same float32 operations as the plain PyTorch version
// (explicit _rn intrinsics, so nvcc contracts nothing into an FMA): kernel
// and plain version take the same side of every kink.
//
// One gather for each value-and-grad evaluation: where autograd records a
// graph, the forward's residual variant also writes the point partials
// (dix, diy) as an (R * N, 2) float32 residual, from the taps and weights
// the sample already holds in registers.  The backward is then a
// coalesced pass over g and the residual: it reads no map and does no
// coordinate math.  Value-only probes (no graph) launch the variant that
// writes the sample alone.
//
// Bound on the H100: bytes.  The forward reads each point's coordinates
// and its 2 x 2 taps (two 32-byte sectors of map, shared only by the R
// probe rows of one map) and writes the sample (and the residual); a few
// dozen float32 operations a point.  The backward moves 20 bytes a point.
// At the solver's shapes (thousands of points) both sit near the launch
// floor: a point's work is one dependent round trip (coordinates, then
// taps, then the store), and the pair of launches replaces a forward and
// a backward that each made that trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "taps.cuh"

namespace {

// The launch rule, one fixed block size a kernel, from timing 64, 128
// and 256 threads in turns on an H100 at the solver's shapes (R = 4 probes
// over 1,800 float32 maps and over 28,800 bf16 maps): the forward was
// fastest at 128 at both, the backward at 256 (64 cost it 8 % and 32 %).
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr int kMaxThreads = 256;

// sum over the two taps of one axis: m0 * w0 + m1 * w1
__device__ __forceinline__ float pair(float m0, float w0, float m1,
                                      float w1) {
  return __fadd_rn(__fmul_rn(m0, w0), __fmul_rn(m1, w1));
}

template <typename MapT, bool kResidual>
__global__ void __launch_bounds__(kMaxThreads)
    heatmap_sample_fwd_kernel(const MapT* __restrict__ maps,
                              const float* __restrict__ pts,
                              float* __restrict__ out,
                              float* __restrict__ res, int RN, int N, int H,
                              int W) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= RN) return;
  const float sx = 0.5f * static_cast<float>(W - 1);
  const float sy = 0.5f * static_cast<float>(H - 1);
  const int n = p % N;
  const float2 pt = __ldg(reinterpret_cast<const float2*>(pts) + p);
  const Axis ax = axis_taps(__fmul_rn(__fadd_rn(pt.x, 1.f), sx), W);
  const Axis ay = axis_taps(__fmul_rn(__fadd_rn(pt.y, 1.f), sy), H);
  const MapT* map = maps + static_cast<size_t>(n) * H * W;
  const float m00 = tap(map, W, 1, ay, false, ax, false);
  const float m01 = tap(map, W, 1, ay, false, ax, true);
  const float m10 = tap(map, W, 1, ay, true, ax, false);
  const float m11 = tap(map, W, 1, ay, true, ax, true);
  const float wx0 = tri(ax.a0), wx1 = tri(ax.a1);
  const float wy0 = tri(ay.a0), wy1 = tri(ay.a1);
  // rows of the sample: each row's taps weighted by tri(ix - w)
  const float in0 = pair(m00, wx0, m01, wx1);
  const float in1 = pair(m10, wx0, m11, wx1);
  out[p] = pair(in0, wy0, in1, wy1);
  if constexpr (kResidual) {
    const float dwx0 = tri_grad(ax.a0), dwx1 = tri_grad(ax.a1);
    float2 d;
    // d/dix: rows weighted by tri(iy - h), columns by tri'(ix - w)
    d.x = pair(pair(m00, dwx0, m01, dwx1), wy0, pair(m10, dwx0, m11, dwx1),
               wy1);
    // d/diy: rows weighted by tri'(iy - h), columns by tri(ix - w)
    d.y = pair(in0, tri_grad(ay.a0), in1, tri_grad(ay.a1));
    reinterpret_cast<float2*>(res)[p] = d;
  }
}

// dpts = ((g * dix) * sx, (g * diy) * sy), rounded in that order as JAX's
// `g * dix * sx` and the plain version
__global__ void __launch_bounds__(kMaxThreads)
    heatmap_sample_bwd_kernel(const float* __restrict__ g,
                              const float* __restrict__ res,
                              float* __restrict__ dpts, int RN, float sx,
                              float sy) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= RN) return;
  const float2 d = __ldg(reinterpret_cast<const float2*>(res) + p);
  const float gp = __ldg(g + p);
  float2 o;
  o.x = __fmul_rn(__fmul_rn(gp, d.x), sx);
  o.y = __fmul_rn(__fmul_rn(gp, d.y), sy);
  reinterpret_cast<float2*>(dpts)[p] = o;
}

bool valid_threads(int t) {
  return t == 64 || t == 128 || t == 256;
}

int blocks_for(int RN, int threads) {
  const int b = (RN + threads - 1) / threads;
  return b > 0 ? b : 1;
}

template <typename MapT>
void launch_fwd(const MapT* maps, const float* pts, float* out, float* res,
                int RN, int N, int H, int W, int threads, cudaStream_t st) {
  const int b = blocks_for(RN, threads);
  if (res)
    heatmap_sample_fwd_kernel<MapT, true>
        <<<b, threads, 0, st>>>(maps, pts, out, res, RN, N, H, W);
  else
    heatmap_sample_fwd_kernel<MapT, false>
        <<<b, threads, 0, st>>>(maps, pts, out, nullptr, RN, N, H, W);
}

}  // namespace

extern "C" {

// Threads a block the launch rule takes: the backward's if bwd, else the
// forward's.
int heatmap_sample_threads(int bwd) {
  return bwd ? kBwdThreads : kFwdThreads;
}

// Forward: out (R*N) float and, unless res is null, the residual
// (R*N, 2) float (dix, diy).  maps_bf16 selects the map element type;
// threads 0 takes the launch rule, 64, 128 or 256 that block size.
// Returns cudaGetLastError() after the launch.
int heatmap_sample_fwd_launch(const void* maps, int maps_bf16,
                              const void* pts, void* out, void* res, int R,
                              int N, int H, int W, int threads,
                              void* stream) {
  const int RN = R * N;
  if (threads == 0) threads = kFwdThreads;
  if (!valid_threads(threads)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (maps_bf16)
    launch_fwd(static_cast<const __nv_bfloat16*>(maps),
               static_cast<const float*>(pts), static_cast<float*>(out),
               static_cast<float*>(res), RN, N, H, W, threads, st);
  else
    launch_fwd(static_cast<const float*>(maps),
               static_cast<const float*>(pts), static_cast<float*>(out),
               static_cast<float*>(res), RN, N, H, W, threads, st);
  return static_cast<int>(cudaGetLastError());
}

// Backward: dpts (R*N, 2) float from the cotangent g (R*N) and the
// forward's residual; H and W are the maps'.
int heatmap_sample_bwd_launch(const void* g, const void* res, void* dpts,
                              int RN, int H, int W, int threads,
                              void* stream) {
  if (threads == 0) threads = kBwdThreads;
  if (!valid_threads(threads)) return static_cast<int>(cudaErrorInvalidValue);
  heatmap_sample_bwd_kernel<<<blocks_for(RN, threads), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(res),
      static_cast<float*>(dpts), RN, 0.5f * static_cast<float>(W - 1),
      0.5f * static_cast<float>(H - 1));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
