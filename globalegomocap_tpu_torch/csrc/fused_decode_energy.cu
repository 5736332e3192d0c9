// Fused decode energy: the BN-folded decoder conv chain, then the stage-1
// energy, forward and backward in one kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of globalegomocap_tpu/ops/pallas/
// fused_decode_energy.py:244 `fused_decode_stage_energy`
// (`_decode_energy_and_grad` :169, `pallas_call` :209).  Per (probe r,
// window b) row it takes the first dense layer's output h0 (T, C0) and
// returns the energy e and dE/dh0 (T, C0):
//
//   h_{i+1} = leaky(conv_i(h_i)),  i < n-1,   y = conv_{n-1}(h_{n-1}),
//   conv_i(h)[t] = K0 h[t-1] + K1 h[t] + K2 h[t+1] + bias  (k=3, SAME),
//
// leaky slope 0.01; y (T, 45) is the pose (channel j*3 + c of frame t is
// point t*15 + j, coordinate c); e and g = dE/dy are the energy core of
// csrc/energy_core.cuh, read and written in y's channel layout (the TPU
// kernel's selector matmuls become that index map); the backward runs the
// transposed convs, each layer's LeakyReLU mask read from the sign of its
// saved output (out >= 0 exactly where pre >= 0).
//
// Layout (the JAX package's): h0 (R*B, T, C0) float32; weights one float32
// buffer holding per layer the forward kernel (3, Cin, Cout), the backward
// kernel (3, Cout, Cin) with the taps reversed (tap 0 multiplies t-1 in
// both), and the bias (Cout); the energy context as in
// csrc/fused_energy.cu (anchor (B, 3, L), crops (B, k*k, L) float or
// bf16, ox, oy, bone (B, L), wvec (8), poly (P)).
//
// Bound on the H100 (what limits it): float32 operations.  The conv
// chain of the production prior (512-256-128-64-64-64-45) is
// 2*(3T-2)*sum(Cin*Cout) = 10.3 MFLOP per row forward (the edge frames
// have no outer tap) and as much backward, against about 45 KB of h0 in,
// dE/dh0 out and context per row, and 2.2 MB of weights shared by all
// rows.  Design: one block of 256 threads
// per row; each thread owns an output channel and keeps its T sums in
// registers, each weight it reads (from L2, where all layers stay
// resident) serving 3T FMAs; the row's activations are broadcast from
// shared memory.  Every layer's input stays in shared memory (about 47 KB
// a row at the production widths, dynamic shared memory above 48 KB) for
// the backward; after the first layer the h0 region holds the backward's
// two gradient buffers.  One row a block keeps four blocks (32 warps) on
// each SM to hide the latency of the L2 weight reads; blocks of 2 or 4
// rows, which read each weight once for all their rows, measured slower
// at every row count from 192 to 1,200 (PERF.md).  f32 FMA on the CUDA
// cores: TF32 tensor cores would not keep parity with the float32
// decode.

#include "energy_core.cuh"

namespace {

constexpr int kT = 10;          // frames per window
constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // the H100's per-block opt-in maximum

struct Chain {
  int n;                       // layers
  int cin[kMaxLayers], cout[kMaxLayers];
  size_t wf[kMaxLayers];       // forward kernel (3, cin, cout)
  size_t wb[kMaxLayers];       // backward kernel (3, cout, cin)
  size_t bias[kMaxLayers];     // bias (cout)
  int xoff[kMaxLayers + 1];    // the saved layer inputs, x[0] = h0
  int gbuf;                    // second backward gradient buffer
  int yoff, goff;              // the pose y (T, 45) and dE/dy
  int row_floats;              // shared floats of the row
};

// out (T, cout) = conv(in (T, cin)), optionally followed by the
// LeakyReLU; `bias` may be null.  Thread co keeps acc[t] in registers;
// in[t*cin + ci] is a shared-memory broadcast, W[(tap*cin + ci)*cout + co]
// a coalesced read.
__device__ __forceinline__ void conv_row(const float* __restrict__ W,
                                         const float* __restrict__ bias,
                                         int cin, int cout, const float* in,
                                         float* out, bool leaky) {
  for (int co = threadIdx.x; co < cout; co += blockDim.x) {
    const float b0 = bias ? __ldg(bias + co) : 0.f;
    float acc[kT];
#pragma unroll
    for (int t = 0; t < kT; ++t) acc[t] = b0;
#pragma unroll 2
    for (int ci = 0; ci < cin; ++ci) {
      const float k0 = __ldg(W + static_cast<size_t>(ci) * cout + co);
      const float k1 =
          __ldg(W + (static_cast<size_t>(cin) + ci) * cout + co);
      const float k2 =
          __ldg(W + (2 * static_cast<size_t>(cin) + ci) * cout + co);
      float xv[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) xv[t] = in[t * cin + ci];
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        float a = acc[t];
        if (t > 0) a = fmaf(k0, xv[t - 1], a);
        a = fmaf(k1, xv[t], a);
        if (t < kT - 1) a = fmaf(k2, xv[t + 1], a);
        acc[t] = a;
      }
    }
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      float v = acc[t];
      if (leaky) v = v >= 0.f ? v : 0.01f * v;
      out[t * cout + co] = v;
    }
  }
}

template <typename CropT>
__global__ void __launch_bounds__(kThreads) fused_decode_energy_kernel(
    const float* __restrict__ h0, const float* __restrict__ weights,
    Chain ch, int B, const float* __restrict__ anchor,
    const CropT* __restrict__ crops, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ bone,
    const float* __restrict__ wvec, const float* __restrict__ poly,
    int npoly, int L, int k, float sx, float sy, float crop_offset,
    float* __restrict__ e_out, float* __restrict__ gh0,
    float* __restrict__ pose_out, float* __restrict__ gpose_out) {
  extern __shared__ float smem[];
  float* sa = smem + ch.row_floats;  // (3, L) energy scratch
  float* sr = sa + 3 * L;
  float* sred = sr + 3 * L;          // (5, 32)
  const int row = blockIdx.x;
  const int c0 = ch.cin[0];
  const int last = ch.n - 1;

  // the h0 row into x[0]
  const float* src = h0 + static_cast<size_t>(row) * kT * c0;
  for (int i = threadIdx.x; i < kT * c0; i += blockDim.x)
    smem[ch.xoff[0] + i] = src[i];
  __syncthreads();

  // forward: x[i+1] = leaky(conv_i(x[i])), y = conv_last(x[last])
  for (int i = 0; i < ch.n; ++i) {
    float* out = smem + (i < last ? ch.xoff[i + 1] : ch.yoff);
    conv_row(weights + ch.wf[i], weights + ch.bias[i], ch.cin[i], ch.cout[i],
             smem + ch.xoff[i], out, i < last);
    __syncthreads();
  }

  // the energy, g = dE/dy in y's channel layout
  const size_t ctx = static_cast<size_t>(row % B) * L;
  float* y = smem + ch.yoff;
  float* g = smem + ch.goff;
  WindowContext<CropT> win{anchor + 3 * ctx, crops + ctx * k * k, ox + ctx,
                           oy + ctx, bone + ctx};
  energy_row<true, CropT>(y, PointLayout{1, 3}, sa, sr, sred, win, wvec, poly,
                          npoly, L, k, sx, sy, crop_offset, g,
                          PointLayout{1, 3}, e_out + row);
  if (pose_out != nullptr) {  // the checking path's view of the pose
    for (int i = threadIdx.x; i < 3 * L; i += blockDim.x) {
      const int c = i / L, l = i - c * L;
      const size_t o = static_cast<size_t>(row) * 3 * L + i;
      pose_out[o] = y[3 * l + c];
      gpose_out[o] = g[3 * l + c];
    }
  }

  // backward: g_in = conv_i^T(mask_i * g_out), from dE/dy down to dE/dh0
  int g_off = ch.goff;
  for (int i = last; i >= 0; --i) {
    if (i < last) {  // LeakyReLU mask from the sign of the saved output
      const int n = kT * ch.cout[i];
      float* gi = smem + g_off;
      const float* x = smem + ch.xoff[i + 1];
      for (int q = threadIdx.x; q < n; q += blockDim.x)
        if (!(x[q] >= 0.f)) gi[q] *= 0.01f;
      __syncthreads();
    }
    if (i > 0) {
      const int dst = g_off == ch.xoff[0] ? ch.gbuf : ch.xoff[0];
      conv_row(weights + ch.wb[i], nullptr, ch.cout[i], ch.cin[i],
               smem + g_off, smem + dst, false);
      g_off = dst;
    } else {
      conv_row(weights + ch.wb[0], nullptr, ch.cout[0], c0, smem + g_off,
               gh0 + static_cast<size_t>(row) * kT * c0, false);
    }
    __syncthreads();
  }
}

template <typename CropT>
int launch(const void* h0, const void* weights, const Chain& ch, int rows,
           int B, const void* anchor, const void* crops, const void* ox,
           const void* oy, const void* bone, const void* wvec,
           const void* poly, int npoly, int L, int k, float sx, float sy,
           float crop_offset, void* e, void* gh0, void* pose_out,
           void* gpose_out, void* stream) {
  const size_t smem =
      (static_cast<size_t>(ch.row_floats) + 6 * L + 5 * 32) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_decode_energy_kernel<CropT>;
  // once per instantiation, before any graph capture can reach it
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h0), static_cast<const float*>(weights), ch,
      B, static_cast<const float*>(anchor), static_cast<const CropT*>(crops),
      static_cast<const float*>(ox), static_cast<const float*>(oy),
      static_cast<const float*>(bone), static_cast<const float*>(wvec),
      static_cast<const float*>(poly), npoly, L, k, sx, sy, crop_offset,
      static_cast<float*>(e), static_cast<float*>(gh0),
      static_cast<float*>(pose_out), static_cast<float*>(gpose_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dims (n_layers + 1): C0, C1, ..., Cn (layer i maps C_i to C_{i+1});
// T = 10 frames and Cn = 45 (3 x 15 joints).  pose_out and gpose_out
// (R*B, 3, L) may be null; when given they receive the decoded pose and
// dE/dpose coordinate-major.  Returns a CUDA error code (0 = launched).
int fused_decode_stage_energy_launch(
    const void* h0, const void* weights, const int* dims, int n_layers,
    const void* anchor, const void* crops, int crop_bf16, const void* ox,
    const void* oy, const void* bone, const void* wvec, const void* poly,
    int npoly, void* e, void* gh0, void* pose_out, void* gpose_out, int R,
    int B, int L, int k, float sx, float sy, float crop_offset,
    void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || L != kT * kJ ||
      dims[n_layers] != 3 * kJ)
    return static_cast<int>(cudaErrorInvalidValue);
  Chain ch{};
  ch.n = n_layers;
  size_t off = 0;
  int gmax = 0;
  for (int i = 0; i < n_layers; ++i) {
    ch.cin[i] = dims[i];
    ch.cout[i] = dims[i + 1];
    const size_t nw = 3 * static_cast<size_t>(dims[i]) * dims[i + 1];
    ch.wf[i] = off;
    ch.wb[i] = off + nw;
    ch.bias[i] = off + 2 * nw;
    off += 2 * nw + dims[i + 1];
    if (i < n_layers - 1 && dims[i + 1] > gmax) gmax = dims[i + 1];
  }
  // x[0] holds h0, later the two backward gradient buffers
  const int x0 = kT * dims[0] > 2 * kT * gmax ? kT * dims[0] : 2 * kT * gmax;
  ch.xoff[0] = 0;
  ch.gbuf = kT * gmax;
  int at = x0;
  for (int i = 1; i < n_layers; ++i) {
    ch.xoff[i] = at;
    at += kT * dims[i];
  }
  ch.yoff = at;
  ch.goff = at + kT * 3 * kJ;
  ch.row_floats = ch.goff + kT * 3 * kJ;
  const int rows = R * B;
  if (crop_bf16)
    return launch<__nv_bfloat16>(h0, weights, ch, rows, B, anchor, crops, ox,
                                 oy, bone, wvec, poly, npoly, L, k, sx, sy,
                                 crop_offset, e, gh0, pose_out, gpose_out,
                                 stream);
  return launch<float>(h0, weights, ch, rows, B, anchor, crops, ox, oy, bone,
                       wvec, poly, npoly, L, k, sx, sy, crop_offset, e, gh0,
                       pose_out, gpose_out, stream);
}

}  // extern "C"
