// L-BFGS two-loop recursion, one lane per block, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of globalegomocap_tpu/ops/pallas/
// lbfgs_direction.py: `lbfgs_direction_pallas` (`_dir_kernel`) and the
// lane-blocked `lbfgs_direction_pallas_batched` (`_dir_kernel_block`) that
// its vmap rule dispatches to.  Per lane b, with the histories ordered
// oldest (0) .. newest (m - 1):
//
//   q = g
//   for i = m-1 .. 0:  a_i = valid_i ? rho_i * (s_i . q) : 0;  q -= a_i y_i
//   gamma = valid_{m-1} && y.y > 0 ? s.y / y.y (newest pair) : 1
//   r = gamma q
//   for i = 0 .. m-1:  b = rho_i * (y_i . r);  if valid_i: r += (a_i - b) s_i
//   out = -r
//
// An invalid slot is skipped by a branch, not multiplied by 0, so neither
// a division by zero nor a NaN in an unused slot reaches the direction.
//
// Design: one block per lane.  The 2m + 1 dependent dot products are block
// reductions (warp shuffles, then one fixed-order pass over the warps'
// partial sums, which every thread reads: deterministic, no atomics).  q
// and r live in shared memory, each thread touching only its own strided
// elements.  s and y stream from device memory: at m = 25, d = 2048 they
// are 400 KB a lane, more than a block's 227 KB of shared memory.
//
// Bound on the H100: each lane reads g, s and y once and writes the
// direction, B * (2m + 2) * d * 4 bytes; the flops are 4 per element and
// slot.  At the solver's shapes (B = 12 lanes) the grid fills 12 of 132
// SMs and the 2m + 1 reductions run one after the other, so latency, not
// bandwidth, bounds it; splitting d over a cluster of blocks is the next
// step.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// sum of v over the block, returned to every thread; `red` holds kWarps
// floats and is free again when this returns
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

__global__ void __launch_bounds__(kThreads)
    lbfgs_direction_kernel(const float* __restrict__ g,
                           const float* __restrict__ s,
                           const float* __restrict__ y,
                           const float* __restrict__ rho,
                           const unsigned char* __restrict__ valid,
                           float* __restrict__ out, int m, int d) {
  extern __shared__ float smem[];
  float* q = smem;          // (d) q, then r
  float* alpha = smem + d;  // (m)
  float* red = alpha + m;   // (kWarps)

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const float* gl = g + static_cast<size_t>(lane) * d;
  const float* sl = s + static_cast<size_t>(lane) * m * d;
  const float* yl = y + static_cast<size_t>(lane) * m * d;
  const float* rl = rho + static_cast<size_t>(lane) * m;
  const unsigned char* vl = valid + static_cast<size_t>(lane) * m;

  for (int i = tid; i < d; i += kThreads) q[i] = gl[i];

  // newest to oldest
  for (int k = m - 1; k >= 0; --k) {
    float a = 0.f;
    if (vl[k]) {
      const float* sk = sl + static_cast<size_t>(k) * d;
      const float* yk = yl + static_cast<size_t>(k) * d;
      float part = 0.f;
      for (int i = tid; i < d; i += kThreads) part += sk[i] * q[i];
      a = rl[k] * block_sum(part, red);
      for (int i = tid; i < d; i += kThreads) q[i] -= a * yk[i];
    }
    if (tid == 0) alpha[k] = a;
  }

  // initial Hessian scale from the newest pair
  float gamma = 1.f;
  if (vl[m - 1]) {
    const float* sk = sl + static_cast<size_t>(m - 1) * d;
    const float* yk = yl + static_cast<size_t>(m - 1) * d;
    float psy = 0.f, pyy = 0.f;
    for (int i = tid; i < d; i += kThreads) {
      psy += sk[i] * yk[i];
      pyy += yk[i] * yk[i];
    }
    const float sy = block_sum(psy, red);
    const float yy = block_sum(pyy, red);
    if (yy > 0.f) gamma = sy / yy;
  }
  for (int i = tid; i < d; i += kThreads) q[i] *= gamma;
  __syncthreads();  // alpha[] written by thread 0

  // oldest to newest
  for (int k = 0; k < m; ++k) {
    if (!vl[k]) continue;
    const float* sk = sl + static_cast<size_t>(k) * d;
    const float* yk = yl + static_cast<size_t>(k) * d;
    float part = 0.f;
    for (int i = tid; i < d; i += kThreads) part += yk[i] * q[i];
    const float b = rl[k] * block_sum(part, red);
    const float c = alpha[k] - b;
    for (int i = tid; i < d; i += kThreads) q[i] += c * sk[i];
  }

  float* ol = out + static_cast<size_t>(lane) * d;
  for (int i = tid; i < d; i += kThreads) ol[i] = -q[i];
}

}  // namespace

extern "C" {

// grad (B, d), s/y (B, m, d), rho (B, m) float; valid (B, m) bytes (0/1);
// out (B, d).  Returns cudaGetLastError() after the launch.
int lbfgs_direction_launch(const void* g, const void* s, const void* y,
                           const void* rho, const void* valid, void* out,
                           int B, int m, int d, void* stream) {
  const size_t smem = (static_cast<size_t>(d) + m + kWarps) * sizeof(float);
  lbfgs_direction_kernel<<<B, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(s),
      static_cast<const float*>(y), static_cast<const float*>(rho),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out), m,
      d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
