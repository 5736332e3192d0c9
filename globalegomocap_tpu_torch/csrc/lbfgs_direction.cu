// L-BFGS two-loop recursion, one thread-block cluster per lane, for Hopper
// (sm_90a).
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
// Elements are float or bf16 (the state's dtype, as in the JAX kernel);
// dot products sum in float32, and every other result is rounded to the
// element type where the plain PyTorch version (`two_loop_direction`)
// rounds it: each product, difference and quotient separately, never
// contracted into a fused multiply-add.
//
// What bounds it: 2 n_valid dependent dot products, each followed by an
// update that the next one needs.  The bytes (g, the valid slots of s and
// y, the output) are read once; at the solver's shapes (B = 12 lanes,
// m = 25, d = 2048) they take under a microsecond at the HBM rate, so
// latency, not bandwidth, sets the time: the length of one step times
// the number of steps.
//
// Design:
// - A cluster of C CTAs per lane (C chosen on the host by `plan` below:
//   the smallest C whose slice fits shared memory with at most 128
//   threads, one warp per scheduler; C = 2 at d = 2048).  The slice must
//   be a whole number of 16-byte rows (the bulk copies' unit) and at
//   most kMaxThreads * kPerThread = 2048 elements, and the CTA's shared
//   memory (`smem_bytes`, about (2 m + 1) slice elements) at most the
//   card's opt-in limit: so d * element size is a multiple of 16,
//   d <= 32768, and m <= 221 at d = 2048 in float32 (434 in bf16).  CTA
//   `rank` owns the contiguous slice [rank * slice, (rank + 1) * slice)
//   of the d elements, slice = d / C.
// - At entry warp 0 copies the slice of g and of every valid slot of s and
//   y into dynamic shared memory with bulk copies (cp.async.bulk, the TMA's
//   1-D form), newest slot first, each slot completing on its own
//   mbarrier, so the first steps start while older slots land; rho and
//   valid are staged with plain loads.  Device-memory latency is paid
//   once, not once per step.  Each thread owns the elements
//   tid + j * blockDim.x (j < kPerThread) of the slice and keeps its part
//   of q, later r, in registers; each step's s, y and rho are loaded into
//   registers while the previous step's partial sums travel.
// - Each dot product: a warp reduces its threads' partial sums with
//   shuffles, then lane j < C stores the warp's sum into slot
//   [parity][rank * warps + warp] of CTA j's shared memory with st.async,
//   which completes on CTA j's exchange mbarrier of that parity; each
//   CTA's thread 0 arms its mbarrier for the C * warps sums it expects,
//   every thread waits on it and sums the slots in the same fixed order,
//   so every CTA holds the same scalar, bit for bit, with no atomics.
//   The slots and mbarriers alternate by step parity: a CTA writes step
//   t + 2's partials only after it has every CTA's step t + 1 partials,
//   which each CTA computes after reading step t's.  (barrier.cluster
//   with release/acquire in place of the mbarriers, one barrier a step,
//   ran 1.5-1.9x slower on an H100 at the solver's shapes.)
// - s.y and y.y of the newest pair do not depend on q: they are reduced in
//   the same step as s_{m-1} . g.  An invalid slot costs no step: every
//   CTA walks the same list of valid slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kPerThread = 8;     // slice elements a thread owns, at most
constexpr int kMaxThreads = 256;
constexpr int kBestThreads = 128;  // one warp for each of four schedulers
constexpr int kClusters[] = {1, 2, 4, 8, 16};  // 16: non-portable maximum

// element type traits: load as float, round a float result to the type
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p, int i) {
    return p[i];
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void round2(float&, float&) {}
  static __device__ __forceinline__ void store(float* p, int i, float v) {
    p[i] = v;
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p,
                                               int i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  // two at once: one conversion instruction instead of two
  static __device__ __forceinline__ void round2(float& x, float& y) {
    const __nv_bfloat162 r = __float22bfloat162_rn(make_float2(x, y));
    x = __low2float(r);
    y = __high2float(r);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, int i,
                                               float v) {
    p[i] = __float2bfloat16_rn(v);
  }
};

// one operation of the plain version, rounded to T, never contracted
template <typename T>
__device__ __forceinline__ float mul(float a, float b) {
  return Elem<T>::round(__fmul_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float sub(float a, float b) {
  return Elem<T>::round(__fsub_rn(a, b));
}

// v[j] = v[j] - c * w[j] (sign -1) or v[j] + c * w[j] (sign +1) for this
// thread's elements, the product and the sum each rounded to T
template <typename T, int kSign>
__device__ __forceinline__ void axpy(float (&v)[kPerThread], float c,
                                     const float (&w)[kPerThread]) {
#pragma unroll
  for (int j = 0; j < kPerThread; j += 2) {
    float t0 = __fmul_rn(c, w[j]), t1 = __fmul_rn(c, w[j + 1]);
    Elem<T>::round2(t0, t1);
    t0 = kSign > 0 ? __fadd_rn(v[j], t0) : __fsub_rn(v[j], t0);
    t1 = kSign > 0 ? __fadd_rn(v[j + 1], t1) : __fsub_rn(v[j + 1], t1);
    Elem<T>::round2(t0, t1);
    v[j] = t0;
    v[j + 1] = t1;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the same shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// a barrier of every thread of every CTA of the cluster, in two halves;
// orders the shared-memory writes before the arrival (release) against
// the accesses after the wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();  // the .aligned forms want the warp converged
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// global -> this CTA's shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // the same bits in every lane (addition commutes)
}

// 4 bytes into CTA-local address `addr` mapped to another CTA, counted on
// that CTA's mbarrier `bar` (mapped alike) when they land
__device__ __forceinline__ void store_async(uint32_t addr, float v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// Shared state of one CTA (dynamic shared memory, in this order): the g
// slice, the s and y slices (m, slice) of type T, the partial sums
// float[2 parities][3 values][padded parts], the mbarriers (g, m slots,
// 2 exchange parities), alpha and rho as float (m), the valid slots'
// indices and their count (m + 1 ints), valid (m bytes).
__host__ __device__ inline int padded_parts(int parts) {
  return (parts + 3) / 4 * 4;
}

__host__ __device__ inline size_t smem_bytes(int elem, int m, int slice,
                                             int parts) {
  const size_t arrays = static_cast<size_t>(elem) * slice * (2 * m + 1);
  const size_t tail = 4 * 6 * static_cast<size_t>(padded_parts(parts)) +
                      8 * (static_cast<size_t>(m) + 3) +
                      12 * static_cast<size_t>(m) + 4 + m;
  return (arrays + tail + 15) / 16 * 16;
}

// The cluster-wide sums of N values per thread: `send`, then `finish`,
// with independent work (the next step's loads) between the two.  Each
// warp reduces with shuffles; lane j < C sends the warp's sums to slot
// `slot` of CTA j's partials of this parity with st.async stores that
// complete on CTA j's exchange mbarrier of this parity, which its thread
// 0 arms for the bytes it expects; every CTA then adds its `parts` slots
// in the same fixed order.
struct Exchange {
  float* part;        // [2][3][pp]
  uint64_t* bar;      // [2]
  int pp, parts, slot, cluster;
  uint32_t phase;     // bit p: the phase of exchange mbarrier p
  int parity;         // of the exchange in flight

  template <int N>
  __device__ __forceinline__ void send(float* v) {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
    const int lane = threadIdx.x & 31;
    float* mine = part + parity * 3 * pp;
    if (lane < cluster) {
      const uint32_t rb = map_rank(smem_addr(bar + parity), lane);
#pragma unroll
      for (int n = 0; n < N; ++n)
        store_async(map_rank(smem_addr(mine + n * pp + slot), lane), v[n],
                    rb);
    }
    if (threadIdx.x == 0) mbar_expect(smem_addr(bar + parity), 4 * N * parts);
  }

  template <int N>
  __device__ __forceinline__ void finish(float* v) {
    mbar_wait(smem_addr(bar + parity), (phase >> parity) & 1u);
    phase ^= 1u << parity;
    const float* mine = part + parity * 3 * pp;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float4* q4 = reinterpret_cast<const float4*>(mine + n * pp);
      float t = 0.f;
      for (int i = 0; i < pp / 4; ++i) {
        const float4 u = q4[i];
        t += (u.x + u.y) + (u.z + u.w);
      }
      v[n] = t;
    }
    parity ^= 1;
  }
};

// this thread's elements of a slice, as float
template <typename T>
__device__ __forceinline__ void load_slice(float (&v)[kPerThread],
                                           const T* p, int slice) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    v[j] = i < slice ? Elem<T>::load(p, i) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    lbfgs_direction_kernel(const T* __restrict__ g, const T* __restrict__ s,
                           const T* __restrict__ y,
                           const T* __restrict__ rho,
                           const unsigned char* __restrict__ valid,
                           T* __restrict__ out, int m, int d, int cluster) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slice = d / cluster;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int warps = nt >> 5, parts = cluster * warps;
  const int pp = padded_parts(parts);
  T* gs = reinterpret_cast<T*>(smem);
  T* ss = gs + slice;                                // (m, slice)
  T* ys = ss + static_cast<size_t>(m) * slice;       // (m, slice)
  float* part = reinterpret_cast<float*>(ys + static_cast<size_t>(m) *
                                         slice);     // (2, 3, pp)
  uint64_t* gbar = reinterpret_cast<uint64_t*>(part + 6 * pp);
  uint64_t* sbar = gbar + 1;                         // (m) slot k landed
  uint64_t* xbar = sbar + m;                         // (2) exchanges
  float* alpha = reinterpret_cast<float*>(xbar + 2);  // (m)
  float* rhos = alpha + m;                           // (m)
  int* idx = reinterpret_cast<int*>(rhos + m);  // (m + 1) valid slots
  unsigned char* vs = reinterpret_cast<unsigned char*>(idx + m + 1);  // (m)

  const int rank = static_cast<int>(cluster_rank());
  const int lb = blockIdx.x / cluster;  // the solver lane
  const size_t base = static_cast<size_t>(lb) * m;

  for (int k = tid; k < m; k += nt) {
    rhos[k] = Elem<T>::load(rho + base, k);
    vs[k] = valid[base + k];
    mbar_init(smem_addr(sbar + k), 1);
  }
  for (int i = tid; i < 6 * pp; i += nt) part[i] = 0.f;  // padding stays 0
  if (tid < 32) {  // the valid slots' indices, oldest first; their count
    int n = 0;
    for (int k0 = 0; k0 < m; k0 += 32) {
      const bool v = k0 + tid < m && valid[base + k0 + tid];
      const unsigned mask = __ballot_sync(0xffffffffu, v);
      if (v) idx[n + __popc(mask & ((1u << tid) - 1u))] = k0 + tid;
      n += __popc(mask);
    }
    if (tid == 0) idx[m] = n;
  }
  if (tid == 0) {
    mbar_init(smem_addr(gbar), 1);
    mbar_init(smem_addr(xbar), 1);
    mbar_init(smem_addr(xbar + 1), 1);
  }
  __syncthreads();

  // warp 0: the bulk copies of g and the valid s, y slots, each slot on
  // its own mbarrier, newest first, so loop 1 starts on the newest slot
  // while older ones land
  if (tid < 32) {
    const uint32_t bytes = static_cast<uint32_t>(slice * sizeof(T));
    const size_t off = static_cast<size_t>(rank) * slice;
    if (tid == 0) {
      mbar_expect(smem_addr(gbar), bytes);
      bulk_load(smem_addr(gs), g + static_cast<size_t>(lb) * d + off, bytes,
                smem_addr(gbar));
    }
    for (int k = m - 1 - tid; k >= 0; k -= 32) {
      if (!vs[k]) continue;
      const uint32_t b = smem_addr(sbar + k);
      const size_t row = (base + k) * d + off;
      const size_t at = static_cast<size_t>(k) * slice;
      mbar_expect(b, 2 * bytes);
      bulk_load(smem_addr(ss + at), s + row, bytes, b);
      bulk_load(smem_addr(ys + at), y + row, bytes, b);
    }
  }
  // every CTA of the cluster has initialised its mbarriers and partials
  // before any remote store reaches them
  cluster_arrive();
  cluster_wait();
  const int n_valid = idx[m];
  Exchange x{part, xbar, pp, parts, rank * warps + (tid >> 5), cluster, 0u,
             0};

  float q[kPerThread], sv[kPerThread], yv[kPerThread];
  float sn[kPerThread], yn[kPerThread];  // the next step's s, y
  mbar_wait(smem_addr(gbar), 0);
  load_slice(q, gs, slice);

  // newest to oldest, each step's s, y and rho loaded during the previous
  // step's exchange; the newest pair's s.y and y.y ride along its step
  float gamma = 1.f, rk = 0.f;
  int i = n_valid - 1;
  if (i >= 0) {
    const int k = idx[i];
    mbar_wait(smem_addr(sbar + k), 0);
    load_slice(sv, ss + static_cast<size_t>(k) * slice, slice);
    load_slice(yv, ys + static_cast<size_t>(k) * slice, slice);
    rk = rhos[k];
  }
  // the next step's slot, loaded while this step's sums travel
  auto prefetch = [&](int kn) {
    mbar_wait(smem_addr(sbar + kn), 0);
    load_slice(sn, ss + static_cast<size_t>(kn) * slice, slice);
    load_slice(yn, ys + static_cast<size_t>(kn) * slice, slice);
    return rhos[kn];
  };
  for (; i >= 0; --i) {
    const int k = idx[i];
    float p[3] = {0.f, 0.f, 0.f}, rn = 0.f;
    if (k == m - 1) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        p[0] = __fadd_rn(p[0], __fmul_rn(sv[j], q[j]));
        p[1] = __fadd_rn(p[1], mul<T>(sv[j], yv[j]));
        p[2] = __fadd_rn(p[2], mul<T>(yv[j], yv[j]));
      }
      x.template send<3>(p);
      if (i > 0) rn = prefetch(idx[i - 1]);
      x.template finish<3>(p);
      const float sy = Elem<T>::round(p[1]), yy = Elem<T>::round(p[2]);
      if (yy > 0.f) gamma = Elem<T>::round(__fdiv_rn(sy, yy));
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        p[0] = __fadd_rn(p[0], __fmul_rn(sv[j], q[j]));
      x.template send<1>(p);
      if (i > 0) rn = prefetch(idx[i - 1]);
      x.template finish<1>(p);
    }
    const float a = mul<T>(rk, Elem<T>::round(p[0]));
    alpha[k] = a;  // the same bits from every thread
    axpy<T, -1>(q, a, yv);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      sv[j] = sn[j];
      yv[j] = yn[j];
    }
    rk = rn;
  }

  // r = gamma q, in place; oldest to newest, prefetched as loop 1
#pragma unroll
  for (int j = 0; j < kPerThread; j += 2) {
    q[j] = __fmul_rn(gamma, q[j]);
    q[j + 1] = __fmul_rn(gamma, q[j + 1]);
    Elem<T>::round2(q[j], q[j + 1]);
  }
  float ak = 0.f;
  if (n_valid > 0) {
    const int k = idx[0];
    load_slice(sv, ss + static_cast<size_t>(k) * slice, slice);
    load_slice(yv, ys + static_cast<size_t>(k) * slice, slice);
    rk = rhos[k];
    ak = alpha[k];
  }
  for (i = 0; i < n_valid; ++i) {
    float p[1] = {0.f};
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      p[0] = __fadd_rn(p[0], __fmul_rn(yv[j], q[j]));
    x.template send<1>(p);
    float rn = 0.f, an = 0.f;
    if (i + 1 < n_valid) {
      const int kn = idx[i + 1];
      load_slice(sn, ss + static_cast<size_t>(kn) * slice, slice);
      load_slice(yn, ys + static_cast<size_t>(kn) * slice, slice);
      rn = rhos[kn];
      an = alpha[kn];
    }
    x.template finish<1>(p);
    const float c = sub<T>(ak, mul<T>(rk, Elem<T>::round(p[0])));
    axpy<T, 1>(q, c, sv);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      sv[j] = sn[j];
      yv[j] = yn[j];
    }
    rk = rn;
    ak = an;
  }

  T* ol = out + static_cast<size_t>(lb) * d +
          static_cast<size_t>(rank) * slice;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid + j * nt;
    if (i < slice) Elem<T>::store(ol, i, -q[j]);
  }
}

// the shared memory a block of the current card may opt into
cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return e;
}

// threads for a slice: kPerThread elements each, whole warps
int threads_for(int slice) {
  const int per_warp = 32 * kPerThread;
  const int warps = (slice + per_warp - 1) / per_warp;
  return 32 * (warps > 1 ? warps : 1);
}

// the opt-in shared-memory limit and 16-CTA clusters, once per kernel
template <typename T>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    int optin = 0;
    cudaError_t e = smem_optin(&optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(lbfgs_direction_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(lbfgs_direction_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    return e;
  }();
  return err;
}

// the launch configuration, or an error for one the kernel cannot take
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int elem, int B, int m, int d, int cluster,
                      int threads, cudaStream_t stream) {
  if (cluster < 1 || d % cluster != 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const int slice = d / cluster;
  if ((slice * elem) % 16 != 0 || slice > threads * kPerThread)
    return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(B) * cluster);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes =
      smem_bytes(elem, m, slice, cluster * (threads / 32));
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int launch(const void* g, const void* s, const void* y, const void* rho,
           const void* valid, void* out, int B, int m, int d, int cluster,
           int threads, void* stream) {
  cudaError_t e = prepare<T>();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  e = configure(&cfg, &attr, sizeof(T), B, m, d, cluster, threads,
                static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, lbfgs_direction_kernel<T>,
                         static_cast<const T*>(g), static_cast<const T*>(s),
                         static_cast<const T*>(y),
                         static_cast<const T*>(rho),
                         static_cast<const unsigned char*>(valid),
                         static_cast<T*>(out), m, d, cluster);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int max_clusters(int m, int d, int cluster, int threads, int* count) {
  *count = 0;
  cudaError_t e = prepare<T>();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  e = configure(&cfg, &attr, sizeof(T), 1, m, d, cluster, threads, nullptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveClusters(count, lbfgs_direction_kernel<T>, &cfg);
  if (e != cudaSuccess) cudaGetLastError();  // not left for the next launch
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// The launch for lanes of m slots and d elements of `elem` bytes on the
// current card: the smallest cluster whose slice fits its shared memory
// with at most kBestThreads threads a CTA, else the largest that fits
// (the kernel is latency-bound: one warp per scheduler and few partial
// sums a step beat covering the SMs, so the lane count does not enter).
// *cluster = 0 where none fits.  Returns a CUDA error code.
int lbfgs_direction_plan(int elem, int m, int d, int* cluster, int* threads,
                         int* smem) {
  *cluster = *threads = *smem = 0;
  int optin = 0;
  const cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (const int c : kClusters) {
    if (d % c != 0 || (d / c * elem) % 16 != 0) continue;
    const int slice = d / c, t = threads_for(slice);
    const size_t need = smem_bytes(elem, m, slice, c * (t / 32));
    if (t > kMaxThreads || need > static_cast<size_t>(optin)) continue;
    *cluster = c;
    *threads = t;
    *smem = static_cast<int>(need);
    if (t <= kBestThreads) break;
  }
  return 0;
}

// grad (B, d), s/y (B, m, d), rho (B, m) of one element type (bf16 != 0:
// __nv_bfloat16, else float); valid (B, m) bytes (0/1); out (B, d).
// `cluster` CTAs of `threads` threads per lane, with the shared memory
// their slice needs.  Returns cudaGetLastError() after the launch, or the
// error that refused it.
int lbfgs_direction_launch(int bf16, const void* g, const void* s,
                           const void* y, const void* rho, const void* valid,
                           void* out, int B, int m, int d, int cluster,
                           int threads, void* stream) {
  auto* fn = bf16 ? launch<__nv_bfloat16> : launch<float>;
  return fn(g, s, y, rho, valid, out, B, m, d, cluster, threads, stream);
}

// *count = how many such clusters the card can hold at once
// (cudaOccupancyMaxActiveClusters); 0 means it cannot schedule one.
int lbfgs_direction_max_clusters(int bf16, int m, int d, int cluster,
                                 int threads, int* count) {
  auto* fn = bf16 ? max_clusters<__nv_bfloat16> : max_clusters<float>;
  return fn(m, d, cluster, threads, count);
}

}  // extern "C"
