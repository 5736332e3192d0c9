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
// leaky slope 0.01, its mask set where the pre-activation >= 0 (as JAX);
// y (T, 45) is the pose (channel j*3 + c of frame t is point t*15 + j,
// coordinate c); e and g = dE/dy are the energy core of
// csrc/energy_core.cuh, read and written in y's channel layout; the
// backward runs the transposed convs down to dE/dh0.
//
// What bounds it on the H100, and the design.  A row's chain is 20.5
// MFLOP (2*2*(3T-2)*sum(Cin*Cout) at 512-256-128-64-64-64-45) against
// 2.2 MB of weights each way (549,312 floats), shared by every row.  A
// design of one row a block, each thread streaming its channel's taps
// from L2 into float32 FMAs, reads 4.4 MB of weights from L2 per row.
// Here each layer is a matrix product (Cout, 3*Cin) x (3*Cin, columns) on
// the tensor cores, for the block's RB rows at once:
//
// - wgmma.m64nNk8 TF32 (sm_90a), one warpgroup per 64 output channels
//   (4 warpgroups, 512 threads).  A = the weights, from registers: the
//   host packs each pass in mma fragment order ([k-step][m16-tile][lane]
//   [4]), so a warp loads its 16 rows with one 16-byte shared load a
//   lane.  B = the activation, from shared memory through a descriptor
//   (no swizzle, K-major core matrices of 8 columns x 4 channels).  K is
//   ordered (channel block of 8, tap, channel) and the activation is
//   kept as [channel group of 4][slot][4]: the block's rows' frames in
//   slots of T + 2 (both ends zero, so the SAME padding never reads a
//   neighbouring row) plus one zero slot at each end, so a tap is the
//   descriptor shifted by one 16-byte slot.  N = the rows' slots rounded
//   up to 8 (16, 24, 40 or 48 for 1-4 rows).
// - 3xTF32: each operand splits into big = cvt.rna.tf32(x) (done with two
//   integer operations) and small = x - big (exact; the tensor core reads
//   it as TF32, dropping its low bits); big.big + big.small + small.big.
//   The weights split in registers as they are loaded, the activations
//   once when written (a big and a small half).  The tensor cores'
//   float32 sums truncate, so each channel block's nine products go into
//   a fresh accumulator that is added to the running sum with one
//   rounded float32 add: a chain over all of K lost 30x float32's
//   accuracy; this keeps the pose within 1e-7 of float64 (a single TF32
//   pass misses the checks' bars, tests/test_torch_fused_decode.py::
//   test_tf32_split_keeps_the_chip_bars).
// - The weights stream once per block, for all of its rows, through a
//   ring of S stages: one cp.async.bulk per chunk of whole channel blocks,
//   completing on the stage's full mbarrier; the last warp done with a
//   stage refills it at once (a shared counter).  The first layer's h0 is
//   staged with its weights (16-byte cp.async per row, frame and 4
//   channels, arriving on the same mbarrier) and split in the stage;
//   dE/dh0 goes from the last backward pass's accumulators to device
//   memory.  Resident: the activations' ping-pong pair (big and small
//   halves) and each LeakyReLU mask as bits (a warp ballot per
//   accumulator register, 720 bytes a row); no layer input is kept for
//   the backward.  The energy core (block barriers, one thread a point)
//   gives each row its own 5 warps, up to 3 rows at once: one row at a
//   time left 362 of the 512 threads idle while the tensor cores wait.
// - What bounds it now: the weight stream.  Every chunk costs about a
//   microsecond whatever its work, and each CTA streams all 4.4 MB; the
//   tensor work is about 130 us of a 3-row CTA's 410 (PERF.md section 6).
//   So the plan (fused_decode_energy_plan) weighs larger chunks (48 KB
//   stages, fewer rows fit) against more rows a CTA (24 KB stages) with a
//   cost model fitted on the card, waves x (185 us + 1.0 us a chunk):
//   192 rows: 2 rows a CTA, 48 KB, 96 CTAs; 384: 3, 24 KB, 128; 768: 3,
//   24 KB, 256; 1,200: 4, 24 KB, 300.  L2 bytes a launch reads: CTAs x
//   4.4 MB (at 384 rows 563 MB against 1.69 GB at one row a block).
//   Cluster size 1:
//   a cluster of 2 sharing multicast loads measured slower (PERF.md).  A
//   chain the plan cannot hold returns RB=0 (the wrapper raises
//   ValueError).
//
// Layout of `weights` (float32, built by ops/fused_decode_energy.py::
// pack_layers): the passes in order, forward layers 0..n-1 then backward
// layers n-1..0, each split into passes of at most 16 m-tiles (256
// output channels); a pass's A (M, K) in fragment order; then each
// forward layer's bias padded to its M.  Forward A[co][(cb, tap, c)] =
// K_tap[cb*8+c][co]; backward A[ci][(cb, tap, c)] = K_{2-tap}[ci][cb*8+c]
// (the input transpose); M padded to 16, the K channels to 8, with
// zeros.  The energy context as in csrc/fused_energy.cu (anchor
// (B, 3, L), crops (B, k*k, L) float or bf16, ox, oy, bone (B, L), wvec
// (8), poly (P)).

#include <cstdint>

#include "energy_core.cuh"

namespace {

constexpr int kT = 10;            // frames per window
constexpr int kSlots = kT + 2;    // a row's frame slots, both ends zero
constexpr int kMaxLayers = 8;
constexpr int kMaxPasses = 2 * kMaxLayers + 8;
constexpr int kWarps = 16;        // 4 warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRB = 4;         // rows a block: N = 48 columns
constexpr int kMaxMT = 16;        // m16-tiles a pass: 4 warpgroups of 64
// bytes of weights a stage may hold: two or one channel blocks of a
// 256-row pass (fewer, larger chunks cost less, but take shared memory
// that rows a CTA would otherwise use)
constexpr int kStageSizes[] = {49152, 24576};
constexpr int kMaxStages = 8;
// the energy core runs on groups of whole warps, one row a group, as many
// rows at once as groups fit the block
constexpr int kEnergyThreads = 160;  // >= the L = 150 points of a row
constexpr int kEnergyRows = kThreads / kEnergyThreads;
// the plan's cost model, in microseconds a wave of CTAs: a fixed part and
// a part for each weight chunk a CTA streams (fitted to this kernel's
// times on an H100 SXM at 700 W; PERF.md section 6)
constexpr double kWaveUs = 185.0, kChunkUs = 1.0;

enum Kind { kFwdHidden = 0, kFwdLast = 1, kBwdHidden = 2, kBwdFirst = 3 };

struct Pass {
  long long frag;    // float offset of the fragments in `weights`
  long long bias;    // float offset of the bias (forward kinds)
  int mt;            // m16-tiles (16 output channels each)
  int m0;            // first output channel of this pass
  int mout;          // output channels of the layer
  int ncb;           // K channel blocks of 8 (K = 3 * 8 * ncb)
  int cbpc;          // channel blocks a chunk
  int kind;
  int src;           // -1: the staged h0 tile; 0/1: activation buffer
  int src_half;      // floats of the source's big half (its small follows)
  int dst;           // activation buffer (0/1) of the hidden kinds
  int dst_half;
  int mask;          // word offset of the layer's mask (hidden kinds)
  int chunk0;        // index of the pass's first chunk in the sequence
  int nchunks;
};

struct Plan {
  int n_passes, first_bwd, chunks;
  Pass p[kMaxPasses];
  int rb, stages, stage_floats, stage_bytes;
  int h0_raw, h0_split;   // float offsets in a stage of the h0 tiles
  int buf_floats[2];      // each activation buffer
  int mask_words;
  int ybuf;               // buffer of y, then of dE/dy
  int c0;
  int smem;               // bytes
  long long weight_floats;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
// B columns of a block: its rows' frame slots, in whole 8-column tiles
__host__ __device__ inline int ncols(int rb) { return ceil_div(rb * kSlots, 8) * 8; }
// shared-memory slots of an activation: the columns and one zero slot at
// each end, so that every tap's shifted window stays inside
__host__ __device__ inline int nslots(int rb) { return ncols(rb) + 2; }

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
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

// 16 bytes global -> shared (cp.async, L2 only)
__device__ __forceinline__ void copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies land
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// this thread's generic-proxy shared-memory writes, before the tensor
// cores read them through descriptors
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// x = big + small for the tensor cores: big = cvt.rna.tf32.f32(x) (round
// to nearest, ties away, on the low 13 bits) in two integer operations;
// small = x - big exactly, which the tensor core reads as TF32 by
// dropping its low 13 bits
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// shared-memory matrix descriptor, no swizzle, K-major: core matrices of
// 8 columns x 16 bytes (4 TF32), `lbo` bytes apart along K, `sbo` along N
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fffu) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.m64nNk8 TF32, A (64 x 8) from registers (each warp of the
// warpgroup 16 rows, the mma.m16n8k8 A fragment), B (8 x N) from shared
// memory through a descriptor, D += A B (D = A B where scale_d = 0)
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<24> {
  static __device__ __forceinline__ void mma(float (&d)[12],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<40> {
  static __device__ __forceinline__ void mma(float (&d)[20],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

struct Ring {
  float* stage;       // S stages of stage_floats
  uint64_t* full;     // [S]
  int* released;      // [S]: warps done with the stage's chunk
  int stages, stage_floats;
};

// A warp issues chunk c of the sequence into stage c % S: lane 0 one bulk
// copy of the pass's weights for the chunk's channel blocks, completing
// on the stage's full mbarrier; for a pass that reads h0, the lanes copy
// each valid row's frames of those channels (two 16-byte cp.async, one
// per group of 4 channels) into the raw h0 tile, and every lane arrives
// on the mbarrier once its copies land (1 + 32 arrivals a phase).
__device__ void issue_chunk(const Plan& pl, const Ring& ring, int c,
                            const float* __restrict__ weights,
                            const float* __restrict__ h0, int row0,
                            int vrows) {
  int pi = 0;
  while (c >= pl.p[pi].chunk0 + pl.p[pi].nchunks) ++pi;
  const Pass& p = pl.p[pi];
  const int cb0 = (c - p.chunk0) * p.cbpc;
  const int cbs = imin(p.cbpc, p.ncb - cb0);
  const uint32_t wbytes = 3u * cbs * p.mt * 512u;
  const int s = c % ring.stages;
  float* dst = ring.stage + static_cast<size_t>(s) * ring.stage_floats;
  const uint32_t bar = smem_addr(ring.full + s);
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_expect(bar, wbytes);
    bulk_load(smem_addr(dst),
              weights + p.frag + static_cast<long long>(cb0) * 3 * p.mt * 128,
              wbytes, bar);
  }
  const int ns = nslots(pl.rb);
  const int copies = p.src < 0 ? cbs * vrows * kT * 2 : 0;
  for (int q = lane; q < copies; q += 32) {
    const int kg = q & 1, rest = q >> 1;
    const int cbl = rest / (vrows * kT), rt = rest % (vrows * kT);
    const int r = rt / kT, t = rt % kT;
    float* d = dst + pl.h0_raw + ((cbl * 2 + kg) * ns + r * kSlots + t + 2) * 4;
    const float* src = h0 + (static_cast<size_t>(row0 + r) * kT + t) * pl.c0 +
                       (cb0 + cbl) * 8 + 4 * kg;
    copy16(smem_addr(d), src);
  }
  copies_arrive(bar);
}

// One pass on the tensor cores (the pass by value: its fields stay in
// registers): warpgroup wg computes the pass's m64-tile
// wg (output channels m0 + 64 wg ...) over all N columns, the chain's
// weights as A (each warp loads and splits its 16 rows' fragment, one
// 16-byte load a lane), the activation's big and small halves as B; per
// channel block the three taps' three products (small.big, big.small,
// big.big) go into tmp and then one rounded float32 add into acc (the
// tensor cores' float32 sums truncate; a chain over all of K lost 30x
// float32's accuracy).  Then the epilogue.
template <int N>
__device__ void run_pass(const Plan& pl, const Pass p, const Ring& ring,
                         const float* __restrict__ weights,
                         const float* __restrict__ h0, float* buf0,
                         float* buf1, uint32_t* masks, int row0, int vrows,
                         float* __restrict__ gh0, float* ybuf) {
  constexpr int NT = N / 8, ND = N / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;
  const int tile = warp;                   // m16-tile: 4 wg + warp % 4
  const bool active = 4 * wg < p.mt;       // warpgroup-uniform
  const bool has = tile < p.mt;            // warp-uniform
  const int ns = nslots(pl.rb);
  const uint32_t lbo = ns * 16;

  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;

  const float* src_buf = p.src == 0 ? buf0 : buf1;
  for (int jc = 0; jc < p.nchunks; ++jc) {
    const int c = p.chunk0 + jc;
    const int s = c % ring.stages;
    float* st = ring.stage + static_cast<size_t>(s) * ring.stage_floats;
    mbar_wait(smem_addr(ring.full + s), (c / ring.stages) & 1);
    const int cb0 = jc * p.cbpc;
    const int cbs = imin(p.cbpc, p.ncb - cb0);
    if (p.src < 0) {
      // the raw h0 tile into its big and small halves (zero slots too)
      const int n = cbs * 8 * ns;
      float* raw = st + pl.h0_raw;
      float* big = st + pl.h0_split;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int cbl = i / (8 * ns), rest = i % (8 * ns);
        uint32_t b, sm;
        split(raw[i], b, sm);
        big[cbl * 16 * ns + rest] = __uint_as_float(b);
        big[cbl * 16 * ns + 8 * ns + rest] = __uint_as_float(sm);
      }
      fence_async_smem();
      __syncthreads();
    }
    if (active) {
      for (int cbl = 0; cbl < cbs; ++cbl) {
        uint32_t bb, bs;  // the channel block's big and small B bases
        if (p.src < 0) {
          bb = smem_addr(st + pl.h0_split + cbl * 16 * ns);
          bs = bb + 8 * ns * 4;
        } else {
          bb = smem_addr(src_buf + (cb0 + cbl) * 8 * ns);
          bs = bb + p.src_half * 4;
        }
        uint32_t ab[3][4], as[3][4];
#pragma unroll
        for (int tap = 0; tap < 3; ++tap) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (has)
            v = *reinterpret_cast<const float4*>(
                st + (((cbl * 3 + tap) * p.mt + tile) * 32 + lane) * 4);
          split(v.x, ab[tap][0], as[tap][0]);
          split(v.y, ab[tap][1], as[tap][1]);
          split(v.z, ab[tap][2], as[tap][2]);
          split(v.w, ab[tap][3], as[tap][3]);
        }
        float tmp[ND];
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 3; ++tap) {
          // column n reads slot n + tap - 1, at shared slot n + tap
          const uint64_t db = smem_desc(bb + tap * 16, lbo, 128);
          const uint64_t ds = smem_desc(bs + tap * 16, lbo, 128);
          Wgmma<N>::mma(tmp, as[tap], db, tap > 0);
          Wgmma<N>::mma(tmp, ab[tap], ds, 1);
          Wgmma<N>::mma(tmp, ab[tap], db, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(tmp);
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[i] += tmp[i];
      }
    }
    // the last warp done with the stage refills it with chunk c + S
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(ring.released + s, 1) == kWarps - 1;
      if (last) ring.released[s] = 0;
    }
    last = __shfl_sync(0xffffffffu, last, 0);
    if (last && c + ring.stages < pl.chunks)
      issue_chunk(pl, ring, c + ring.stages, weights, h0, row0, vrows);
  }

  // epilogue: D fragment i of warp tile: m = 16 tile + g + 8 ((i >> 1) & 1),
  // column n = 8 (i >> 2) + 2 t4 + (i & 1), the frame slot n of the block
  float* dst = p.dst == 0 ? buf0 : buf1;
  if (has) {
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int nt = i >> 2, q = i & 3;
      const int m = p.m0 + tile * 16 + g + (q >= 2 ? 8 : 0);
      const int n = nt * 8 + 2 * t4 + (q & 1);
      const int r = n / kSlots, f = n % kSlots;
      const bool frame = r < pl.rb && f >= 1 && f <= kT;
      float v = acc[i];
      const int word = p.mask + ((p.m0 / 16 + tile) * NT + nt) * 4 + q;
      if (p.kind == kFwdHidden || p.kind == kFwdLast)
        v += m < p.mout ? __ldg(weights + p.bias + m) : 0.f;
      if (p.kind == kFwdHidden) {
        const uint32_t bits = __ballot_sync(0xffffffffu, v >= 0.f);
        if (lane == 0) masks[word] = bits;
        v = v >= 0.f ? v : 0.01f * v;
      } else if (p.kind == kBwdHidden) {
        if (!((masks[word] >> lane) & 1u)) v *= 0.01f;
      }
      if (m >= p.mout) continue;
      if (p.kind == kFwdLast) {
        if (frame) ybuf[r * kT * 3 * kJ + (f - 1) * 3 * kJ + m] = v;
      } else if (p.kind == kBwdFirst) {
        if (frame && r < vrows)
          gh0[(static_cast<size_t>(row0 + r) * kT + f - 1) * pl.c0 + m] = v;
      } else {
        uint32_t b, sm;
        split(frame ? v : 0.f, b, sm);  // a zero slot stays zero
        float* o = dst + ((m >> 2) * ns + n + 1) * 4 + (m & 3);
        o[0] = __uint_as_float(b);
        o[p.dst_half] = __uint_as_float(sm);
      }
    }
  }
  // the output's end slots and pad channels, zero for the next pass
  if ((p.kind == kFwdHidden || p.kind == kBwdHidden) && p.m0 == 0) {
    const int cpad = ceil_div(p.mout, 8) * 8;
    for (int i = threadIdx.x; i < cpad * ns; i += kThreads) {
      const int ch = i / ns, slot = i % ns;
      if (slot == 0 || slot == ns - 1 || ch >= p.mout) {
        float* o = dst + ((ch >> 2) * ns + slot) * 4 + (ch & 3);
        o[0] = 0.f;
        o[p.dst_half] = 0.f;
      }
    }
  }
  fence_async_smem();
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1) fused_decode_energy_kernel(
    const float* __restrict__ h0, const float* __restrict__ weights,
    const __grid_constant__ Plan pl, int rows, int B,
    const float* __restrict__ anchor, const void* __restrict__ crops,
    int crop_bf16, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ bone,
    const float* __restrict__ wvec, const float* __restrict__ poly,
    int npoly, int L, int k, float sx, float sy, float crop_offset,
    float* __restrict__ e_out, float* __restrict__ gh0,
    float* __restrict__ pose_out, float* __restrict__ gpose_out) {
  extern __shared__ __align__(128) float smem[];
  Ring ring;
  ring.stage = smem;
  ring.stages = pl.stages;
  ring.stage_floats = pl.stage_floats;
  float* buf0 = smem + static_cast<size_t>(pl.stages) * pl.stage_floats;
  float* buf1 = buf0 + pl.buf_floats[0];
  uint32_t* masks = reinterpret_cast<uint32_t*>(buf1 + pl.buf_floats[1]);
  float* scratch = reinterpret_cast<float*>(masks + pl.mask_words);
  float* sred = scratch + kEnergyRows * 6 * L;  // (5, 32)
  ring.full = reinterpret_cast<uint64_t*>(sred + 5 * 32);
  ring.released = reinterpret_cast<int*>(ring.full + pl.stages);

  const int row0 = blockIdx.x * pl.rb;
  const int vrows = imax(0, imin(pl.rb, rows - row0));
  const int ns = nslots(pl.rb);

  // zero everything before the barriers (the h0 tiles' zero slots and
  // rows past the end stay zero; the copies write the rest)
  {
    float4* z = reinterpret_cast<float4*>(smem);
    const int n4 = static_cast<int>(reinterpret_cast<float*>(ring.full) -
                                    smem) / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  fence_async_smem();
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      mbar_init(smem_addr(ring.full + s), 1 + 32);
      ring.released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32)
    for (int c = 0; c < imin(pl.stages, pl.chunks); ++c)
      issue_chunk(pl, ring, c, weights, h0, row0, vrows);

  float* ybuf = pl.ybuf == 0 ? buf0 : buf1;
  float* gbuf = pl.ybuf == 0 ? buf1 : buf0;  // compact dE/dy
  for (int pi = 0; pi < pl.n_passes; ++pi) {
    if (pi == pl.first_bwd) {
      // the energy, kEnergyRows rows at once (one group of kEnergyThreads
      // threads each; a group past the block's rows works on none), g =
      // dE/dy in y's channel layout; the W2C polynomial stays in memory
      // (16 more live registers spilled the 128-register wgmma loops)
      const int grp = threadIdx.x / kEnergyThreads;
      float* sa = scratch + imin(grp, kEnergyRows - 1) * 6 * L;
      float* sr = sa + 3 * L;
      const int l = threadIdx.x - grp * kEnergyThreads;
      for (int r0 = 0; r0 < vrows; r0 += kEnergyRows) {
        const bool present = grp < kEnergyRows && r0 + grp < vrows;
        const RowThreads rt{l, grp * (kEnergyThreads / 32),
                            kEnergyThreads / 32, present};
        const bool live = present && l < L;
        const int r = present ? r0 + grp : r0;
        const int row = row0 + r;
        const size_t ctx = static_cast<size_t>(row % B) * L;
        float* y = ybuf + r * kT * 3 * kJ;
        float* gr = gbuf + r * kT * 3 * kJ;
        const float px = live ? y[3 * l] : 0.f;
        const float py = live ? y[3 * l + 1] : 0.f;
        const float pz = live ? y[3 * l + 2] : 0.f;
        if (crop_bf16) {
          const WindowContext<__nv_bfloat16> win{
              anchor + 3 * ctx,
              static_cast<const __nv_bfloat16*>(crops) + ctx * k * k,
              ox + ctx, oy + ctx, bone + ctx};
          energy_row<true, __nv_bfloat16, 0>(
              rt, px, py, pz, load_context<true>(win, l, L, live), y,
              PointLayout{1, 3}, false, sa, sr, sred, win.crops, wvec, poly,
              npoly, L, k, sx, sy, crop_offset, gr, PointLayout{1, 3},
              e_out + row);
        } else {
          const WindowContext<float> win{
              anchor + 3 * ctx, static_cast<const float*>(crops) + ctx * k * k,
              ox + ctx, oy + ctx, bone + ctx};
          energy_row<true, float, 0>(
              rt, px, py, pz, load_context<true>(win, l, L, live), y,
              PointLayout{1, 3}, false, sa, sr, sred, win.crops, wvec, poly,
              npoly, L, k, sx, sy, crop_offset, gr, PointLayout{1, 3},
              e_out + row);
        }
      }
      if (pose_out != nullptr) {  // the checking path's view of the pose
        for (int i = threadIdx.x; i < vrows * 3 * L; i += kThreads) {
          const int r = i / (3 * L), j = i % (3 * L);
          const int c = j / L, l = j - c * L;
          const size_t o = static_cast<size_t>(row0 + r) * 3 * L + j;
          pose_out[o] = ybuf[r * kT * 3 * kJ + 3 * l + c];
          gpose_out[o] = gbuf[r * kT * 3 * kJ + 3 * l + c];
        }
      }
      __syncthreads();
      // dE/dy into the first backward pass's source (big and small
      // halves), end slots, zero frame slots, pad channels and rows past
      // the end zero
      const Pass& p = pl.p[pi];
      const int cpad = p.ncb * 8;
      float* dst = p.src == 0 ? buf0 : buf1;
      for (int i = threadIdx.x; i < cpad * ns; i += kThreads) {
        const int ch = i / ns, slot = i % ns, n = slot - 1;
        const int r = n / kSlots, f = n % kSlots;
        float v = 0.f;
        if (n >= 0 && n < ncols(pl.rb) && r < vrows && f >= 1 && f <= kT &&
            ch < 3 * kJ)
          v = gbuf[r * kT * 3 * kJ + (f - 1) * 3 * kJ + ch];
        uint32_t b, sm;
        split(v, b, sm);
        float* o = dst + ((ch >> 2) * ns + slot) * 4 + (ch & 3);
        o[0] = __uint_as_float(b);
        o[p.src_half] = __uint_as_float(sm);
      }
      fence_async_smem();
      __syncthreads();
    }
    run_pass<N>(pl, pl.p[pi], ring, weights, h0, buf0, buf1, masks, row0,
                vrows, gh0, ybuf);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// host: the plan and the launch
// ---------------------------------------------------------------------------

// The passes of a chain for `rb` rows a block and `stages` ring stages of
// `stage_bytes` of weights; returns false where the chain is outside the
// kernel's range.
bool build_plan(const int* dims, int n, int rb, int stages, int stage_bytes,
                Plan* pl) {
  if (n < 1 || n > kMaxLayers || dims[n] != 3 * kJ) return false;
  if (dims[0] % 8 != 0) return false;  // h0 tiles of whole channel blocks
  *pl = Plan{};
  pl->rb = rb;
  pl->stages = stages;
  pl->stage_bytes = stage_bytes;
  pl->c0 = dims[0];
  const int nt = ncols(rb) / 8, ns = nslots(rb);
  long long off = 0;
  int stage_w = 0, h0_cb = 0, mask_words = 0, chunks = 0;
  int mask_off[kMaxLayers], cap[2] = {0, 0};
  for (int i = 0; i + 1 < n; ++i) {
    mask_off[i] = mask_words;
    mask_words += ceil_div(dims[i + 1], 16) * nt * 4;
  }
  int np = 0;
  int cur = (n - 1) % 2;  // y's buffer, then dE/dy's split copy
  pl->ybuf = cur;
  for (int step = 0; step < 2 * n; ++step) {
    const bool bwd = step >= n;
    const int i = bwd ? 2 * n - 1 - step : step;
    const int m = bwd ? dims[i] : dims[i + 1];
    const int kch = bwd ? dims[i + 1] : dims[i];
    const int ncb = ceil_div(kch, 8), mt_all = ceil_div(m, 16);
    if (bwd && step == n) pl->first_bwd = np;
    for (int t0 = 0; t0 < mt_all; t0 += kMaxMT) {
      if (np == kMaxPasses) return false;
      Pass& p = pl->p[np++];
      p.frag = off;
      p.mt = imin(kMaxMT, mt_all - t0);
      p.m0 = t0 * 16;
      p.mout = m;
      p.ncb = ncb;
      const int cb_bytes = 3 * p.mt * 512;
      p.cbpc = imax(1, imin(ncb, stage_bytes / cb_bytes));
      stage_w = imax(stage_w, p.cbpc * cb_bytes);
      p.nchunks = ceil_div(ncb, p.cbpc);
      p.chunk0 = chunks;
      chunks += p.nchunks;
      off += static_cast<long long>(ncb) * 3 * p.mt * 128;
      if (!bwd) {
        p.kind = i + 1 < n ? kFwdHidden : kFwdLast;
        p.src = i == 0 ? -1 : (i - 1) % 2;
        p.dst = i % 2;
        if (i + 1 < n) p.mask = mask_off[i];
        if (i == 0) h0_cb = imax(h0_cb, p.cbpc);
      } else {
        p.kind = i > 0 ? kBwdHidden : kBwdFirst;
        p.src = cur;
        p.dst = 1 - cur;
        if (i > 0) p.mask = mask_off[i - 1];
      }
      p.src_half = ncb * 8 * ns;
      p.dst_half = ceil_div(m, 8) * 8 * ns;
      if (p.src >= 0) cap[p.src] = imax(cap[p.src], 2 * p.src_half);
      if (p.kind == kFwdHidden || p.kind == kBwdHidden)
        cap[p.dst] = imax(cap[p.dst], 2 * p.dst_half);
    }
    if (bwd) cur = 1 - cur;
  }
  // each forward layer's bias after the fragments, padded to 16
  long long boff = off;
  for (int q = 0; q < pl->first_bwd; ++q) {
    Pass& p = pl->p[q];
    if (p.m0 > 0) {
      p.bias = pl->p[q - 1].bias;
      continue;
    }
    p.bias = boff;
    boff += ceil_div(p.mout, 16) * 16;
  }
  pl->n_passes = np;
  pl->chunks = chunks;
  pl->weight_floats = boff;
  const int compact = rb * kT * 3 * kJ;  // y and dE/dy of the block's rows
  for (int b = 0; b < 2; ++b)
    pl->buf_floats[b] = (imax(cap[b], compact) + 31) / 32 * 32;
  pl->mask_words = (mask_words + 3) / 4 * 4;
  pl->h0_raw = stage_w / 4;
  pl->h0_split = pl->h0_raw + h0_cb * 8 * ns;
  pl->stage_floats = (pl->h0_split + h0_cb * 16 * ns + 31) / 32 * 32;
  const int L = kT * kJ;
  const long long floats = static_cast<long long>(stages) * pl->stage_floats +
                           pl->buf_floats[0] + pl->buf_floats[1] +
                           pl->mask_words + kEnergyRows * 6 * L + 5 * 32;
  pl->smem = static_cast<int>(floats * 4 + 16 * stages);
  return true;
}

cudaError_t device_limits(int* sms, int* optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return e;
}

// The launch for `rows` rows: for each stage size and each count of rows
// a CTA (1 to kMaxRB), the most ring stages (kMaxStages down to 2) that
// fit the opt-in shared memory; of those, the one the cost model gives
// the least time: waves x (kWaveUs + kChunkUs x chunks a CTA streams),
// waves = CTAs over the SMs; on a tie, the deeper ring.  False where nothing
// fits, or the chain is outside the kernel's range.
bool choose(const int* dims, int n, int rows, int sms, int optin, Plan* pl) {
  bool found = false;
  double best = 0.0;
  for (const int stage_bytes : kStageSizes) {
    for (int rb = 1; rb <= kMaxRB; ++rb) {
      Plan cand;
      bool fits = false;
      for (int stages = kMaxStages; stages >= 2 && !fits; --stages) {
        if (!build_plan(dims, n, rb, stages, stage_bytes, &cand)) return false;
        fits = cand.smem <= optin;
      }
      if (!fits) continue;
      const double t = ceil_div(ceil_div(rows, rb), sms) *
                       (kWaveUs + kChunkUs * cand.chunks);
      if (!found || t < best || (t == best && cand.stages > pl->stages)) {
        found = true;
        best = t;
        *pl = cand;
      }
    }
  }
  return found;
}

template <int N>
cudaError_t launch_n(const Plan& pl, int ctas, const void* h0,
                     const void* weights, int rows, int B, const void* anchor,
                     const void* crops, int crop_bf16, const void* ox,
                     const void* oy, const void* bone, const void* wvec,
                     const void* poly, int npoly, int L, int k, float sx,
                     float sy, float crop_offset, void* e, void* gh0,
                     void* pose_out, void* gpose_out, cudaStream_t stream) {
  auto kernel = fused_decode_energy_kernel<N>;
  // once per instantiation, before any graph capture can reach it
  static const cudaError_t opt_in = [&] {
    int sms = 0, optin = 0;
    cudaError_t err = device_limits(&sms, &optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    return err;
  }();
  if (opt_in != cudaSuccess) return opt_in;
  kernel<<<ctas, kThreads, pl.smem, stream>>>(
      static_cast<const float*>(h0), static_cast<const float*>(weights), pl,
      rows, B, static_cast<const float*>(anchor), crops, crop_bf16,
      static_cast<const float*>(ox), static_cast<const float*>(oy),
      static_cast<const float*>(bone), static_cast<const float*>(wvec),
      static_cast<const float*>(poly), npoly, L, k, sx, sy, crop_offset,
      static_cast<float*>(e), static_cast<float*>(gh0),
      static_cast<float*>(pose_out), static_cast<float*>(gpose_out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan for a chain dims (n_layers + 1: C0, ..., Cn, Cn = 45) over
// `rows` (probe, window) rows on the current device: out[0..6] = rows a
// CTA (0: the kernel cannot take this chain), CTAs a cluster, CTAs, ring
// stages, dynamic shared memory bytes, floats of the packed weights,
// bytes of weights a stage holds;
// *l2_bytes = the weight bytes the launch's CTAs read from L2.  Returns a
// CUDA error code (0 = asked).
int fused_decode_energy_plan(const int* dims, int n_layers, int rows,
                             long long* out, long long* l2_bytes) {
  for (int i = 0; i < 7; ++i) out[i] = 0;
  *l2_bytes = 0;
  int sms = 0, optin = 0;
  const cudaError_t e = device_limits(&sms, &optin);
  if (e != cudaSuccess) return static_cast<int>(e);
  Plan pl;
  if (rows < 1 || !choose(dims, n_layers, rows, sms, optin, &pl)) return 0;
  const int ctas = ceil_div(rows, pl.rb);
  out[0] = pl.rb;
  out[1] = 1;
  out[2] = ctas;
  out[3] = pl.stages;
  out[4] = pl.smem;
  out[5] = pl.weight_floats;
  out[6] = pl.stage_bytes;
  *l2_bytes = 4LL * ctas * pl.weight_floats;
  return 0;
}

// h0 (R*B, T, C0) float32, `weights` as pack_layers builds them for these
// dims; pose_out and gpose_out (R*B, 3, L) may be null; when given they
// receive the decoded pose and dE/dpose coordinate-major.  Returns a CUDA
// error code (0 = launched; cudaErrorInvalidValue for a chain the plan
// cannot take).
int fused_decode_stage_energy_launch(
    const void* h0, const void* weights, const int* dims, int n_layers,
    const void* anchor, const void* crops, int crop_bf16, const void* ox,
    const void* oy, const void* bone, const void* wvec, const void* poly,
    int npoly, void* e, void* gh0, void* pose_out, void* gpose_out, int R,
    int B, int L, int k, float sx, float sy, float crop_offset,
    void* stream) {
  const int rows = R * B;
  if (L != kT * kJ || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, optin = 0;
  const cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan pl;
  if (!choose(dims, n_layers, rows, sms, optin, &pl))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = ceil_div(rows, pl.rb);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FDE_LAUNCH(N)                                                      \
  return static_cast<int>(launch_n<N>(                                     \
      pl, ctas, h0, weights, rows, B, anchor, crops, crop_bf16, ox, oy,    \
      bone, wvec, poly, npoly, L, k, sx, sy, crop_offset, e, gh0,          \
      pose_out, gpose_out, st))
  switch (ncols(pl.rb)) {
    case 16: FDE_LAUNCH(16);
    case 24: FDE_LAUNCH(24);
    case 40: FDE_LAUNCH(40);
    case 48: FDE_LAUNCH(48);
  }
#undef FDE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
