// Fused stage energy: value and analytic pose-gradient of the per-window
// stage energy in one pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of globalegomocap_tpu/ops/pallas/
// fused_energy.py: `fused_stage_energy` (WITH_REPROJ = true, stage 1) and
// `fused_stage_energy_noreproj` (WITH_REPROJ = false, stage 2), which share
// `_energy_core`.  The energy and its hand-written gradient g = dE/dpose
// are the device code of csrc/energy_core.cuh, which kernel 5
// (csrc/fused_decode_energy.cu) shares; the caller's backward is ct * g.
//
// Layout (the JAX package's): pose (R, B, 3, L) with L = T*15 points,
// coordinate-major; anchor (B, 3, L); crops (B, k*k, L) cell-major,
// float or bf16 (upcast, all math float32); ox, oy, bone (B, L);
// wvec (8) = [w3d, smooth, bone, vae, reproj, cx, cy, 0]; poly (P) the
// ascending W2C polynomial.  The R probe rows of a window read the same
// context (index b only), as the TPU grid does.
//
// Design: one block per (probe r, window b) row, one thread per point
// l = t*15 + j (the plan, `fused_energy_plan`, takes L <= 1024; one row a
// block was faster on the card than a window's R probe rows sharing a
// block, PERF.md section 6).  The row's pose sits in shared memory for
// the three neighbour accesses that make this a poor fit for a
// block-of-lanes model: the acceleration term (shifts by J and 2J), the
// bone term (the parent joint) and the bone gradient (a gather over the
// children, replacing the TPU kernel's (L, L) difference matmul).  Each thread
// issues its pose, context and polynomial loads together, then its four
// crop-tap loads (the TPU kernel's dense k*k cell contraction becomes a
// 2 x 2 gather, csrc/taps.cuh), which land while the block passes the
// neighbour terms' barriers.  So a launch waits on two round trips to
// memory, whatever k is.  The five energy parts are reduced with warp
// shuffles and one fixed-order pass over the warps: deterministic, no
// atomics.
//
// Bound on the H100 (what limits it): the bytes: the pose in and g out,
// the window context once, and the 32-byte crop sectors that hold an
// in-range tap (about a third of the crops at k=8, a tenth at k=16, for
// chip_smoke.py's inputs); about 220 float32 operations a point.  At the
// serve shapes (384 rows) that is about 1 us, less than a launch and a
// few dependent steps cost: there the launch, the two round trips and the
// chain of barriers set the time; at 3840 windows also the scattered
// 2-byte tap loads (one L1 wavefront each).  PERF.md section 6 has the
// measurements.

#include "energy_core.cuh"

namespace {

constexpr int kMaxThreads = 1024;       // threads a block
constexpr int kPolyRegs = 16;           // W2C coefficients in registers

struct Plan {
  int threads;  // L rounded up to whole warps
  int smem;     // pose, acceleration, bone residual (3, L) each, (5, 32)
  int blocks;   // R * B
};

// The launch for R probe rows of B windows of L points: false where a row
// does not fit a block (L > 1024).
bool choose(int R, int B, int L, Plan* p) {
  if (R < 1 || B < 1 || L < 1) return false;
  p->threads = (L + 31) / 32 * 32;
  if (p->threads > kMaxThreads) return false;
  p->smem = static_cast<int>((9 * static_cast<size_t>(L) + 5 * 32) *
                             sizeof(float));
  p->blocks = R * B;
  return true;
}

// Block r * B + b takes probe row r of window b.
template <bool WITH_REPROJ, typename CropT>
__global__ void __launch_bounds__(kMaxThreads) fused_energy_kernel(
    const float* __restrict__ pose, const float* __restrict__ anchor,
    const CropT* __restrict__ crops, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ bone,
    const float* __restrict__ wvec, const float* __restrict__ poly,
    int npoly, float* __restrict__ e_out, float* __restrict__ g_out, int B,
    int L, int k, float sx, float sy, float crop_offset) {
  extern __shared__ float smem[];
  float* sp = smem;            // (3, L) the row's pose
  float* sa = smem + 3 * L;    // (3, L) acceleration
  float* sr = smem + 6 * L;    // (3, L) bone residual r * db
  float* sred = smem + 9 * L;  // (5, 32) per-warp partial sums

  const size_t row = blockIdx.x;  // r * B + b
  const int b = static_cast<int>(row % B);
  const int l = threadIdx.x;
  const bool live = l < L;
  const size_t ctx = static_cast<size_t>(b) * L;
  const WindowContext<CropT> w{anchor + 3 * ctx,
                               WITH_REPROJ ? crops + ctx * k * k : nullptr,
                               WITH_REPROJ ? ox + ctx : nullptr,
                               WITH_REPROJ ? oy + ctx : nullptr, bone + ctx};
  // the pose and the context, all loads issued before the first barrier
  const PointContext c = load_context<WITH_REPROJ>(w, l, L, live);
  const float* prow = pose + row * 3 * L;
  const float px = live ? prow[l] : 0.f;
  const float py = live ? prow[L + l] : 0.f;
  const float pz = live ? prow[2 * L + l] : 0.f;
  energy_row<WITH_REPROJ, CropT, kPolyRegs>(
      RowThreads{l, 0, static_cast<int>(blockDim.x) / 32, true}, px, py, pz,
      c, sp, PointLayout{L, 1}, true, sa, sr, sred, w.crops, wvec, poly,
      npoly, L, k, sx, sy, crop_offset, g_out + row * 3 * L,
      PointLayout{L, 1}, e_out + row);
}

__global__ void noop_kernel() {}

template <bool WITH_REPROJ, typename CropT>
int launch(const void* pose, const void* anchor, const void* crops,
           const void* ox, const void* oy, const void* bone,
           const void* wvec, const void* poly, int npoly, void* e, void* g,
           int R, int B, int L, int k, float sx, float sy,
           float crop_offset, void* stream) {
  Plan p;
  if (!choose(R, B, L, &p)) return static_cast<int>(cudaErrorInvalidValue);
  fused_energy_kernel<WITH_REPROJ, CropT>
      <<<p.blocks, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(pose), static_cast<const float*>(anchor),
          static_cast<const CropT*>(crops), static_cast<const float*>(ox),
          static_cast<const float*>(oy), static_cast<const float*>(bone),
          static_cast<const float*>(wvec), static_cast<const float*>(poly),
          npoly, static_cast<float*>(e), static_cast<float*>(g), B, L, k, sx,
          sy, crop_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The plan for R probe rows of B windows of L points: out[0..2] = threads
// a block, dynamic shared memory bytes, blocks (one row a block).  Returns
// 0 where the kernel cannot take L (a row must fit a block), else 1.
int fused_energy_plan(int R, int B, int L, int* out) {
  Plan p;
  if (!choose(R, B, L, &p)) return 0;
  out[0] = p.threads;
  out[1] = p.smem;
  out[2] = p.blocks;
  return 1;
}

// One block of one thread that does nothing: the floor of a launch.
int fused_energy_noop_launch(void* stream) {
  noop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Stage-1 energy (with projection and crop sampling).  crop_bf16 selects
// the crop element type.  Returns cudaGetLastError() after the launch.
int fused_stage_energy_launch(const void* pose, const void* anchor,
                              const void* crops, int crop_bf16,
                              const void* ox, const void* oy,
                              const void* bone, const void* wvec,
                              const void* poly, int npoly, void* e, void* g,
                              int R, int B, int L, int k, float sx, float sy,
                              float crop_offset, void* stream) {
  if (crop_bf16)
    return launch<true, __nv_bfloat16>(pose, anchor, crops, ox, oy, bone,
                                       wvec, poly, npoly, e, g, R, B, L, k,
                                       sx, sy, crop_offset, stream);
  return launch<true, float>(pose, anchor, crops, ox, oy, bone, wvec, poly,
                             npoly, e, g, R, B, L, k, sx, sy, crop_offset,
                             stream);
}

// Stage-2 energy (3d, acceleration, bone and vae terms only).
int fused_stage_energy_noreproj_launch(const void* pose, const void* anchor,
                                       const void* bone, const void* wvec,
                                       void* e, void* g, int R, int B, int L,
                                       void* stream) {
  return launch<false, float>(pose, anchor, nullptr, nullptr, nullptr, bone,
                              wvec, nullptr, 0, e, g, R, B, L, 0, 0.f, 0.f,
                              0.f, stream);
}

}  // extern "C"
