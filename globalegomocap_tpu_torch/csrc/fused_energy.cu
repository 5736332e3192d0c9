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
// l = t*15 + j.  The row's pose sits in shared memory for the three
// neighbour accesses that make this a poor fit for a block-of-lanes
// model: the acceleration term (shifts by J and 2J), the bone term
// (the parent joint) and the bone gradient (a gather over the children,
// replacing the TPU kernel's (L, L) difference matmul).  The five energy
// parts are reduced with warp shuffles and one fixed-order pass over the
// warps: deterministic, no atomics.
//
// Bound on the H100 (what limits it): the crop context dominates the
// bytes (k*k*L values per window), the dense k*k cell loop the operations
// (~14 per cell and point); at the production shapes the bytes bound it.
// The kernel reads each crop value once per probe row; the R > 1 rows
// of a window re-read it (mostly from L2).

#include "energy_core.cuh"

namespace {

template <bool WITH_REPROJ, typename CropT>
__global__ void fused_energy_kernel(
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

  const int row = blockIdx.x;  // r * B + b
  const int b = row % B;
  const int l = threadIdx.x;
  const float* prow = pose + static_cast<size_t>(row) * 3 * L;
  if (l < L) {
    sp[l] = prow[l];
    sp[L + l] = prow[L + l];
    sp[2 * L + l] = prow[2 * L + l];
  }
  __syncthreads();

  const size_t ctx = static_cast<size_t>(b) * L;
  WindowContext<CropT> w{anchor + 3 * ctx,
                         WITH_REPROJ ? crops + ctx * k * k : nullptr,
                         WITH_REPROJ ? ox + ctx : nullptr,
                         WITH_REPROJ ? oy + ctx : nullptr, bone + ctx};
  energy_row<WITH_REPROJ, CropT>(
      sp, PointLayout{L, 1}, sa, sr, sred, w, wvec, poly, npoly, L, k, sx,
      sy, crop_offset, g_out + static_cast<size_t>(row) * 3 * L,
      PointLayout{L, 1}, e_out + row);
}

template <bool WITH_REPROJ, typename CropT>
int launch(const void* pose, const void* anchor, const void* crops,
           const void* ox, const void* oy, const void* bone,
           const void* wvec, const void* poly, int npoly, void* e, void* g,
           int R, int B, int L, int k, float sx, float sy,
           float crop_offset, void* stream) {
  const int threads = ((L + 31) / 32) * 32;
  const size_t smem = (9 * static_cast<size_t>(L) + 5 * 32) * sizeof(float);
  fused_energy_kernel<WITH_REPROJ, CropT>
      <<<R * B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
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
