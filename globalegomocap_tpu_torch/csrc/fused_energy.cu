// Fused stage energy: value and analytic pose-gradient of the per-window
// stage energy in one pass, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of globalegomocap_tpu/ops/pallas/
// fused_energy.py: `fused_stage_energy` (WITH_REPROJ = true, stage 1) and
// `fused_stage_energy_noreproj` (WITH_REPROJ = false, stage 2), which share
// `_energy_core`.  Per window row:
//
//   e = w3d*|p - a|^2 + smooth*|d2p/dt2|^2 + bone*|bl(p) - bl_mean|^2
//       + vae*|p|^2 - reproj * sum_cells crop * tri(ix - cx) * tri(iy - cy)
//
// with (ix, iy) the fisheye projection of p in crop-cell coordinates, and
// g = dE/dpose written out by hand (the caller's backward is ct * g).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kJ = 15;
constexpr float kEps = 1e-9f;  // fisheye ||xy|| guard

// KINEMATIC_PARENTS; the root (joint 0) is its own parent
__constant__ int kParent[kJ] = {0, 0, 1, 2, 0, 4, 5, 1, 7, 8, 9, 4, 11, 12,
                                13};
// children of each joint (-1 = none), the root's self-edge excluded
__constant__ int kChildren[kJ][2] = {
    {1, 4},  {2, 7},   {3, -1},  {-1, -1}, {5, 11},  {6, -1},  {-1, -1},
    {8, -1}, {9, -1},  {10, -1}, {-1, -1}, {12, -1}, {13, -1}, {14, -1},
    {-1, -1}};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// a.e. derivative of the triangle kernel max(0, 1 - |a|):
// -sign(a) inside |a| < 1, and 0 at a == 0 and outside
__device__ __forceinline__ float tri_grad(float a) {
  if (!(fabsf(a) < 1.f)) return 0.f;
  return a > 0.f ? -1.f : (a < 0.f ? 1.f : 0.f);
}

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
  const bool live = l < L;
  const float* prow = pose + static_cast<size_t>(row) * 3 * L;
  const float* arow = anchor + static_cast<size_t>(b) * 3 * L;
  const size_t ctx = static_cast<size_t>(b) * L + l;

  const float w3d = wvec[0], w_sm = wvec[1], w_bone = wvec[2];
  const float w_vae = wvec[3], w_rep = wvec[4];

  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    px = prow[l];
    py = prow[L + l];
    pz = prow[2 * L + l];
    sp[l] = px;
    sp[L + l] = py;
    sp[2 * L + l] = pz;
  }
  __syncthreads();

  // energy parts: 3d, acceleration, bone, vae, reprojection
  float part[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float dx3 = 0.f, dy3 = 0.f, dz3 = 0.f;
  float gx_rep = 0.f, gy_rep = 0.f, gz_rep = 0.f;
  if (live) {
    dx3 = px - arow[l];
    dy3 = py - arow[L + l];
    dz3 = pz - arow[2 * L + l];
    part[0] = dx3 * dx3 + dy3 * dy3 + dz3 * dz3;
    part[3] = px * px + py * py + pz * pz;

    if (l < L - 2 * kJ) {
      const float ax = px - 2.f * sp[l + kJ] + sp[l + 2 * kJ];
      const float ay = py - 2.f * sp[L + l + kJ] + sp[L + l + 2 * kJ];
      const float az = pz - 2.f * sp[2 * L + l + kJ] + sp[2 * L + l + 2 * kJ];
      sa[l] = ax;
      sa[L + l] = ay;
      sa[2 * L + l] = az;
      part[1] = ax * ax + ay * ay + az * az;
    }

    // zero-safe bone length to the parent joint of the same frame
    const int j = l % kJ;
    const int pl = l - j + kParent[j];
    const float dbx = px - sp[pl];
    const float dby = py - sp[L + pl];
    const float dbz = pz - sp[2 * L + pl];
    const float sq = dbx * dbx + dby * dby + dbz * dbz;
    const bool nz = sq > 0.f;
    const float bl = nz ? sqrtf(sq) : 0.f;
    const float diff = bl - bone[ctx];
    part[2] = diff * diff;
    const float r = nz ? 2.f * diff / bl : 0.f;
    sr[l] = r * dbx;
    sr[L + l] = r * dby;
    sr[2 * L + l] = r * dbz;

    if constexpr (WITH_REPROJ) {
      const float cx = wvec[5], cy = wvec[6];
      // fisheye W2C projection with hand-derived partials
      const float z2 = -pz;
      const float n = sqrtf(px * px + py * py);
      const float ns = fmaxf(n, kEps);
      const float inv_ns = 1.f / ns;
      const float u = z2 * inv_ns;
      const float theta = atanf(u);
      float rho = 0.f;
      for (int i = npoly - 1; i >= 0; --i) rho = rho * theta + poly[i];
      float drho = 0.f;
      for (int i = npoly - 1; i >= 1; --i)
        drho = drho * theta + poly[i] * static_cast<float>(i);
      const float inv = rho * inv_ns;
      const float ix = ((px * inv + cx) - crop_offset) * sx - ox[ctx];
      const float iy = (py * inv + cy) * sy - oy[ctx];

      const bool ok = n > kEps;  // ns is constant inside the clamp
      const float dns_dx = ok ? px * inv_ns : 0.f;
      const float dns_dy = ok ? py * inv_ns : 0.f;
      const float du_dx = -u * inv_ns * dns_dx;
      const float du_dy = -u * inv_ns * dns_dy;
      const float du_dz = -inv_ns;
      const float dtheta = 1.f / (1.f + u * u);
      const float common = drho * dtheta * inv_ns;
      const float dinv_dx = common * du_dx - inv * inv_ns * dns_dx;
      const float dinv_dy = common * du_dy - inv * inv_ns * dns_dy;
      const float dinv_dz = common * du_dz;
      const float dPx_dx = inv + px * dinv_dx;
      const float dPx_dy = px * dinv_dy;
      const float dPx_dz = px * dinv_dz;
      const float dPy_dx = py * dinv_dx;
      const float dPy_dy = inv + py * dinv_dy;
      const float dPy_dz = py * dinv_dz;

      // dense bilinear sampling over the k x k cells (align_corners,
      // zero padding) and its a.e. derivative; coalesced over l
      float s = 0.f, ds_dix = 0.f, ds_diy = 0.f;
      const CropT* crow = crops + static_cast<size_t>(b) * k * k * L + l;
      for (int cyi = 0; cyi < k; ++cyi) {
        const float ay = iy - static_cast<float>(cyi);
        const float wy = fmaxf(0.f, 1.f - fabsf(ay));
        const float dwy = tri_grad(ay);
        for (int cxi = 0; cxi < k; ++cxi) {
          const float ax = ix - static_cast<float>(cxi);
          const float wx = fmaxf(0.f, 1.f - fabsf(ax));
          const float dwx = tri_grad(ax);
          const float c =
              load_f32(crow + static_cast<size_t>(cyi * k + cxi) * L);
          s += c * wx * wy;
          ds_dix += c * dwx * wy;
          ds_diy += c * wx * dwy;
        }
      }
      part[4] = -s;
      gx_rep = -w_rep * (ds_dix * sx * dPx_dx + ds_diy * sy * dPy_dx);
      gy_rep = -w_rep * (ds_dix * sx * dPx_dy + ds_diy * sy * dPy_dy);
      gz_rep = -w_rep * (ds_dix * sx * dPx_dz + ds_diy * sy * dPy_dz);
    }
  }
  __syncthreads();

  if (live) {
    // transpose of the second difference: 2acc[l] - 2*2acc[l-J] + 2acc[l-2J]
    float tx = 0.f, ty = 0.f, tz = 0.f;
    if (l < L - 2 * kJ) {
      tx = 2.f * sa[l];
      ty = 2.f * sa[L + l];
      tz = 2.f * sa[2 * L + l];
    }
    if (l >= kJ && l < L - kJ) {
      tx -= 2.f * (2.f * sa[l - kJ]);
      ty -= 2.f * (2.f * sa[L + l - kJ]);
      tz -= 2.f * (2.f * sa[2 * L + l - kJ]);
    }
    if (l >= 2 * kJ) {
      tx += 2.f * sa[l - 2 * kJ];
      ty += 2.f * sa[L + l - 2 * kJ];
      tz += 2.f * sa[2 * L + l - 2 * kJ];
    }
    // bone gradient: own residual minus the children's in the same frame
    const int j = l % kJ;
    float bx = sr[l], by = sr[L + l], bz = sr[2 * L + l];
    for (int q = 0; q < 2; ++q) {
      const int c = kChildren[j][q];
      if (c < 0) break;
      const int cl = l - j + c;
      bx -= sr[cl];
      by -= sr[L + cl];
      bz -= sr[2 * L + cl];
    }
    float* grow = g_out + static_cast<size_t>(row) * 3 * L;
    grow[l] = 2.f * w3d * dx3 + w_sm * tx + w_bone * bx + 2.f * w_vae * px +
              gx_rep;
    grow[L + l] = 2.f * w3d * dy3 + w_sm * ty + w_bone * by +
                  2.f * w_vae * py + gy_rep;
    grow[2 * L + l] = 2.f * w3d * dz3 + w_sm * tz + w_bone * bz +
                      2.f * w_vae * pz + gz_rep;
  }

  // deterministic block reduction of the five parts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    float v = part[i];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sred[i * 32 + warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int nwarps = blockDim.x >> 5;
    float tot[5];
    for (int i = 0; i < 5; ++i) {
      float v = 0.f;
      for (int w = 0; w < nwarps; ++w) v += sred[i * 32 + w];
      tot[i] = v;
    }
    e_out[row] = w3d * tot[0] + w_sm * tot[1] + w_bone * tot[2] +
                 w_vae * tot[3] + w_rep * tot[4];
  }
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
