// The per-window stage energy and its analytic pose-gradient, device code
// shared by csrc/fused_energy.cu (stage 1 with reprojection, stage 2
// without) and csrc/fused_decode_energy.cu (the decoder conv chain, then
// the stage-1 energy).  Counterpart of `_energy_core` in
// globalegomocap_tpu/ops/pallas/fused_energy.py.  Per window row:
//
//   e = w3d*|p - a|^2 + smooth*|d2p/dt2|^2 + bone*|bl(p) - bl_mean|^2
//       + vae*|p|^2 - reproj * sum_cells crop * tri(ix - cx) * tri(iy - cy)
//
// with (ix, iy) the fisheye projection of p in crop-cell coordinates.
// One thread per point l = t*15 + j; the row's pose is in shared memory,
// read through a (coordinate, point) stride pair so that both the
// coordinate-major (3, L) layout and the decoder's (T, 45) channel layout
// (channel j*3 + c of frame t is point l, coordinate c: offset 3*l + c)
// are read in place.

#pragma once

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

// Where coordinate c of point l lives: base[c * cs + l * ps].
struct PointLayout {
  int cs, ps;
};

// Energy context of one window b: its rows of anchor (3, L), crops
// (k*k, L), ox, oy and bone (L); crops/ox/oy are unused without
// reprojection.
template <typename CropT>
struct WindowContext {
  const float* anchor;
  const CropT* crops;
  const float* ox;
  const float* oy;
  const float* bone;
};

// Energy and gradient of one (probe, window) row.  Every thread of the
// block calls it (it holds barriers).  With kGroup = 0 the block works on
// one row and thread l < L owns point l; with kGroup > 0 (whole warps,
// >= L) each group of kGroup consecutive threads works on its own row,
// passing that row's pointers and scratch, and `present` false for a
// group with no row.  `sp` is the row's pose in shared memory, written
// before a barrier; sa and sr are (3, L) shared scratch of the row and
// sred (5, 32) shared partial sums of the block.  Writes g = dE/dpose
// through `gl` and, from the row's first thread, its energy to *e.  The
// five parts are reduced with warp shuffles and one fixed-order pass over
// the row's warps: deterministic, no atomics.  Ends with a barrier, so
// the scratch can be reused by the next row at once.
template <bool WITH_REPROJ, typename CropT, int kGroup = 0>
__device__ void energy_row(const float* sp, PointLayout pl, float* sa,
                           float* sr, float* sred, WindowContext<CropT> w,
                           const float* __restrict__ wvec,
                           const float* __restrict__ poly, int npoly, int L,
                           int k, float sx, float sy, float crop_offset,
                           float* g, PointLayout gl, float* e,
                           bool present = true) {
  const int l = kGroup > 0 ? threadIdx.x % kGroup : threadIdx.x;
  const bool live = present && l < L;
  auto pose = [&](int c, int i) { return sp[c * pl.cs + i * pl.ps]; };

  const float w3d = wvec[0], w_sm = wvec[1], w_bone = wvec[2];
  const float w_vae = wvec[3], w_rep = wvec[4];

  // energy parts: 3d, acceleration, bone, vae, reprojection
  float part[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float px = 0.f, py = 0.f, pz = 0.f;
  float dx3 = 0.f, dy3 = 0.f, dz3 = 0.f;
  float gx_rep = 0.f, gy_rep = 0.f, gz_rep = 0.f;
  if (live) {
    px = pose(0, l);
    py = pose(1, l);
    pz = pose(2, l);
    dx3 = px - w.anchor[l];
    dy3 = py - w.anchor[L + l];
    dz3 = pz - w.anchor[2 * L + l];
    part[0] = dx3 * dx3 + dy3 * dy3 + dz3 * dz3;
    part[3] = px * px + py * py + pz * pz;

    if (l < L - 2 * kJ) {
      const float ax = px - 2.f * pose(0, l + kJ) + pose(0, l + 2 * kJ);
      const float ay = py - 2.f * pose(1, l + kJ) + pose(1, l + 2 * kJ);
      const float az = pz - 2.f * pose(2, l + kJ) + pose(2, l + 2 * kJ);
      sa[l] = ax;
      sa[L + l] = ay;
      sa[2 * L + l] = az;
      part[1] = ax * ax + ay * ay + az * az;
    }

    // zero-safe bone length to the parent joint of the same frame
    const int j = l % kJ;
    const int par = l - j + kParent[j];
    const float dbx = px - pose(0, par);
    const float dby = py - pose(1, par);
    const float dbz = pz - pose(2, par);
    const float sq = dbx * dbx + dby * dby + dbz * dbz;
    const bool nz = sq > 0.f;
    const float bl = nz ? sqrtf(sq) : 0.f;
    const float diff = bl - w.bone[l];
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
      const float ix = ((px * inv + cx) - crop_offset) * sx - w.ox[l];
      const float iy = (py * inv + cy) * sy - w.oy[l];

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
      const CropT* crow = w.crops + l;
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
    float* gp = g + l * gl.ps;
    gp[0] = 2.f * w3d * dx3 + w_sm * tx + w_bone * bx + 2.f * w_vae * px +
            gx_rep;
    gp[gl.cs] = 2.f * w3d * dy3 + w_sm * ty + w_bone * by +
                2.f * w_vae * py + gy_rep;
    gp[2 * gl.cs] = 2.f * w3d * dz3 + w_sm * tz + w_bone * bz +
                    2.f * w_vae * pz + gz_rep;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    float v = part[i];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sred[i * 32 + warp] = v;
  }
  __syncthreads();
  if (l == 0 && present) {
    const int w0 = kGroup > 0 ? warp : 0;
    const int nwarps = kGroup > 0 ? kGroup >> 5 : blockDim.x >> 5;
    float tot[5];
    for (int i = 0; i < 5; ++i) {
      float v = 0.f;
      for (int wi = w0; wi < w0 + nwarps; ++wi) v += sred[i * 32 + wi];
      tot[i] = v;
    }
    *e = w3d * tot[0] + w_sm * tot[1] + w_bone * tot[2] + w_vae * tot[3] +
         w_rep * tot[4];
  }
  __syncthreads();
}

}  // namespace
