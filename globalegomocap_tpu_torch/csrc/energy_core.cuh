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
//
// The cell sum reads only the 2 x 2 taps around (ix, iy) (csrc/taps.cuh),
// where the TPU kernel contracts all k*k cells: the four loads issue
// together, one round trip whatever k is.  The taps' terms are the dense
// sum's non-zero terms, added in its cell order and rounded after each
// operation (the other cells' terms are exact zeros), so that for the
// same (ix, iy), neither NaN, they equal the plain version's dense terms
// summed in cell order.  tests/test_torch_fused_energy.py checks a
// PyTorch transcription of this arithmetic bit for bit; the kernels are
// held to chip_smoke.py's `agreement` tolerances.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "taps.cuh"

namespace {

constexpr int kJ = 15;
constexpr float kEps = 1e-9f;  // fisheye ||xy|| guard

// KINEMATIC_PARENTS (the root, joint 0, is its own parent) and each
// joint's children (-1 = none; the root's self-edge excluded), packed
// four bits a joint into immediates: a table in constant memory would
// serialize, since the 32 points of a warp are up to 15 different joints.
constexpr int kParentOf[kJ] = {0, 0, 1, 2, 0, 4, 5, 1, 7, 8, 9, 4, 11, 12,
                               13};
constexpr int kFirstChild[kJ] = {1, 2, 3, -1, 5, 6, -1, 8, 9, 10, -1, 12,
                                 13, 14, -1};
constexpr int kSecondChild[kJ] = {4, 7, -1, -1, 11, -1, -1, -1, -1, -1, -1,
                                  -1, -1, -1, -1};

constexpr unsigned long long pack_joints(const int (&v)[kJ], int add) {
  unsigned long long bits = 0;
  for (int j = 0; j < kJ; ++j)
    bits |= static_cast<unsigned long long>(v[j] + add) << (4 * j);
  return bits;
}
constexpr unsigned long long kParentBits = pack_joints(kParentOf, 0);
constexpr unsigned long long kFirstChildBits = pack_joints(kFirstChild, 1);
constexpr unsigned long long kSecondChildBits = pack_joints(kSecondChild, 1);

__device__ __forceinline__ int parent_of(int j) {
  return static_cast<int>((kParentBits >> (4 * j)) & 15u);
}
// child q (0 or 1) of joint j, or -1
__device__ __forceinline__ int child_of(int j, int q) {
  const unsigned long long bits = q == 0 ? kFirstChildBits : kSecondChildBits;
  return static_cast<int>((bits >> (4 * j)) & 15u) - 1;
}

// acc + c * w1 * w2, rounded after each operation (no multiply-add
// contraction), as the plain version and the CPU test's transcription of
// the taps compute each term
__device__ __forceinline__ float add_term(float acc, float c, float w1,
                                          float w2) {
  return __fadd_rn(acc, __fmul_rn(__fmul_rn(c, w1), w2));
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

// One point's part of the window context, in registers.
struct PointContext {
  float ax, ay, az, bone, ox, oy;
};

// Read point l's context (zeros where `live` is false).  A caller issues
// these loads together with its pose loads, before its first barrier.
template <bool WITH_REPROJ, typename CropT>
__device__ __forceinline__ PointContext load_context(
    const WindowContext<CropT>& w, int l, int L, bool live) {
  PointContext c{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    c.ax = w.anchor[l];
    c.ay = w.anchor[L + l];
    c.az = w.anchor[2 * L + l];
    c.bone = w.bone[l];
    if constexpr (WITH_REPROJ) {
      c.ox = w.ox[l];
      c.oy = w.oy[l];
    }
  }
  return c;
}

// The threads of a block that work on one row: this thread's point l
// (l >= L for a thread past the row's points), the row's warps
// [w0, w0 + nwarps) of the block, and `present` false for a group of
// threads that has no row.
struct RowThreads {
  int l, w0, nwarps;
  bool present;
};

// Energy and gradient of one (probe, window) row.  Every thread of the
// block calls it (it holds barriers); the block may hold several rows,
// each on its own whole warps (`t`).  (px, py, pz) is the thread's own
// point (0 past the row), `c` its context from load_context; `sp` is the
// row's pose in shared memory: with `store_pose` the call writes the
// thread's point there, else the caller has (either way the call's first
// barrier makes it visible).  sa and sr are (3, L) shared scratch of the
// row, sred (5, 32) shared partial sums of the block.  Writes g = dE/dpose
// through `gl` and, from the row's first thread, its energy to *e.
//
// Before the first barrier each point computes its own terms and issues
// its four crop-tap loads; they land while the block passes the barriers
// of the neighbour terms (acceleration, bone).  The five parts are reduced
// with warp shuffles and one fixed-order pass over the row's warps:
// deterministic, no atomics.  Ends with a barrier, so the scratch can be
// reused by the next row at once.
template <bool WITH_REPROJ, typename CropT, int kPolyRegs>
__device__ void energy_row(RowThreads t, float px, float py, float pz,
                           PointContext c, float* sp, PointLayout pl,
                           bool store_pose,
                           float* sa, float* sr, float* sred,
                           const CropT* __restrict__ crops,
                           const float* __restrict__ wvec,
                           const float* __restrict__ poly, int npoly, int L,
                           int k, float sx, float sy, float crop_offset,
                           float* g, PointLayout gl, float* e) {
  const int l = t.l;
  const bool live = t.present && l < L;
  auto pose = [&](int cc, int i) { return sp[cc * pl.cs + i * pl.ps]; };

  const float w3d = wvec[0], w_sm = wvec[1], w_bone = wvec[2];
  const float w_vae = wvec[3], w_rep = wvec[4];
  // the W2C polynomial's kPolyRegs low coefficients in registers, loaded
  // with the pose (0 past npoly: leading zeros leave Horner's rule exact);
  // the higher ones are read in the loop
  float pc[kPolyRegs > 0 ? kPolyRegs : 1];
#pragma unroll
  for (int i = 0; i < kPolyRegs; ++i)
    pc[i] = WITH_REPROJ && i < npoly ? poly[i] : 0.f;

  // energy parts: 3d, acceleration, bone, vae, reprojection
  float part[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  const float dx3 = px - c.ax, dy3 = py - c.ay, dz3 = pz - c.az;
  // the projection's image-pixel partials and the crop taps, kept across
  // the barriers
  float dPx_dx = 0.f, dPx_dy = 0.f, dPx_dz = 0.f;
  float dPy_dx = 0.f, dPy_dy = 0.f, dPy_dz = 0.f;
  Axis tapx = {0, false, false, 0.f, 0.f}, tapy = tapx;
  float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
  if (live) {
    part[0] = dx3 * dx3 + dy3 * dy3 + dz3 * dz3;
    part[3] = px * px + py * py + pz * pz;

    if constexpr (WITH_REPROJ) {
      const float cx = wvec[5], cy = wvec[6];
      // fisheye W2C projection with hand-derived partials
      const float z2 = -pz;
      const float n = sqrtf(px * px + py * py);
      const float ns = fmaxf(n, kEps);
      const float inv_ns = 1.f / ns;
      const float u = z2 * inv_ns;
      const float theta = atanf(u);
      float rho = 0.f, drho = 0.f;
      for (int i = npoly - 1; i >= kPolyRegs; --i) rho = rho * theta + poly[i];
      for (int i = npoly - 1; i >= (kPolyRegs > 1 ? kPolyRegs : 1); --i)
        drho = drho * theta + poly[i] * static_cast<float>(i);
#pragma unroll
      for (int i = kPolyRegs - 1; i >= 0; --i) rho = rho * theta + pc[i];
#pragma unroll
      for (int i = kPolyRegs - 1; i >= 1; --i)
        drho = drho * theta + pc[i] * static_cast<float>(i);
      const float inv = rho * inv_ns;
      const float ix = ((px * inv + cx) - crop_offset) * sx - c.ox;
      const float iy = (py * inv + cy) * sy - c.oy;

      // the 2 x 2 taps (align_corners, zero padding): four independent
      // loads, in flight across the barriers below
      tapx = axis_taps(ix, k);
      tapy = axis_taps(iy, k);
      const CropT* col = crops + l;
      c00 = tap(col, k, L, tapy, false, tapx, false);
      c01 = tap(col, k, L, tapy, false, tapx, true);
      c10 = tap(col, k, L, tapy, true, tapx, false);
      c11 = tap(col, k, L, tapy, true, tapx, true);

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
      dPx_dx = inv + px * dinv_dx;
      dPx_dy = px * dinv_dy;
      dPx_dz = px * dinv_dz;
      dPy_dx = py * dinv_dx;
      dPy_dy = inv + py * dinv_dy;
      dPy_dz = py * dinv_dz;
    }
    if (store_pose) {
      sp[l * pl.ps] = px;
      sp[pl.cs + l * pl.ps] = py;
      sp[2 * pl.cs + l * pl.ps] = pz;
    }
  }
  __syncthreads();  // the rows' poses in shared memory

  if (live) {
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
    const int par = l - j + parent_of(j);
    const float dbx = px - pose(0, par);
    const float dby = py - pose(1, par);
    const float dbz = pz - pose(2, par);
    const float sq = dbx * dbx + dby * dby + dbz * dbz;
    const bool nz = sq > 0.f;
    const float bl = nz ? sqrtf(sq) : 0.f;
    const float diff = bl - c.bone;
    part[2] = diff * diff;
    const float r = nz ? 2.f * diff / bl : 0.f;
    sr[l] = r * dbx;
    sr[L + l] = r * dby;
    sr[2 * L + l] = r * dbz;
  }
  __syncthreads();

  if (live) {
    float gx_rep = 0.f, gy_rep = 0.f, gz_rep = 0.f;
    if constexpr (WITH_REPROJ) {
      // the taps' terms in the dense k x k loop's order (row c0 before
      // c0 + 1, column c0 before c0 + 1); a tap outside reads 0, and the
      // other cells' terms are exact zeros
      const float wx0 = tri(tapx.a0), wx1 = tri(tapx.a1);
      const float wy0 = tri(tapy.a0), wy1 = tri(tapy.a1);
      const float dwx0 = tri_grad(tapx.a0), dwx1 = tri_grad(tapx.a1);
      const float dwy0 = tri_grad(tapy.a0), dwy1 = tri_grad(tapy.a1);
      float s = 0.f, ds_dix = 0.f, ds_diy = 0.f;
      const float tc[4] = {c00, c01, c10, c11};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float wx = q & 1 ? wx1 : wx0, dwx = q & 1 ? dwx1 : dwx0;
        const float wy = q & 2 ? wy1 : wy0, dwy = q & 2 ? dwy1 : dwy0;
        s = add_term(s, tc[q], wx, wy);
        ds_dix = add_term(ds_dix, tc[q], dwx, wy);
        ds_diy = add_term(ds_diy, tc[q], wx, dwy);
      }
      part[4] = -s;
      gx_rep = -w_rep * (ds_dix * sx * dPx_dx + ds_diy * sy * dPy_dx);
      gy_rep = -w_rep * (ds_dix * sx * dPx_dy + ds_diy * sy * dPy_dy);
      gz_rep = -w_rep * (ds_dix * sx * dPx_dz + ds_diy * sy * dPy_dz);
    }

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
      const int ch = child_of(j, q);
      if (ch < 0) break;
      const int cl = l - j + ch;
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
  if (l == 0 && t.present) {
    float tot[5];
    for (int i = 0; i < 5; ++i) {
      float v = 0.f;
      for (int wi = t.w0; wi < t.w0 + t.nwarps; ++wi) v += sred[i * 32 + wi];
      tot[i] = v;
    }
    *e = w3d * tot[0] + w_sm * tot[1] + w_bone * tot[2] + w_vae * tot[3] +
         w_rep * tot[4];
  }
  __syncthreads();
}

}  // namespace
