"""Fused stage energies: value and analytic pose-gradient per window row.

Replaces the Pallas TPU kernels of `globalegomocap_tpu/ops/pallas/
fused_energy.py`:

  fused_stage_energy           <- fused_stage_energy (:350), stage 1
  fused_stage_energy_noreproj  <- fused_stage_energy_noreproj (:450),
                                  stage 2

Both wrappers take the JAX argument layout (pose (R, B, 3, L), anchor
(B, 3, L), crops (B, k*k, L) float32 or bfloat16, ox/oy/bone (B, L),
ctx = (wvec (1, 8), poly (1, P))) and are `torch.autograd.Function`s:
forward returns e (R, B) and keeps g = dE/dpose; backward returns
ct[..., None, None] * g, the JAX custom VJP (the TPU kernel has no
backward kernel either).

Dispatch: a CUDA tensor launches the hand-written kernel
(`csrc/fused_energy.cu`, built and bound by `ops/cuda_build.py`) or
raises; a CPU tensor runs the plain PyTorch version below, which mirrors
`_energy_core` term by term with the same hand-written gradient.
`cuda_build.LAUNCHES` counts kernel launches per wrapper.

Bound on the H100 (computed from the shapes, not measured): per stage-1
call with bf16 crops at k=8 the kernel must move about
B*(1800 anchor + 19200 crops + 1800 ox/oy/bone) + R*B*(1800 pose in +
1800 g out + 4 e) bytes and does about R*B*150*(k*k*14 + 120) float32
operations; at B=3840, R=2 that is ~115 MB (~35 us at 3.35 TB/s) against
~1.2 GFLOP (~17 us at 67 TFLOP/s): bytes bound it.  The no-reproj call
moves B*(1800 + 600) + R*B*3604 bytes for ~R*B*150*120 operations, also
bytes-bound.  chip_smoke.py measures the times; PERF.md records them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from globalegomocap_tpu_torch.ops import cuda_build
from globalegomocap_tpu_torch.ops.cuda_build import (  # noqa: F401
    LAUNCHES, expect as _expect, plain_versions_on_cuda, reset_launches,
    use_plain as _use_plain)
from globalegomocap_tpu_torch.ops.skeleton import KINEMATIC_PARENTS

_EPS = 1e-9          # fisheye ||xy|| guard
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fused_stage_energy_launch": (
        [_VP, _VP, _VP, _CI, _VP, _VP, _VP, _VP, _VP, _CI, _VP, _VP,
         _CI, _CI, _CI, _CI, _CF, _CF, _CF, _VP], _CI),
    "fused_stage_energy_noreproj_launch": (
        [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _VP], _CI),
}


def _library():
    """csrc/fused_energy.cu, built and loaded at first use."""
    return cuda_build.library("fused_energy", _SIGNATURES)


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _check_common(pose_rt, anchor_t, bone, wvec, t, j):
    if pose_rt.dim() != 4 or pose_rt.shape[2] != 3:
        raise ValueError(f"pose_rt must be (R, B, 3, L), got "
                         f"{tuple(pose_rt.shape)}")
    r, b, _, L = pose_rt.shape
    if j != len(KINEMATIC_PARENTS) or L != t * j:
        raise ValueError(f"L={L} must be t*j with j=15 (got t={t}, j={j})")
    if L > 1024:
        raise ValueError(f"L={L} exceeds one block (1024 threads)")
    if r < 1 or b < 1:
        raise ValueError("empty probe or window axis")
    dev = pose_rt.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    f32 = (torch.float32,)
    _expect(pose_rt, "pose_rt", (r, b, 3, L), f32, dev)
    _expect(anchor_t, "anchor_t", (b, 3, L), f32, dev)
    _expect(bone, "bone", (b, L), f32, dev)
    _expect(wvec, "wvec", (1, 8), f32, dev)
    return r, b, L, dev


# ---------------------------------------------------------------------------
# plain PyTorch version (mirror of _energy_core)
# ---------------------------------------------------------------------------

def difference_matrix(t: int, j: int, device=None,
                      dtype=torch.float32) -> torch.Tensor:
    """(L, L) matrix A with (A p)_i = p_i - p_parent(i) per frame (the
    root row is zero: the root is its own parent)."""
    parents = np.asarray(KINEMATIC_PARENTS)
    a = np.eye(t * j, dtype=np.float32)
    for f in range(t):
        for jj in range(j):
            a[f * j + jj, f * j + parents[jj]] -= 1.0
    return torch.as_tensor(a, device=device, dtype=dtype)


def crop_coordinates(px, py, pz, wvec, poly, sx, sy, crop_offset):
    """Fisheye projection of camera-frame points into crop-cell units
    before the origin shift: returns (ix + ox, iy + oy, partials), where
    partials = (dPx_dx, dPx_dy, dPx_dz, dPy_dx, dPy_dy, dPy_dz) are the
    image-pixel derivatives."""
    w = wvec.reshape(-1)
    cx, cy = w[5], w[6]
    coeffs = poly.reshape(-1)
    z2 = -pz
    n = torch.sqrt(px * px + py * py)
    ns = n.clamp_min(_EPS)
    inv_ns = 1.0 / ns
    u = z2 * inv_ns
    theta = torch.atan(u)
    rho = torch.zeros_like(theta)
    for i in range(coeffs.shape[0] - 1, -1, -1):
        rho = rho * theta + coeffs[i]
    drho = torch.zeros_like(theta)
    for i in range(coeffs.shape[0] - 1, 0, -1):
        drho = drho * theta + coeffs[i] * float(i)
    inv = rho * inv_ns
    ix = ((px * inv + cx) - crop_offset) * sx
    iy = (py * inv + cy) * sy

    ok = n > _EPS                    # ns is constant inside the clamp
    zero = torch.zeros_like(px)
    dns_dx = torch.where(ok, px * inv_ns, zero)
    dns_dy = torch.where(ok, py * inv_ns, zero)
    du_dx = -u * inv_ns * dns_dx
    du_dy = -u * inv_ns * dns_dy
    du_dz = -inv_ns
    dtheta = 1.0 / (1.0 + u * u)
    common = drho * dtheta * inv_ns
    dinv_dx = common * du_dx - inv * inv_ns * dns_dx
    dinv_dy = common * du_dy - inv * inv_ns * dns_dy
    dinv_dz = common * du_dz
    partials = (inv + px * dinv_dx, px * dinv_dy, px * dinv_dz,
                py * dinv_dx, inv + py * dinv_dy, py * dinv_dz)
    return ix, iy, partials


def plain_energy_and_grad(pose_rt, anchor_t, crops, ox, oy, bone, wvec,
                          poly, t, j, k, sx, sy, crop_offset,
                          with_reproj: bool = True):
    """The plain PyTorch version of both kernels on (R, B, 3, L) poses:
    returns (e (R, B), g (R, B, 3, L)).  e is built from differentiable
    ops, so autograd of e checks the hand-written g (away from the
    triangle kernel's kinks)."""
    L = t * j
    w = wvec.reshape(-1)
    w3d, w_sm, w_bone, w_vae, w_rep = w[0], w[1], w[2], w[3], w[4]
    px, py, pz = pose_rt.unbind(2)                 # (R, B, L)
    ax_, ay_, az_ = anchor_t.unbind(1)             # (B, L)

    if with_reproj:
        ix0, iy0, dP = crop_coordinates(px, py, pz, wvec, poly, sx, sy,
                                        crop_offset)
        ix = ix0 - ox
        iy = iy0 - oy
        # dense bilinear sampling over the k*k cells (align_corners, zero
        # padding) with the triangle kernel's a.e. derivative
        cell = torch.arange(k * k, device=pose_rt.device)
        cxc = (cell % k).to(pose_rt.dtype)[:, None]
        cyc = (cell // k).to(pose_rt.dtype)[:, None]
        dx = ix[..., None, :] - cxc                  # (R, B, k*k, L)
        dy = iy[..., None, :] - cyc
        wx = (1.0 - dx.abs()).clamp_min(0.0)
        wy = (1.0 - dy.abs()).clamp_min(0.0)
        zero = torch.zeros_like(dx)
        dwx = torch.where(dx.abs() < 1.0, -torch.sign(dx), zero)
        dwy = torch.where(dy.abs() < 1.0, -torch.sign(dy), zero)
        c = crops.to(pose_rt.dtype)
        s = (c * wx * wy).sum(-2)
        ds_dix = (c * dwx * wy).sum(-2)
        ds_diy = (c * wx * dwy).sum(-2)
        e_rep = -s.sum(-1)
        dPx_dx, dPx_dy, dPx_dz, dPy_dx, dPy_dy, dPy_dz = dP
        gx_rep = -w_rep * (ds_dix * sx * dPx_dx + ds_diy * sy * dPy_dx)
        gy_rep = -w_rep * (ds_dix * sx * dPx_dy + ds_diy * sy * dPy_dy)
        gz_rep = -w_rep * (ds_dix * sx * dPx_dz + ds_diy * sy * dPy_dz)
    else:
        e_rep = torch.zeros_like(px[..., 0])
        gx_rep = gy_rep = gz_rep = 0.0

    dx3, dy3, dz3 = px - ax_, py - ay_, pz - az_
    e_3d = (dx3 * dx3 + dy3 * dy3 + dz3 * dz3).sum(-1)

    def acc_of(p):
        return p[..., :L - 2 * j] - 2.0 * p[..., j:L - j] + p[..., 2 * j:]

    accx, accy, accz = acc_of(px), acc_of(py), acc_of(pz)
    e_acc = (accx * accx + accy * accy + accz * accz).sum(-1)

    def acc_t(a):
        # transpose of the second-difference operator (zero-padded shifts)
        pad = torch.nn.functional.pad
        return (pad(a, (0, 2 * j)) - 2.0 * pad(a, (j, j))
                + pad(a, (2 * j, 0)))

    amat = difference_matrix(t, j, pose_rt.device, pose_rt.dtype)
    dbx, dby, dbz = px @ amat.T, py @ amat.T, pz @ amat.T
    sq = dbx * dbx + dby * dby + dbz * dbz
    nz = sq > 0.0
    ones = torch.ones_like(sq)
    bl = torch.sqrt(torch.where(nz, sq, ones)) * nz       # zero-safe
    diff_b = bl - bone
    e_bone = (diff_b * diff_b).sum(-1)
    r = torch.where(nz, 2.0 * diff_b / torch.where(nz, bl, ones),
                    torch.zeros_like(sq))

    def bone_grad(dc):
        return (r * dc) @ amat

    e_vae = (px * px + py * py + pz * pz).sum(-1)

    e = (w3d * e_3d + w_sm * e_acc + w_bone * e_bone + w_vae * e_vae
         + w_rep * e_rep)
    gx = (2.0 * w3d * dx3 + w_sm * acc_t(2.0 * accx)
          + w_bone * bone_grad(dbx) + 2.0 * w_vae * px + gx_rep)
    gy = (2.0 * w3d * dy3 + w_sm * acc_t(2.0 * accy)
          + w_bone * bone_grad(dby) + 2.0 * w_vae * py + gy_rep)
    gz = (2.0 * w3d * dz3 + w_sm * acc_t(2.0 * accz)
          + w_bone * bone_grad(dbz) + 2.0 * w_vae * pz + gz_rep)
    return e, torch.stack([gx, gy, gz], dim=2)


# ---------------------------------------------------------------------------
# energy + gradient dispatch
# ---------------------------------------------------------------------------

def stage_energy_and_grad(pose_rt, anchor_t, crops, ox, oy, bone, wvec,
                          poly, t, j, k, full_hw, crop_offset, half_extent):
    """Stage-1 (e (R, B), g (R, B, 3, L)): the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    r, b, L, dev = _check_common(pose_rt, anchor_t, bone, wvec, t, j)
    _expect(crops, "crops", (b, k * k, L), (torch.float32, torch.bfloat16),
            dev)
    _expect(ox, "ox", (b, L), (torch.float32,), dev)
    _expect(oy, "oy", (b, L), (torch.float32,), dev)
    if poly.dim() != 2 or poly.shape[0] != 1:
        raise ValueError(f"poly must be (1, P), got {tuple(poly.shape)}")
    _expect(poly, "poly", tuple(poly.shape), (torch.float32,), dev)
    fh, fw = full_hw
    sx = (fw - 1) / (2.0 * half_extent)
    sy = (fh - 1) / (2.0 * half_extent)
    if _use_plain(dev):
        return plain_energy_and_grad(pose_rt, anchor_t, crops, ox, oy,
                                     bone, wvec, poly, t, j, k, sx, sy,
                                     crop_offset)
    e = torch.empty((r, b), dtype=torch.float32, device=dev)
    g = torch.empty_like(pose_rt)
    err = _library().fused_stage_energy_launch(
        pose_rt.data_ptr(), anchor_t.data_ptr(), crops.data_ptr(),
        int(crops.dtype == torch.bfloat16), ox.data_ptr(), oy.data_ptr(),
        bone.data_ptr(), wvec.data_ptr(), poly.data_ptr(), poly.shape[1],
        e.data_ptr(), g.data_ptr(), r, b, L, k, sx, sy, float(crop_offset),
        cuda_build.stream_of(dev))
    cuda_build.launched("fused_stage_energy", err)
    return e, g


def stage_energy_and_grad_noreproj(pose_rt, anchor_t, bone, wvec, t, j):
    """Stage-2 (e (R, B), g (R, B, 3, L)) without projection or sampling."""
    r, b, L, dev = _check_common(pose_rt, anchor_t, bone, wvec, t, j)
    if _use_plain(dev):
        return plain_energy_and_grad(pose_rt, anchor_t, None, None, None,
                                     bone, wvec, None, t, j, 0, 0.0, 0.0,
                                     0.0, with_reproj=False)
    e = torch.empty((r, b), dtype=torch.float32, device=dev)
    g = torch.empty_like(pose_rt)
    err = _library().fused_stage_energy_noreproj_launch(
        pose_rt.data_ptr(), anchor_t.data_ptr(), bone.data_ptr(),
        wvec.data_ptr(), e.data_ptr(), g.data_ptr(), r, b, L,
        cuda_build.stream_of(dev))
    cuda_build.launched("fused_stage_energy_noreproj", err)
    return e, g


class _FusedStageEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pose_rt, anchor_t, crops, ox, oy, bone, wvec, poly,
                t, j, k, full_hw, crop_offset, half_extent):
        e, g = stage_energy_and_grad(pose_rt, anchor_t, crops, ox, oy,
                                     bone, wvec, poly, t, j, k, full_hw,
                                     crop_offset, half_extent)
        ctx.save_for_backward(g)
        return e

    @staticmethod
    def backward(ctx, ct):
        (g,) = ctx.saved_tensors
        return (ct[:, :, None, None] * g,) + (None,) * 13


class _FusedStageEnergyNoreproj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pose_rt, anchor_t, bone, wvec, t, j):
        e, g = stage_energy_and_grad_noreproj(pose_rt, anchor_t, bone,
                                              wvec, t, j)
        ctx.save_for_backward(g)
        return e

    @staticmethod
    def backward(ctx, ct):
        (g,) = ctx.saved_tensors
        return (ct[:, :, None, None] * g,) + (None,) * 5


def fused_stage_energy(pose_rt, anchor_t, crops, ox, oy, bone, ctx, t, j,
                       k, full_hw, crop_offset, half_extent):
    """Per-window stage-1 energy (R, B), differentiable in pose_rt
    (R, B, 3, L).  ctx = (wvec (1, 8): [w3d, smooth, bone, vae, reproj,
    cx, cy, 0], poly (1, P)).  Non-pose inputs are constants of the
    solve and get no gradient."""
    return _FusedStageEnergy.apply(pose_rt, anchor_t, crops, ox, oy, bone,
                                   ctx[0], ctx[1], t, j, k, tuple(full_hw),
                                   crop_offset, half_extent)


def fused_stage_energy_noreproj(pose_rt, anchor_t, bone, wvec, t, j):
    """Per-window stage-2 energy (R, B), differentiable in pose_rt; the
    reproj weight in wvec is ignored (there is no sampling term)."""
    return _FusedStageEnergyNoreproj.apply(pose_rt, anchor_t, bone, wvec,
                                           t, j)
