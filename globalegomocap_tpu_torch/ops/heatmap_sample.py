"""Bilinear sampling of full heatmaps, forward and backward.

Replaces the Pallas TPU kernel `heatmap_sample_pallas` of
`globalegomocap_tpu/ops/pallas/heatmap_sample.py` (forward `_forward`,
custom-VJP backward `_bwd_rule`): maps (N, H, W) float32 or bfloat16 (math
in float32), points (..., N, 2) in [-1, 1] -> (..., N), with
align_corners=True and zero padding.  The leading axes of the points are
probe rows that share the maps (the JAX kernel under `vmap` with unbatched
maps), so the R probes of one line-search call read the maps once.

The gradient flows to the points only, through the triangle kernel's a.e.
derivative: per axis dw/di = -sign(i - c) where |i - c| < 1, else 0, so an
exact integer coordinate has derivative 0 along that axis (the TPU
backward's convention; a floor-based 4-tap derivative would give the
one-sided difference there).  The maps get no gradient.

Dispatch: a CUDA tensor launches `csrc/heatmap_sample.cu` (built and bound
by `ops/cuda_build.py`) or raises; a CPU tensor runs the plain version
below, the dense triangle-weight form with its own explicit backward.
"""

from __future__ import annotations

import ctypes

import torch

from globalegomocap_tpu_torch.ops import cuda_build

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "heatmap_sample_fwd_launch": (
        [_VP, _CI, _VP, _VP, _CI, _CI, _CI, _CI, _VP], _CI),
    "heatmap_sample_bwd_launch": (
        [_VP, _CI, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _VP], _CI),
}
_MAP_DTYPES = (torch.float32, torch.bfloat16)


def _library():
    return cuda_build.library("heatmap_sample", _SIGNATURES)


def _check(maps, points):
    """-> (R, N, H, W): R is the product of the points' leading axes."""
    if maps.dim() != 3:
        raise ValueError(f"maps must be (N, H, W), got {tuple(maps.shape)}")
    n, h, w = maps.shape
    if points.dim() < 2 or points.shape[-2:] != (n, 2):
        raise ValueError(f"points must be (..., {n}, 2), got "
                         f"{tuple(points.shape)}")
    dev = maps.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    cuda_build.expect(maps, "maps", (n, h, w), _MAP_DTYPES, dev)
    cuda_build.expect(points, "points", tuple(points.shape),
                      (torch.float32,), dev)
    r = points.numel() // (2 * n) if n else 0
    if r < 1 or n < 1 or h < 1 or w < 1:
        raise ValueError("empty maps or points")
    if r * n >= 2 ** 31:
        raise ValueError("more than 2**31 - 1 points")
    if dev.type == "cuda" and points.data_ptr() % 8:
        raise ValueError("points must be 8-byte aligned (float2 loads)")
    return r, n, h, w


# ---------------------------------------------------------------------------
# plain PyTorch version (dense triangle weights, as the TPU kernel)
# ---------------------------------------------------------------------------

def _axis_weights(coord, size):
    """(..., N) pixel coordinates -> triangle weights and their a.e.
    derivatives over the `size` cells, each (..., N, size)."""
    a = coord[..., None] - torch.arange(size, dtype=coord.dtype,
                                        device=coord.device)
    wgt = torch.clamp(1.0 - a.abs(), min=0.0)
    dwt = torch.where(a.abs() < 1.0, -torch.sign(a), torch.zeros_like(a))
    return wgt, dwt


def _pixels(points, h, w):
    sx, sy = 0.5 * (w - 1), 0.5 * (h - 1)
    return (points[..., 0] + 1.0) * sx, (points[..., 1] + 1.0) * sy, sx, sy


def plain_forward(maps, points):
    """maps (N, H, W), points (R, N, 2) -> (R, N)."""
    n, h, w = maps.shape
    ix, iy, _, _ = _pixels(points, h, w)
    wx, _ = _axis_weights(ix, w)
    wy, _ = _axis_weights(iy, h)
    inner = torch.einsum("nhw,rnw->rnh", maps.to(torch.float32), wx)
    return (inner * wy).sum(-1)


def plain_backward(maps, points, g):
    """d(sum g * sample)/dpoints: (R, N, 2)."""
    n, h, w = maps.shape
    ix, iy, sx, sy = _pixels(points, h, w)
    wx, dwx = _axis_weights(ix, w)
    wy, dwy = _axis_weights(iy, h)
    m = maps.to(torch.float32)
    dix = (torch.einsum("nhw,rnw->rnh", m, dwx) * wy).sum(-1)
    diy = (torch.einsum("nhw,rnw->rnh", m, wx) * dwy).sum(-1)
    return torch.stack([g * dix * sx, g * diy * sy], dim=-1)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def heatmap_sample_fwd(maps, points):
    """Samples (..., N): the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    r, n, h, w = _check(maps, points)
    lead = points.shape[:-2]
    dev = maps.device
    if cuda_build.use_plain(dev):
        return plain_forward(maps, points.reshape(r, n, 2)).reshape(
            lead + (n,))
    out = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    err = _library().heatmap_sample_fwd_launch(
        maps.data_ptr(), int(maps.dtype == torch.bfloat16),
        points.data_ptr(), out.data_ptr(), r, n, h, w,
        cuda_build.stream_of(dev))
    cuda_build.launched("heatmap_sample", err)
    return out


def heatmap_sample_bwd(maps, points, g):
    """d(sum g * sample)/dpoints (..., N, 2) for the cotangent g (..., N)."""
    r, n, h, w = _check(maps, points)
    dev = maps.device
    cuda_build.expect(g, "g", points.shape[:-1], (torch.float32,), dev)
    if cuda_build.use_plain(dev):
        return plain_backward(maps, points.reshape(r, n, 2),
                              g.reshape(r, n)).reshape(points.shape)
    dpts = torch.empty_like(points)
    err = _library().heatmap_sample_bwd_launch(
        maps.data_ptr(), int(maps.dtype == torch.bfloat16),
        points.data_ptr(), g.data_ptr(), dpts.data_ptr(), r, n, h, w,
        cuda_build.stream_of(dev))
    cuda_build.launched("heatmap_sample_bwd", err)
    return dpts


class _HeatmapSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, maps, points):
        ctx.save_for_backward(maps, points)
        return heatmap_sample_fwd(maps, points)

    @staticmethod
    def backward(ctx, g):
        maps, points = ctx.saved_tensors
        # the maps are constants of the solve: no cotangent
        return None, heatmap_sample_bwd(maps, points, g.contiguous())


def heatmap_sample(maps, points):
    """maps (N, H, W), points (..., N, 2) in [-1, 1] -> (..., N) bilinear
    samples (align_corners=True, zero padding), differentiable in the
    points."""
    return _HeatmapSample.apply(maps, points)
