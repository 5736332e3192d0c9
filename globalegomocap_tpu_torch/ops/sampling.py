"""Bilinear sampling with `align_corners=True` and zero padding.

Counterpart of `globalegomocap_tpu/ops/sampling.py`: the `gather` (4-tap
flat gather) and `dense` (triangle weights, contracted with the maps)
choices of `sampling_impl`, differentiable in the coordinates by autograd
as the JAX versions are by `jax.grad`.

Shapes: images (*M, H, W) are M maps; coordinates (*P, *M) carry
optional leading probe axes *P that share the maps (the probe rows of a
line search), so the maps are never copied per probe.  Results are
(*P, *M).  bf16 maps are read as they are and the math runs in float32,
as JAX's type promotion does.
"""

from __future__ import annotations

import torch


def _flat_maps(images):
    h, w = images.shape[-2], images.shape[-1]
    return images.reshape(-1, h * w), h, w


def bilinear_sample_pixels(images, ix, iy):
    """Bilinear sample at pixel coordinates (zero outside [0, size - 1]):
    the four taps in one flat-indexed gather; the coordinate gradient
    flows through the weights."""
    flat, h, w = _flat_maps(images)
    x0, y0 = torch.floor(ix), torch.floor(iy)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1 = ix - x0
    wx0 = 1.0 - wx1
    wy1 = iy - y0
    wy0 = 1.0 - wy1

    def flat_idx(yf, xf):
        xi = torch.clamp(xf, 0, w - 1).to(torch.int64)
        yi = torch.clamp(yf, 0, h - 1).to(torch.int64)
        return yi * w + xi

    def inb(yf, xf):
        return ((xf >= 0) & (xf <= w - 1) & (yf >= 0)
                & (yf <= h - 1)).to(torch.float32)

    idx = torch.stack([flat_idx(y0, x0), flat_idx(y0, x1),
                       flat_idx(y1, x0), flat_idx(y1, x1)], dim=-1)
    wts = torch.stack([wy0 * wx0 * inb(y0, x0), wy0 * wx1 * inb(y0, x1),
                       wy1 * wx0 * inb(y1, x0), wy1 * wx1 * inb(y1, x1)],
                      dim=-1)
    m = flat.shape[0]
    rows = torch.arange(m, device=flat.device)[:, None]
    vals = flat[rows, idx.reshape(-1, m, 4)].reshape(idx.shape)
    return (vals.to(torch.float32) * wts).sum(-1)


def _triangle(coord, size):
    cells = torch.arange(size, dtype=coord.dtype, device=coord.device)
    a = 1.0 - (coord[..., None] - cells).abs()
    return torch.maximum(torch.zeros_like(a), a)


def bilinear_dense_pixels(images, ix, iy):
    """Gather-free bilinear sampling at pixel coordinates: per axis the two
    taps are dense triangle-weight vectors max(0, 1 - |i - c|), and the
    sample is a contraction
    sample = sum_h sum_w tri(iy - h) * im[h, w] * tri(ix - w)."""
    h, w = images.shape[-2], images.shape[-1]
    maps = images.reshape(-1, h, w).to(torch.float32)
    m = maps.shape[0]
    lead = ix.shape
    wx = _triangle(ix, w).reshape(-1, m, w)
    wy = _triangle(iy, h).reshape(-1, m, h)
    inner = torch.einsum("mhw,pmw->pmh", maps, wx)
    return (inner * wy).sum(-1).reshape(lead)


def _to_pixels(images, grid_xy):
    """align_corners=True: -1 -> 0, +1 -> size - 1."""
    h, w = images.shape[-2], images.shape[-1]
    ix = (grid_xy[..., 0] + 1.0) * 0.5 * (w - 1)
    iy = (grid_xy[..., 1] + 1.0) * 0.5 * (h - 1)
    return ix, iy


def grid_sample_bilinear(images, grid_xy):
    """images (*M, H, W), grid_xy (*P, *M, 2) normalised to [-1, 1] (x
    along the width) -> (*P, *M) samples; out-of-bounds taps give 0."""
    return bilinear_sample_pixels(images, *_to_pixels(images, grid_xy))


def grid_sample_bilinear_dense(images, grid_xy):
    """`grid_sample_bilinear` through the dense triangle weights."""
    return bilinear_dense_pixels(images, *_to_pixels(images, grid_xy))
