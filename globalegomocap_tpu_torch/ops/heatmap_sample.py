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

One gather for each value-and-grad evaluation: where autograd records a
graph, the forward also returns the residual (..., N, 2) float32, the
point partials (dix, diy) of the sample in pixel units, taken from the
taps the sample reads; the backward is dpts = (g dix sx, g diy sy) over
that residual, with no second read of the maps.  A value-only call (no
graph) writes no residual.

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
        [_VP, _CI, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _VP], _CI),
    "heatmap_sample_bwd_launch": (
        [_VP, _VP, _VP, _CI, _CI, _CI, _CI, _VP], _CI),
    "heatmap_sample_threads": ([_CI], _CI),
}
_MAP_DTYPES = (torch.float32, torch.bfloat16)
# block sizes the launchers take besides 0, the source's launch rule
# (one fixed size a kernel)
BLOCK_SIZES = (64, 128, 256)


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


def _check_bwd(res, g, size):
    """The backward's arguments: the residual against the cotangent."""
    if res is None:
        raise ValueError("heatmap_sample_bwd needs the forward's residual: "
                         "the forward ran without recording a graph")
    if g.dim() < 1 or tuple(res.shape) != tuple(g.shape) + (2,):
        raise ValueError(f"residual: shape {tuple(res.shape)}, expected "
                         f"the cotangent's {tuple(g.shape)} + (2,)")
    dev = res.device
    cuda_build.expect(res, "residual", tuple(res.shape), (torch.float32,),
                      dev)
    cuda_build.expect(g, "g", tuple(g.shape), (torch.float32,), dev)
    h, w = size
    if g.numel() < 1 or h < 1 or w < 1:
        raise ValueError("empty cotangent or maps")
    if g.numel() >= 2 ** 31:
        raise ValueError("more than 2**31 - 1 points")
    if dev.type == "cuda" and res.data_ptr() % 8:
        raise ValueError("residual must be 8-byte aligned (float2 loads)")


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


def _scales(h, w):
    return 0.5 * (w - 1), 0.5 * (h - 1)


def plain_forward(maps, points, residual=False):
    """maps (N, H, W), points (R, N, 2) -> samples (R, N), and with
    `residual` also the partials (R, N, 2): dix, diy of the sample with
    respect to the pixel coordinates (the dense triangle-weight sums of
    JAX's `_bwd_kernel`)."""
    n, h, w = maps.shape
    sx, sy = _scales(h, w)
    ix, iy = (points[..., 0] + 1.0) * sx, (points[..., 1] + 1.0) * sy
    wx, dwx = _axis_weights(ix, w)
    wy, dwy = _axis_weights(iy, h)
    m = maps.to(torch.float32)
    inner = torch.einsum("nhw,rnw->rnh", m, wx)
    out = (inner * wy).sum(-1)
    if not residual:
        return out
    dix = (torch.einsum("nhw,rnw->rnh", m, dwx) * wy).sum(-1)
    diy = (inner * dwy).sum(-1)
    return out, torch.stack([dix, diy], dim=-1)


def plain_backward(res, g, size):
    """d(sum g * sample)/dpoints (..., N, 2) from the residual (..., N, 2)
    and the cotangent g (..., N); size is the maps' (H, W)."""
    sx, sy = _scales(*size)
    return torch.stack([g * res[..., 0] * sx, g * res[..., 1] * sy], dim=-1)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _launch_fwd(maps, points, out, res, r, n, threads):
    h, w = maps.shape[1:]
    return _library().heatmap_sample_fwd_launch(
        maps.data_ptr(), int(maps.dtype == torch.bfloat16),
        points.data_ptr(), out.data_ptr(),
        None if res is None else res.data_ptr(), r, n, h, w, threads,
        cuda_build.stream_of(maps.device))


def _launch_bwd(res, g, dpts, size, threads):
    return _library().heatmap_sample_bwd_launch(
        g.data_ptr(), res.data_ptr(), dpts.data_ptr(), g.numel(), *size,
        threads, cuda_build.stream_of(g.device))


def heatmap_sample_fwd(maps, points, residual=False):
    """Samples (..., N), and with `residual` also the point partials
    (..., N, 2) the backward takes: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    r, n, _, _ = _check(maps, points)
    lead = points.shape[:-2]
    dev = maps.device
    if cuda_build.use_plain(dev):
        got = plain_forward(maps, points.reshape(r, n, 2), residual)
        if not residual:
            return got.reshape(lead + (n,))
        return got[0].reshape(lead + (n,)), got[1].reshape(points.shape)
    out = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    res = torch.empty_like(points) if residual else None
    cuda_build.launched("heatmap_sample",
                        _launch_fwd(maps, points, out, res, r, n, 0))
    return (out, res) if residual else out


def heatmap_sample_bwd(res, g, size):
    """d(sum g * sample)/dpoints (..., N, 2) for the cotangent g (..., N)
    from the forward's residual (..., N, 2); size is the maps' (H, W).
    Raises where there is no residual: it never gathers the maps again."""
    _check_bwd(res, g, size)
    dev = g.device
    if cuda_build.use_plain(dev):
        return plain_backward(res, g, size)
    dpts = torch.empty_like(res)
    cuda_build.launched("heatmap_sample_bwd",
                        _launch_bwd(res, g, dpts, tuple(size), 0))
    return dpts


def launch_threads(backward=False):
    """Threads a block that the source's launch rule takes for the
    forward (or the backward)."""
    return _library().heatmap_sample_threads(int(backward))


def fwd_at_block(maps, points, threads, residual=False):
    """The forward kernel at a block of `threads` (64, 128 or 256) in
    place of the launch rule's, for timing the rule against the other
    sizes; CUDA tensors only, counts no launch, and no path calls it."""
    if threads not in BLOCK_SIZES:
        raise ValueError(f"threads must be one of {BLOCK_SIZES}")
    r, n, _, _ = _check(maps, points)
    out = torch.empty(points.shape[:-1], dtype=torch.float32,
                      device=maps.device)
    res = torch.empty_like(points) if residual else None
    err = _launch_fwd(maps, points, out, res, r, n, threads)
    if err:
        raise RuntimeError(f"heatmap_sample: CUDA launch failed with error "
                           f"{err}")
    return (out, res) if residual else out


def bwd_at_block(res, g, size, threads):
    """The backward kernel at a block of `threads`, as `fwd_at_block`."""
    if threads not in BLOCK_SIZES:
        raise ValueError(f"threads must be one of {BLOCK_SIZES}")
    _check_bwd(res, g, size)
    dpts = torch.empty_like(res)
    err = _launch_bwd(res, g, dpts, tuple(size), threads)
    if err:
        raise RuntimeError(f"heatmap_sample_bwd: CUDA launch failed with "
                           f"error {err}")
    return dpts


class _HeatmapSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, maps, points):
        ctx.size = tuple(maps.shape[1:])
        if not ctx.needs_input_grad[1]:
            return heatmap_sample_fwd(maps, points)
        out, res = heatmap_sample_fwd(maps, points, residual=True)
        ctx.save_for_backward(res)
        return out

    @staticmethod
    def backward(ctx, g):
        res = ctx.saved_tensors[0] if ctx.saved_tensors else None
        # the maps are constants of the solve: no cotangent
        return None, heatmap_sample_bwd(res, g.contiguous(), ctx.size)


def heatmap_sample(maps, points):
    """maps (N, H, W), points (..., N, 2) in [-1, 1] -> (..., N) bilinear
    samples (align_corners=True, zero padding), differentiable in the
    points.  With no graph to record (grad mode off, or no input that
    requires grad) it launches the value-only forward."""
    if torch.is_grad_enabled() and (maps.requires_grad
                                    or points.requires_grad):
        return _HeatmapSample.apply(maps, points)
    return heatmap_sample_fwd(maps, points)
