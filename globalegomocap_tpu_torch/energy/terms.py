"""Energy weights and the host staging of heatmap peak crops.

Counterpart of the slice's subset of `globalegomocap_tpu/energy/terms.py`:
the stage weights, the numpy crop staging (argmax and origins on the
float32 maps; crops are a pure gather, so they are bit-exact against the
JAX staging), the projected-estimate crop centres of the guard-trip path
and the crop-mass coverage.  The energy itself lives in
ops/fused_energy.py (kernel and plain version).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from globalegomocap_tpu_torch.ops import fisheye


@dataclass(frozen=True)
class EnergyWeights:
    """Weights of a stage's total energy (float32 at use)."""
    weight_3d: float = 0.01
    smooth: float = 0.001
    bone_length: float = 0.01
    vae: float = 0.0
    reproj: float = 0.01
    gmm: float = 0.0
    soft_smooth: float = 0.0

    @staticmethod
    def create(**kwargs) -> "EnergyWeights":
        return EnergyWeights(**{k: float(v) for k, v in kwargs.items()})


def project_to_heatmap_grid(pose: torch.Tensor,
                            camera: fisheye.FisheyeParams) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) grid coordinates in [-1, 1]
    of the 1024x1024 centre crop (x shifted by -128, /512 normalised)."""
    p2d = fisheye.world2camera(camera, pose)
    offset = torch.tensor([128.0 + 512.0, 512.0], dtype=p2d.dtype,
                          device=p2d.device)
    return (p2d - offset) / 512.0


def projected_estimate_centers(est_local: torch.Tensor,
                               camera: fisheye.FisheyeParams,
                               h: int, w: int) -> torch.Tensor:
    """(..., J, 3) camera-frame estimates -> (..., J, 2) crop centres
    (cy, cx) in full-map pixels, with the energy's own projection."""
    lead = est_local.shape[:-1]
    grid = project_to_heatmap_grid(
        est_local.reshape(-1, 3).to(torch.float32), camera)
    cx = (grid[:, 0] + 1.0) * 0.5 * (w - 1)
    cy = (grid[:, 1] + 1.0) * 0.5 * (h - 1)
    return torch.stack([cy, cx], dim=-1).reshape(lead + (2,))


def _gather_crops_np(heatmaps, k, oy, ox):
    iy = oy[..., None, None, :] + np.arange(k)[:, None, None]
    rows = np.take_along_axis(heatmaps, iy, axis=-3)       # (..., k, W, J)
    ix = ox[..., None, None, :] + np.arange(k)[None, :, None]
    return np.take_along_axis(rows, ix, axis=-2)           # (..., k, k, J)


def crop_heatmaps_channels_last_np(heatmaps, k: int):
    """Crop each joint's map (..., H, W, J) around its argmax.

    Returns (crops (..., k, k, J), origins (..., J, 2) float32 as (oy, ox),
    (H, W), box (..., J), total (..., J)): box and total are the clipped
    non-negative map mass inside the crop and overall, the ingredients of
    the crop-mass guard."""
    heatmaps = np.asarray(heatmaps)
    h, w = heatmaps.shape[-3], heatmaps.shape[-2]
    k = min(int(k), h, w)
    flat = heatmaps.reshape(heatmaps.shape[:-3] + (h * w,)
                            + heatmaps.shape[-1:])
    am = flat.argmax(axis=-2)                              # (..., J)
    oy = np.clip(am // w - k // 2, 0, h - k)
    ox = np.clip(am % w - k // 2, 0, w - k)
    crops = _gather_crops_np(heatmaps, k, oy, ox)
    origins = np.stack([oy, ox], axis=-1).astype(np.float32)
    box = np.clip(crops, 0.0, None).sum(axis=(-3, -2), dtype=np.float32)
    total = np.clip(heatmaps, 0.0, None).sum(axis=(-3, -2),
                                             dtype=np.float32)
    return crops, origins, (h, w), box, total


def crop_heatmaps_at_centers_channels_last_np(heatmaps, k: int, centers):
    """`crop_heatmaps_channels_last_np` with caller-supplied centres
    (..., J, 2) float (cy, cx), rounded and clipped to the map (the
    guard-trip path centres at the projected estimate).
    -> (crops (..., k, k, J), origins (..., J, 2) float32, (H, W))."""
    heatmaps = np.asarray(heatmaps)
    h, w = heatmaps.shape[-3], heatmaps.shape[-2]
    k = min(int(k), h, w)
    c = np.round(np.asarray(centers)).astype(np.int64)
    oy = np.clip(c[..., 0] - k // 2, 0, h - k)
    ox = np.clip(c[..., 1] - k // 2, 0, w - k)
    crops = _gather_crops_np(heatmaps, k, oy, ox)
    origins = np.stack([oy, ox], axis=-1).astype(np.float32)
    return crops, origins, (h, w)


def crop_coverage_np(box, total) -> np.float32:
    """Mean fraction of (non-negative) map mass the crops retain; maps
    with no mass count as covered."""
    return np.where(total > 0, box / np.maximum(total, 1e-30), 1.0).mean()
