"""Energy terms, the heatmap crops and the crop-mass coverage.

Counterpart of `globalegomocap_tpu/energy/terms.py`:

- the stage weights and the energy terms of a decoded window
  (`total_energy_from_pose` and the terms it sums), differentiated by
  autograd.  The JAX package writes them for one window and vmaps them;
  here they take leading axes: context tensors (anchor, bone lengths,
  maps, origins) are (*B, ...) over windows, and the pose may carry
  further leading probe axes (*P, *B, ...) that share that context.
  Energies come back as (*P, *B).
- the heatmap term on full maps through `sampling_impl` gather, dense or
  pallas (the `heatmap_sample` kernel), and on k x k crops with their
  origins;
- the peak crops, on the device for the in-solve cropping of the
  per-chunk path and in numpy for host staging (argmax and origins on the
  float32 maps; crops are a pure gather, so both are bit-exact against
  the JAX package), the projected-estimate crop centres of the guard-trip
  path and the crop-mass coverage (numpy from host staging's sums, or on
  the device for device staging).

The fused stage energies live in ops/fused_energy.py (kernel and plain
version).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from globalegomocap_tpu_torch.ops import fisheye
from globalegomocap_tpu_torch.ops.heatmap_sample import heatmap_sample
from globalegomocap_tpu_torch.ops.sampling import (
    bilinear_dense_pixels, bilinear_sample_pixels, grid_sample_bilinear,
    grid_sample_bilinear_dense)
from globalegomocap_tpu_torch.ops.skeleton import bone_lengths


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


def pose_energy_3d(pose, initial_pose):
    """Squared distance to the stage's initial pose estimate."""
    return (pose - initial_pose).square().sum((-3, -2, -1))


def smooth_acceleration_energy(pose):
    """Sum of squared second temporal differences; pose (..., T, 15, 3)."""
    velocity = pose[..., :-1, :, :] - pose[..., 1:, :, :]
    acceleration = velocity[..., :-1, :, :] - velocity[..., 1:, :, :]
    return acceleration.square().sum((-3, -2, -1))


def bone_length_energy(pose, mean_bone_length):
    """Squared deviation of every frame's bone lengths from the sequence's
    mean bone lengths; pose (..., T, 15, 3), mean_bone_length (..., 15)."""
    predicted = bone_lengths(pose)                          # (..., T, 15)
    return (predicted - mean_bone_length[..., None, :]).square().sum(
        (-2, -1))


def vae_energy(pose):
    """Sum of squares of the decoded pose (the reference's "vae" term)."""
    return pose.square().sum((-3, -2, -1))


def soft_smooth_energy(pose, smoothed_pose):
    """Squared distance to the pre-smoothed input window (the reference's
    soft_smooth_energy)."""
    return (smoothed_pose - pose).square().sum((-3, -2, -1))


def overlap_consistency_energy(poses, stride: int):
    """Cross-window coupling: adjacent windows of one chunk agree on their
    T - stride shared frames.  poses (..., W, T, 15, 3), all windows of a
    chunk -> (...)."""
    w, t = poses.shape[-4], poses.shape[-3]
    overlap = t - stride
    if overlap <= 0 or w < 2:
        return poses.new_zeros(poses.shape[:-4])
    tail = poses[..., :-1, stride:, :, :]    # last frames of window i
    head = poses[..., 1:, :overlap, :, :]    # first frames of window i+1
    return (tail - head).square().sum((-4, -3, -2, -1))


def project_to_heatmap_grid(pose: torch.Tensor,
                            camera: fisheye.FisheyeParams) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) grid coordinates in [-1, 1]
    of the 1024x1024 centre crop (x shifted by -128, /512 normalised)."""
    p2d = fisheye.world2camera(camera, pose)
    offset = torch.tensor([128.0 + 512.0, 512.0], dtype=p2d.dtype,
                          device=p2d.device)
    return (p2d - offset) / 512.0


def heatmap_energy(pose, heatmaps, camera: fisheye.FisheyeParams,
                   impl: str = "gather", origins=None, full_hw=None):
    """Negative sum of the maps sampled at the projected joints.

    pose (*P, *B, T, 15, 3) camera frame; heatmaps (*B, T, 15, h, w)
    (maps, or k x k crops with `origins` (*B, T, 15, 2) as (oy, ox) in
    full-map pixels and the full map extent `full_hw`).  impl: 'gather',
    'dense' or 'pallas' (the heatmap_sample kernel; crops sample with the
    gather, as in the JAX package).  Returns (*P, *B)."""
    grid = project_to_heatmap_grid(pose, camera)        # (..., T, 15, 2)
    if origins is not None:
        fh, fw = full_hw
        ix = (grid[..., 0] + 1.0) * 0.5 * (fw - 1) - origins[..., 1]
        iy = (grid[..., 1] + 1.0) * 0.5 * (fh - 1) - origins[..., 0]
        pix_sample = (bilinear_dense_pixels if impl == "dense"
                      else bilinear_sample_pixels)
        return -pix_sample(heatmaps, ix, iy).sum((-2, -1))
    if impl == "pallas":
        h, w = heatmaps.shape[-2], heatmaps.shape[-1]
        maps = heatmaps.reshape(-1, h, w)
        m = maps.shape[0]
        s = heatmap_sample(maps, grid.reshape(-1, m, 2).contiguous())
        s = s.reshape(grid.shape[:-1])
    elif impl == "dense":
        s = grid_sample_bilinear_dense(heatmaps, grid)
    else:
        s = grid_sample_bilinear(heatmaps, grid)
    return -s.sum((-2, -1))


def total_energy_from_pose(pose, initial_pose, mean_bone_length, heatmaps,
                           camera: fisheye.FisheyeParams,
                           weights: EnergyWeights, use_reproj: bool,
                           gmm_score_fn=None, sampling_impl: str = "gather",
                           origins=None, full_hw=None, smoothed_pose=None):
    """The total loss of a stage given decoded pose windows (*P, *B, T,
    15, 3); the context is (*B, ...).  `use_reproj` False leaves the
    heatmap term out altogether (the global stage).  The soft-smooth term
    joins with `smoothed_pose` (*B, T, 15, 3), the GMM term with
    `gmm_score_fn`, a log-likelihood (N, T*45) -> (N,) of flattened
    windows (no entry point passes one, in either package)."""
    w = weights
    e = (w.weight_3d * pose_energy_3d(pose, initial_pose)
         + w.smooth * smooth_acceleration_energy(pose)
         + w.bone_length * bone_length_energy(pose, mean_bone_length)
         + w.vae * vae_energy(pose))
    if smoothed_pose is not None:
        e = e + w.soft_smooth * soft_smooth_energy(pose, smoothed_pose)
    if use_reproj:
        e = e + w.reproj * heatmap_energy(pose, heatmaps, camera,
                                          sampling_impl, origins, full_hw)
    if gmm_score_fn is not None:
        lead, t = pose.shape[:-3], pose.shape[-3]
        score = gmm_score_fn(pose.reshape(-1, t * 45))
        e = e - w.gmm * score.reshape(lead + (-1,)).sum(-1)
    return e


def _gather_crops(heatmaps, k: int, oy, ox):
    """(..., H, W, J) maps, integer origins (..., J) -> (..., k, k, J)."""
    lead, (h, w, j) = heatmaps.shape[:-3], heatmaps.shape[-3:]
    ar = torch.arange(k, device=heatmaps.device)
    iy = (oy[..., None, None, :] + ar[:, None, None]).expand(
        lead + (k, w, j))
    rows = torch.gather(heatmaps, -3, iy)                 # (..., k, W, J)
    ix = (ox[..., None, None, :] + ar[None, :, None]).expand(
        lead + (k, k, j))
    return torch.gather(rows, -2, ix)                     # (..., k, k, J)


def crop_heatmaps_channels_last(heatmaps, k: int):
    """Crop each joint's map (..., H, W, J) around its argmax on the
    device (the in-solve cropping of the per-chunk path).

    Returns (crops (..., k, k, J), origins (..., J, 2) float32 as (oy, ox),
    (H, W)); a pure gather, bit-exact against the numpy staging."""
    h, w = heatmaps.shape[-3], heatmaps.shape[-2]
    k = min(int(k), h, w)
    flat = heatmaps.reshape(heatmaps.shape[:-3] + (h * w,)
                            + heatmaps.shape[-1:])
    am = torch.argmax(flat, dim=-2)                        # (..., J)
    oy = torch.clamp(am // w - k // 2, 0, h - k)
    ox = torch.clamp(am % w - k // 2, 0, w - k)
    crops = _gather_crops(heatmaps, k, oy, ox)
    origins = torch.stack([oy, ox], dim=-1).to(torch.float32)
    return crops, origins, (h, w)


def crop_heatmaps_at_centers_channels_last(heatmaps, k: int, centers):
    """`crop_heatmaps_channels_last` with caller-supplied centres
    (..., J, 2) float (cy, cx), rounded (half to even) and clipped to the
    map: the guard-trip crops at the projected estimate."""
    h, w = heatmaps.shape[-3], heatmaps.shape[-2]
    k = min(int(k), h, w)
    c = torch.round(centers).to(torch.int64)
    oy = torch.clamp(c[..., 0] - k // 2, 0, h - k)
    ox = torch.clamp(c[..., 1] - k // 2, 0, w - k)
    crops = _gather_crops(heatmaps, k, oy, ox)
    origins = torch.stack([oy, ox], dim=-1).to(torch.float32)
    return crops, origins, (h, w)


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


def crop_coverage_mean(heatmaps: torch.Tensor, k: int) -> torch.Tensor:
    """The crop-mass guard's statistic on the device: the mean fraction of
    non-negative map mass the k x k peak crops keep, over maps (..., H, W)
    (argmax on the clipped float32 maps; a map with no mass counts as
    covered).  A 0-d float32 tensor: the caller reads it back once.
    Counterpart of the JAX package's `crop_coverage_mean`; the host
    staging's `crop_coverage_np` is the same quantity."""
    m = heatmaps.to(torch.float32).clamp_min(0.0)
    crops, _, _ = crop_heatmaps_channels_last(m[..., None], k)
    box = crops.sum((-3, -2, -1))
    total = m.sum((-2, -1))
    ratio = torch.where(total > 0, box / total.clamp_min(1e-30),
                        torch.ones_like(total))
    return ratio.mean()


def crop_coverage_np(box, total) -> np.float32:
    """Mean fraction of (non-negative) map mass the crops retain; maps
    with no mass count as covered."""
    return np.where(total > 0, box / np.maximum(total, 1e-30), 1.0).mean()
