"""The 17-metric MPJPE evaluation suite (plus per-joint errors).

Counterpart of `globalegomocap_tpu/evaluation/metrics.py`, same keys and
math.  Inputs are (..., N, 15, 3) world-frame sequences: leading axes
(the serve path's chunk axis) batch the whole suite into one call.
"""

from __future__ import annotations

import torch

from globalegomocap_tpu_torch.ops.skeleton import (
    mean3d_bone_lengths_mm, skeleton_resize)
from globalegomocap_tpu_torch.ops.umeyama import umeyama_align

METRIC_KEYS = (
    "original_global_mpjpe",
    "mid_global_mpjpe",
    "optimized_global_mpjpe",
    "original_camera_pos_error",
    "optimized_camera_pos_error",
    "original_aligned_camera_pos_error",
    "mid_aligned_camera_pose_error",
    "optimized_aligned_camera_pos_error",
    "original_aligned_global_mpjpe",
    "aligned_mid_seq_mpjpe",
    "optimized_aligned_global_mpjpe",
    "aligned_original_mpjpe",
    "aligned_mid_optimized_mpjpe",
    "aligned_optimized_mpjpe",
    "bone_length_aligned_original_mpjpe",
    "bone_length_aligned_mid_optimized_mpjpe",
    "bone_length_aligned_optimized_mpjpe",
    "joints_error",
)


def _dist(pred, gt):
    return torch.linalg.vector_norm(pred - gt, dim=-1)


def mpjpe(pred, gt):
    """Mean per-joint position error over the frames and joints."""
    return _dist(pred, gt).mean((-2, -1))


def hip_midpoint(seq):
    """(..., N, 3) pelvis proxy: mean of the R/L hips (joints 7, 11)."""
    return (seq[..., 7, :] + seq[..., 11, :]) / 2.0


def camera_position_error(pred, gt):
    return _dist(hip_midpoint(pred), hip_midpoint(gt)).mean(-1)


def align_sequence_globally(pred, gt):
    """One Umeyama fit of the whole (N*15, 3) cloud."""
    lead = pred.shape[:-2]
    aligned = umeyama_align(pred.reshape(lead[:-1] + (-1, 3)),
                            gt.reshape(lead[:-1] + (-1, 3)))
    return aligned.reshape(pred.shape)


def resize_to_mean3d(seq):
    target = torch.as_tensor(mean3d_bone_lengths_mm(), dtype=seq.dtype,
                             device=seq.device)
    return skeleton_resize(seq, target)


def calculate_errors(estimated, mid, optimized, gt) -> dict:
    """Full 17-metric suite + per-joint errors (key 'joints_error')."""
    out = {}
    out["original_global_mpjpe"] = mpjpe(estimated, gt)
    out["mid_global_mpjpe"] = mpjpe(mid, gt)
    out["optimized_global_mpjpe"] = mpjpe(optimized, gt)

    out["original_camera_pos_error"] = camera_position_error(estimated, gt)
    out["optimized_camera_pos_error"] = camera_position_error(optimized, gt)

    est_seq = align_sequence_globally(estimated, gt)
    mid_seq = align_sequence_globally(mid, gt)
    opt_seq = align_sequence_globally(optimized, gt)

    out["original_aligned_camera_pos_error"] = camera_position_error(
        est_seq, gt)
    out["mid_aligned_camera_pose_error"] = camera_position_error(mid_seq, gt)
    out["optimized_aligned_camera_pos_error"] = camera_position_error(
        opt_seq, gt)

    out["original_aligned_global_mpjpe"] = mpjpe(est_seq, gt)
    out["aligned_mid_seq_mpjpe"] = mpjpe(mid_seq, gt)
    out["optimized_aligned_global_mpjpe"] = mpjpe(opt_seq, gt)

    # per-frame Procrustes: one batched SVD over all frames
    out["aligned_original_mpjpe"] = mpjpe(umeyama_align(estimated, gt), gt)
    out["aligned_mid_optimized_mpjpe"] = mpjpe(umeyama_align(mid, gt), gt)
    out["aligned_optimized_mpjpe"] = mpjpe(umeyama_align(optimized, gt), gt)

    # bone-length-normalised: both sides resized to the mean3D skeleton
    gt_r = resize_to_mean3d(gt)
    est_r = umeyama_align(resize_to_mean3d(estimated), gt_r)
    mid_r = umeyama_align(resize_to_mean3d(mid), gt_r)
    opt_r = umeyama_align(resize_to_mean3d(optimized), gt_r)

    out["bone_length_aligned_original_mpjpe"] = mpjpe(est_r, gt_r)
    out["bone_length_aligned_mid_optimized_mpjpe"] = mpjpe(mid_r, gt_r)
    out["bone_length_aligned_optimized_mpjpe"] = mpjpe(opt_r, gt_r)
    out["joints_error"] = _dist(opt_r, gt_r).mean(-2)
    return out
