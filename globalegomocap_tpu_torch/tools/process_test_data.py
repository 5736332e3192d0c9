"""The preprocessing ETL: heatmaps, depths, SLAM and GT -> test_data.pkl.

Counterpart of `globalegomocap_tpu/tools/process_test_data.py` (the
reference's MakeDataForOptimization/process_test_data.py): per chunk of
frames, lift the per-frame heatmap and depth predictions to local 3D
poses through the calibrated fisheye camera, read the SLAM trajectory
with its metric scale recovered, compose the local poses with the
camera poses into global skeletons, and write the `test_data.pkl`
contract.

The lift runs on the card: (N, H, W, 15) maps become (N, 15, H, W), then
the argmax, the pixel map and `camera2world`.  The reference resizes the
64x64 maps to 1024x1024 (nearest), pads x by 128 to the 1280-wide frame
and takes the argmax; the argmax of the 64x64 map followed by the affine
pixel map gives the same coordinates without the upsample.  Reading the
`.mat` files stays on the host (scipy's `loadmat`).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from globalegomocap_tpu_torch.data.test_data import (
    TestChunk, natural_key, save_test_chunk)
from globalegomocap_tpu_torch.device import resolve_device
from globalegomocap_tpu_torch.ops import fisheye
from globalegomocap_tpu_torch.ops.skeleton import heatmap_argmax
from globalegomocap_tpu_torch.ops.transforms import transform_pose
from globalegomocap_tpu_torch.tools.slam_reader import (
    read_trajectory_with_scale)

# 64x64 heatmap -> 1280x1024 fisheye pixels: the nearest-neighbour
# upsample by 16 puts bin k at pixel 16 k (the top-left source sample),
# then the x-pad shifts by +128
HEATMAP_UPSCALE = 16.0
CROP_PAD_X = 128.0


def heatmap_to_pixel(coords_64: torch.Tensor) -> torch.Tensor:
    """(..., 2) argmax coordinates on the 64x64 map -> full-image
    pixels."""
    return torch.stack([coords_64[..., 0] * HEATMAP_UPSCALE + CROP_PAD_X,
                        coords_64[..., 1] * HEATMAP_UPSCALE], dim=-1)


def lift_heatmaps_to_pose(heatmaps, depths, camera: fisheye.FisheyeParams,
                          device=None) -> np.ndarray:
    """(N, H, W, 15) heatmaps and (N, 15) depths -> (N, 15, 3) float32
    local poses, all frames at once.  A joint whose map has no positive
    peak lands at pixel (128, 0), as in the reference.  Runs on the card
    unless device='cpu'."""
    dev = resolve_device(device)
    hm = torch.as_tensor(np.asarray(heatmaps, dtype=np.float32),
                         device=dev).permute(0, 3, 1, 2)
    coords, _ = heatmap_argmax(hm)
    pose = fisheye.camera2world(
        camera.to(dev), heatmap_to_pixel(coords),
        torch.as_tensor(np.asarray(depths, dtype=np.float32), device=dev))
    return pose.cpu().numpy()


def load_mat_frames(heatmap_dir: str, depth_dir: str, start: int, end: int):
    """The per-frame .mat files ('heatmap' (H, W, 15), 'depth' (1, 15))
    of the [start, end) slice of each directory's natural-sorted listing:
    ((N, H, W, 15), (N, 15)) float32."""
    from scipy.io import loadmat

    hm_files = sorted(os.listdir(heatmap_dir), key=natural_key)[start:end]
    dp_files = sorted(os.listdir(depth_dir), key=natural_key)[start:end]
    heatmaps, depths = [], []
    for hf, df in zip(hm_files, dp_files):
        heatmaps.append(loadmat(os.path.join(heatmap_dir, hf))["heatmap"])
        depths.append(loadmat(os.path.join(depth_dir, df))["depth"][0])
    return np.asarray(heatmaps, dtype=np.float32), \
        np.asarray(depths, dtype=np.float32)


def build_chunk(heatmaps: np.ndarray, depths: np.ndarray, slam_path: str,
                gt_global: np.ndarray, fps: float, start_frame: int,
                end_frame: int, camera: fisheye.FisheyeParams | None = None,
                device=None) -> TestChunk:
    """One chunk from loaded arrays.  Runs on the card unless
    device='cpu'."""
    dev = resolve_device(device)
    camera = camera or fisheye.default_camera("egosyn")
    local_pose = lift_heatmaps_to_pose(heatmaps, depths, camera, dev)
    traj, _, _ = read_trajectory_with_scale(
        slam_path, fps, local_pose, gt_global, start_frame, end_frame, dev)
    est_global = transform_pose(torch.as_tensor(local_pose, device=dev),
                                torch.as_tensor(traj, device=dev))
    return TestChunk(
        estimated_local=local_pose,
        estimated_global=est_global.cpu().numpy(),
        gt_global=np.asarray(gt_global, dtype=np.float32),
        camera_poses=traj,
        heatmaps=np.asarray(heatmaps, dtype=np.float32),
    )


def process_sequence(slam_path: str, heatmap_dir: str, depth_dir: str,
                     gt_path: str, out_root: str, total_start: int,
                     total_end: int, fps: float = 25.0, chunk_size: int = 100,
                     mat_start_frame: int | None = None,
                     calibration_path: str | None = None, device=None):
    """Split frames [total_start, total_end) into chunks of `chunk_size`
    and write one `data_start_X_end_Y/test_data.pkl` each under
    `out_root`; returns their paths.  The chunk starts are the
    reference's range(total_start, total_end - chunk_size, chunk_size),
    which leaves out a last whole chunk.  Chunk [s, e) reads entries
    [s, e) of each natural-sorted .mat listing (whose first file is frame
    0) and GT rows [s - mat_start_frame, e - mat_start_frame) (the GT
    array, one pose a frame, starts at frame `mat_start_frame`, by
    default `total_start`).  Runs on the card unless device='cpu'."""
    dev = resolve_device(device)
    camera = (fisheye.load_calibration(calibration_path)
              if calibration_path else fisheye.default_camera("egosyn"))
    with open(gt_path, "rb") as f:
        gt_all = np.asarray(pickle.load(f))
    mat_start = total_start if mat_start_frame is None else mat_start_frame

    out_paths = []
    for s in range(total_start, total_end - chunk_size, chunk_size):
        e = s + chunk_size
        heatmaps, depths = load_mat_frames(heatmap_dir, depth_dir, s, e)
        gt = gt_all[s - mat_start:e - mat_start]
        chunk = build_chunk(heatmaps, depths, slam_path, gt, fps, s, e,
                            camera, dev)
        out_dir = os.path.join(out_root, f"data_start_{s}_end_{e}")
        out_paths.append(save_test_chunk(chunk, out_dir))
        mpjpe = np.linalg.norm(
            chunk.estimated_global - chunk.gt_global, axis=-1).mean()
        print(f"chunk {s}..{e}: initial mpjpe {mpjpe:.4f}")
    return out_paths
