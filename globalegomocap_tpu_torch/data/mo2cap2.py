"""Mo2Cap2 fine-tuning windows sliced from a `test_data.pkl` chunk.

Counterpart of `globalegomocap_tpu/data/mo2cap2.py`, the reference's
`Mo2Cap2Dataset` (networks/dataset/global_dataset.py:114-169 and
local_dataset.py:101-156): disjoint frame_num-long windows of the
estimated skeleton, in the camera frame or moved into each window's first
camera frame, with the window's cameras and ground truth.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from globalegomocap_tpu_torch.data.test_data import TestChunk
from globalegomocap_tpu_torch.ops.transforms import relative_global_pose


class Mo2Cap2Windows(NamedTuple):
    poses: np.ndarray      # (W, T, 45) training windows
    cameras: np.ndarray    # (W, T, 4, 4)
    gt: np.ndarray         # (W, T, 15, 3)


def mo2cap2_windows(chunk: TestChunk, frame_num: int = 10,
                    local_pose: bool = False) -> Mo2Cap2Windows:
    """Disjoint windows over a chunk, starting at
    `arange(0, n - frame_num, frame_num)` (the reference's split loop,
    global_dataset.py:127, which leaves out a last whole window that ends
    on the chunk's last frame).  local_pose=False moves each window into
    its first camera's frame (float32 SE(3) products on the CPU)."""
    n = chunk.n_frames
    starts = np.arange(0, n - frame_num, frame_num)
    idx = starts[:, None] + np.arange(frame_num)[None, :]
    pose_win = np.asarray(chunk.estimated_local)[idx]     # (W, T, 15, 3)
    cam_win = np.asarray(chunk.camera_poses)[idx]
    gt_win = np.asarray(chunk.gt_global)[idx]
    if local_pose:
        out = pose_win
    else:
        out = relative_global_pose(
            torch.from_numpy(pose_win.astype(np.float32)),
            torch.from_numpy(cam_win.astype(np.float32))).numpy()
    return Mo2Cap2Windows(
        poses=out.reshape(len(starts), frame_num, 45).astype(np.float32),
        cameras=cam_win.astype(np.float32),
        gt=gt_win.astype(np.float32))
