"""The `test_data.pkl` chunk contract, the optimizer's input format.

Counterpart of `globalegomocap_tpu/data/test_data.py`.  Keys:
gt_global_skeleton (N, 15, 3), estimated_global_skeleton (N, 15, 3),
estimated_local_skeleton (N, 15, 3), camera_pose_list (N, 4, 4)
cam->world, heatmap_list (N, H, W, 15).
"""

from __future__ import annotations

import os
import pickle
import re
from typing import NamedTuple

import numpy as np


class TestChunk(NamedTuple):
    estimated_local: np.ndarray   # (N, 15, 3) camera-frame estimates
    estimated_global: np.ndarray  # (N, 15, 3) world-frame estimates
    gt_global: np.ndarray         # (N, 15, 3)
    camera_poses: np.ndarray      # (N, 4, 4)
    heatmaps: np.ndarray          # (N, H, W, 15)

    @property
    def n_frames(self) -> int:
        return self.estimated_local.shape[0]


def load_test_chunk(path: str) -> TestChunk:
    """Load one chunk directory (or its pkl file).  The pickle is the
    trusted output of the preprocessing step; never point this at bytes
    from an untrusted source."""
    if os.path.isdir(path):
        path = os.path.join(path, "test_data.pkl")
    with open(path, "rb") as f:
        data = pickle.load(f)
    f32 = lambda k: np.asarray(data[k], dtype=np.float32)  # noqa: E731
    return TestChunk(
        estimated_local=f32("estimated_local_skeleton"),
        estimated_global=f32("estimated_global_skeleton"),
        gt_global=f32("gt_global_skeleton"),
        camera_poses=f32("camera_pose_list"),
        heatmaps=f32("heatmap_list"),
    )


def save_test_chunk(chunk: TestChunk, out_dir: str) -> str:
    """Write a chunk in the pkl contract; returns the file path."""
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "test_data.pkl")
    with open(out_path, "wb") as f:
        pickle.dump({
            "gt_global_skeleton": chunk.gt_global,
            "estimated_global_skeleton": chunk.estimated_global,
            "estimated_local_skeleton": chunk.estimated_local,
            "camera_pose_list": chunk.camera_poses,
            "heatmap_list": chunk.heatmaps,
        }, f)
    return out_path


def natural_key(s: str) -> list:
    """Sort key that orders the digit runs of a name by value
    ('img-2' before 'img-10')."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def list_chunk_dirs(data_dir: str) -> list[str]:
    """Naturally sorted chunk subdirectories holding a test_data.pkl."""
    out = []
    for name in sorted(os.listdir(data_dir), key=natural_key):
        p = os.path.join(data_dir, name)
        if os.path.isdir(p) and os.path.exists(
                os.path.join(p, "test_data.pkl")):
            out.append(p)
    return out
