"""AMASS motion-capture windows for training the motion priors.

Counterpart of `globalegomocap_tpu/data/amass.py`, with the reference's
dataset rules (networks/dataset/global_dataset.py:12-111 and
local_dataset.py:15-98): fps resampling by frame-rate striding, slide
windows or disjoint ones, the last 10 files as the test split, walking
balance (the 'walk' files cut to 1/20 of the others), the mo2cap2 name
filter, and local-pose or relative-global targets.

The windows materialise as one (W, T, 45) float32 numpy array on the
host; `AmassWindows.epoch_batches` draws each epoch's order from a numpy
generator, so the same generator gives the JAX package's batches in the
same order.  The SE(3) products of the relative-global targets run in
float32 PyTorch on the CPU.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np
import torch

from globalegomocap_tpu_torch.ops.transforms import (
    quat_trans_to_matrix, relative_global_pose)
from globalegomocap_tpu_torch.utils.profiling import RECORDER


def load_amass_pkls(path: str, is_train: bool = True,
                    mo2cap2_names: Sequence[str] | None = None,
                    balance_walking: bool = False,
                    seed: int = 0) -> list[dict]:
    """The AMASS pkl dicts of a directory, with the reference's filter and
    split rules (global_dataset.py:43-74).  The files are this program's
    own training corpus: pickles are unpickled as they are."""
    names = sorted(os.listdir(path))
    if mo2cap2_names is not None:
        names = [n for n in names
                 if any(seq in n for seq in mo2cap2_names)]
    names = names[:-10] if is_train else names[-10:]
    if balance_walking:
        walk = [n for n in names if "walk" in n.lower()]
        non_walk = [n for n in names if "walk" not in n.lower()]
        rng = np.random.default_rng(seed)
        rng.shuffle(walk)
        names = non_walk + walk[: int(len(non_walk) / 20)]
    out = []
    for n in names:
        with open(os.path.join(path, n), "rb") as f:
            out.append(pickle.load(f))
    return out


def _cams_to_matrices(cam_list) -> np.ndarray:
    """[{'loc', 'rot'}] -> (N, 4, 4) float32, quaternions in scipy's xyzw
    order (reference contract: utils/utils.py:85-97)."""
    locs = np.stack([np.asarray(c["loc"], dtype=np.float32)
                     for c in cam_list])
    rots = np.stack([np.asarray(c["rot"], dtype=np.float32)
                     for c in cam_list])
    return quat_trans_to_matrix(torch.from_numpy(locs),
                                torch.from_numpy(rots)).numpy()


def window_sequences(data_list: list[dict], frame_num: int = 10,
                     fps: int = 25, slide_window: bool = True,
                     local_pose: bool = False,
                     dilation: int = 1) -> np.ndarray:
    """All sequences sliced into (W, frame_num, 45) training windows.

    The temporal stride is round(frame_rate / fps) times `dilation` (the
    reference's --slide_window_step, global_dataset.py:82-109).
    local_pose=False moves every window into its first camera's frame
    (the relative-global prior's target); local_pose=True keeps the
    camera-frame poses (the local prior's, local_dataset.py:82-98)."""
    windows = []
    for seq in data_list:
        poses = np.asarray(seq["local_pose_list"], dtype=np.float32)
        n = len(poses)
        stride_t = max(1, round(int(seq["frame_rate"]) / fps)) * dilation
        span = frame_num * stride_t
        interval = 1 if slide_window else span
        if n <= span:
            continue
        starts = list(range(0, n - span, interval))
        if not starts:
            continue
        idx = np.asarray(starts)[:, None] + \
            np.arange(0, span, stride_t)[None, :]
        pose_win = poses[idx]                       # (w, T, 15, 3)
        if local_pose:
            windows.append(pose_win.reshape(len(starts), frame_num, 45))
        else:
            cam_win = _cams_to_matrices(seq["cam_list"])[idx]
            rel = relative_global_pose(torch.from_numpy(pose_win),
                                       torch.from_numpy(cam_win)).numpy()
            windows.append(rel.reshape(len(starts), frame_num, 45))
    if not windows:
        return np.zeros((0, frame_num, 45), dtype=np.float32)
    return np.concatenate(windows, axis=0).astype(np.float32)


class AmassWindows:
    """A materialised window dataset with epoch shuffling:

        ds = AmassWindows.from_dir(path, frame_num=10, ...)
        for batch in ds.epoch_batches(rng, batch_size): ...
    """

    def __init__(self, windows: np.ndarray):
        self.windows = windows

    @classmethod
    def from_dir(cls, path: str, frame_num: int = 10, fps: int = 25,
                 is_train: bool = True, slide_window: bool = True,
                 local_pose: bool = False, balance_walking: bool = False,
                 mo2cap2_names=None, dilation: int = 1) -> "AmassWindows":
        data = load_amass_pkls(path, is_train, mo2cap2_names,
                               balance_walking)
        return cls(window_sequences(data, frame_num, fps, slide_window,
                                    local_pose, dilation))

    @classmethod
    def from_sequences(cls, data_list: list[dict], frame_num: int = 10,
                       fps: int = 25, slide_window: bool = True,
                       local_pose: bool = False) -> "AmassWindows":
        return cls(window_sequences(data_list, frame_num, fps,
                                    slide_window, local_pose))

    def __len__(self) -> int:
        return len(self.windows)

    def epoch_batches(self, rng: np.random.Generator, batch_size: int,
                      drop_last: bool = True, shuffle: bool = True):
        """(B, T, 45) numpy batches in the order `rng` draws; each
        batch's gather is the span `data.batch`."""
        n = len(self.windows)
        order = rng.permutation(n) if shuffle else np.arange(n)
        end = n - n % batch_size if drop_last else n
        for i in range(0, end, batch_size):
            with RECORDER.span("data.batch"):
                batch = self.windows[order[i:i + batch_size]]
            yield batch
