"""Packed HDF5 window corpora: the packer, the materialising reader and
the streaming reader.

Counterpart of `globalegomocap_tpu/data/hdf5.py`, the reference's HDF5
packer (networks/make_dataset.py:15-131): a directory of AMASS pkls
becomes one HDF5 file with the datasets `relative_global_pose` (W, T, 15,
3), `local_pose` (W, T, 15, 3) and `camera_matrix` (W, T, 4, 4), the same
file in either package.  `load_hdf5_windows` reads a split into
`AmassWindows`; `HDF5WindowStream` serves AMASS-scale corpora batch by
batch without holding the windows in memory.

The files are read and written by `data/h5file.py`, the port's own HDF5
code, not h5py (which the port never imports); h5py and the JAX package
read the files it writes, and it reads theirs.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from globalegomocap_tpu_torch.data import h5file
from globalegomocap_tpu_torch.data.amass import AmassWindows, _cams_to_matrices
from globalegomocap_tpu_torch.ops.transforms import relative_global_pose


class HDF5Store:
    """Append-only HDF5 datasets with a shared batch axis."""

    def __init__(self, path: str, dataset_shapes: dict, dtype=np.float32):
        self.path = path
        h5file.create(path, dataset_shapes, dtype)

    def append(self, batches: dict):
        h5file.append(self.path, batches)


def sequence_windows_with_cameras(seq: dict, frame_num: int, fps: int,
                                  slide_window: bool):
    """One AMASS sequence -> (relative_global (w, T, 15, 3), local (w, T,
    15, 3), cameras (w, T, 4, 4)), float32; the temporal stride is
    round(frame_rate / fps), the window starts every frame
    (slide_window) or every window span.  The SE(3) products run in
    float32 PyTorch on the CPU."""
    poses = np.asarray(seq["local_pose_list"], dtype=np.float32)
    n = len(poses)
    stride_t = max(1, round(int(seq["frame_rate"]) / fps))
    span = frame_num * stride_t
    interval = 1 if slide_window else span
    starts = list(range(0, n - span, interval))
    if not starts:
        z = np.zeros((0, frame_num, 15, 3), np.float32)
        return z, z, np.zeros((0, frame_num, 4, 4), np.float32)
    cams = _cams_to_matrices(seq["cam_list"])
    idx = np.asarray(starts)[:, None] + \
        np.arange(0, span, stride_t)[None, :]
    pose_win = poses[idx]
    cam_win = cams[idx]
    rel = relative_global_pose(torch.from_numpy(pose_win),
                               torch.from_numpy(cam_win)).numpy()
    return rel.astype(np.float32), pose_win, cam_win.astype(np.float32)


def pack_amass_dir(source_dir: str, output_path: str, frame_num: int = 10,
                   fps: int = 25, slide_window: bool = True) -> str:
    """A directory of AMASS pkls (in name order) -> one HDF5 file
    (reference: make_dataset.py:60-73).  The pkls are this program's own
    training corpus: they are unpickled as they are."""
    store = HDF5Store(output_path, {
        "relative_global_pose": (frame_num, 15, 3),
        "local_pose": (frame_num, 15, 3),
        "camera_matrix": (frame_num, 4, 4),
    })
    for name in sorted(os.listdir(source_dir)):
        with open(os.path.join(source_dir, name), "rb") as f:
            seq = pickle.load(f)
        rel, local, cams = sequence_windows_with_cameras(
            seq, frame_num, fps, slide_window)
        if len(rel):
            store.append({"relative_global_pose": rel,
                          "local_pose": local,
                          "camera_matrix": cams})
    return output_path


def load_hdf5_windows(path: str, local_pose: bool = False) -> AmassWindows:
    """HDF5 file -> AmassWindows of (W, T, 45) windows (the local poses or
    the relative-global ones)."""
    key = "local_pose" if local_pose else "relative_global_pose"
    with h5file.open(path) as f:
        w = f[key].read()
    return AmassWindows(w.reshape(w.shape[0], w.shape[1], 45))


class HDF5WindowStream:
    """The `epoch_batches` protocol of AmassWindows over a packed HDF5
    file, without holding its windows in memory.

    The shuffle has two levels: each epoch reads contiguous
    `slab_size`-row slabs in a random order (sequential reads) and
    permutes the rows within each slab, carrying a slab's leftover rows
    into the next so that batches mix slabs.  The order is drawn from the
    caller's numpy generator as the JAX package draws it (the slab order,
    then one permutation a slab), so one seed gives both packages' batches.
    `start` / `stop` (negative from the end) select a row range: the train
    CLI splits one file into a train and a test stream."""

    def __init__(self, path: str, local_pose: bool = False,
                 slab_size: int = 4096, start: int = 0,
                 stop: int | None = None):
        self.path = path
        self.key = "local_pose" if local_pose else "relative_global_pose"
        self.slab_size = int(slab_size)
        try:
            self._file = h5file.open(path)
        except OSError as e:
            raise OSError(
                f"{path} is not a readable HDF5 window file (expected the "
                f"pack_amass_dir format with a {self.key!r} dataset): {e}"
            ) from e
        if self.key not in self._file:
            datasets = list(self._file)
            self._file.close()
            raise KeyError(
                f"{path} has no {self.key!r} dataset; datasets present: "
                f"{datasets}")
        self._dset = self._file[self.key]
        n = int(self._dset.shape[0])
        self.start = max(0, start if start >= 0 else n + start)
        self.stop = n if stop is None else min(n, stop if stop >= 0
                                               else n + stop)

    def __len__(self) -> int:
        return max(0, self.stop - self.start)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def _read_slab(self, offset: int) -> np.ndarray:
        lo = self.start + offset
        hi = min(lo + self.slab_size, self.stop)
        block = self._dset.read(lo, hi).astype(np.float32, copy=False)
        return block.reshape(block.shape[0], block.shape[1], -1)

    def epoch_batches(self, rng: np.random.Generator, batch_size: int,
                      drop_last: bool = True, shuffle: bool = True):
        """(B, T, 45) numpy batches; with drop_last=False a last partial
        batch too."""
        starts = np.arange(0, len(self), self.slab_size)
        if shuffle:
            starts = rng.permutation(starts)
        pending = None
        for s in starts:
            block = self._read_slab(int(s))
            if shuffle:
                block = block[rng.permutation(len(block))]
            if pending is not None:
                block = np.concatenate([pending, block])
                pending = None
            n_full = len(block) // batch_size
            for i in range(n_full):
                yield block[i * batch_size:(i + 1) * batch_size]
            rem = len(block) - n_full * batch_size
            if rem:
                pending = block[-rem:]
        if pending is not None and not drop_last:
            yield pending


def interpolate_frames(sequence: np.ndarray, factor: int = 5) -> np.ndarray:
    """Linear temporal upsampling by `factor`: (N, ...) -> ((N-1)*factor,
    ...), each original frame followed by factor - 1 blends towards the
    next (reference: make_dataset.py:76-86)."""
    a = sequence[:-1]
    b = sequence[1:]
    alphas = np.arange(factor) / factor
    out = a[:, None] + alphas[(None, slice(None)) + (None,) * (a.ndim - 1)] \
        * (b - a)[:, None]
    return out.reshape((-1,) + sequence.shape[1:])
