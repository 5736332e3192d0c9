"""15-joint egocentric skeleton (Mo2Cap2 joint order and kinematic tree).

Counterpart of `globalegomocap_tpu/ops/skeleton.py`; all functions are
batched over arbitrary leading axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NUM_JOINTS = 15

# parent joint index of each joint (joint 0 is its own parent / root)
KINEMATIC_PARENTS = (0, 0, 1, 2, 0, 4, 5, 1, 7, 8, 9, 4, 11, 12, 13)

# bone edges used for rendering (tools/ply.py)
BONE_LINES = (
    (0, 1), (0, 4), (1, 2), (2, 3), (4, 5), (5, 6), (1, 7), (4, 11),
    (7, 8), (8, 9), (9, 10), (11, 12), (12, 13), (13, 14), (7, 11),
)

# mean reference skeleton in millimetres, joints as columns (3, 15)
MEAN3D_MM = np.array([
    [6.12454847, 145.97761, 258.72083056, 281.27554815, -130.58758154,
     -217.63663461, -234.47818229, 122.57391072, 157.99031993, 172.09879492,
     215.33356937, -52.15750419, -59.0959752, -36.18717374, -80.10264932],
    [233.90813433, 232.60823975, 188.18493809, 72.79136312, 239.16565076,
     203.68825151, 91.05888921, 239.95855861, 133.01398165, 176.20098748,
     37.42165039, 243.04617535, 149.38252591, 180.44482382, 44.79721165],
    [176.25176082, 220.73112637, 404.39836013, 488.37987609, 232.02432922,
     436.14841643, 529.22255096, 675.05067301, 1019.17833662, 1331.949378,
     1391.75072893, 683.67509016, 1037.58363271, 1353.00767289,
     1407.87463384],
])

_PARENTS = np.asarray(KINEMATIC_PARENTS)


def mean3d_bone_lengths_mm() -> np.ndarray:
    """Bone lengths (mm) of the mean reference skeleton, shape (15,)."""
    mean3d = MEAN3D_MM.T
    return np.linalg.norm(mean3d - mean3d[_PARENTS, :], axis=1)


@functools.lru_cache(maxsize=8)
def _parents_on(device: torch.device) -> torch.Tensor:
    """The parent table on `device`, copied there at the first call only
    (a solve on the card then issues no host-to-device copy).  Read-only."""
    return torch.as_tensor(_PARENTS, device=device)


def bone_lengths(skeleton: torch.Tensor) -> torch.Tensor:
    """(..., 15, 3) -> (..., 15) distance of each joint to its parent
    (entry 0, the root, is 0).  Zero-safe: a zero-length bone has a zero
    gradient instead of NaN."""
    parents = _parents_on(skeleton.device)
    bones = skeleton - skeleton.index_select(-2, parents)
    sq = (bones * bones).sum(-1)
    nonzero = sq > 0
    return torch.sqrt(torch.where(nonzero, sq, torch.ones_like(sq))) \
        * nonzero


def mean_bone_lengths(skeleton_seq: torch.Tensor) -> torch.Tensor:
    """(..., T, 15, 3) -> (..., 15) mean bone lengths over the frames."""
    return bone_lengths(skeleton_seq).mean(-2)


def skeleton_resize(skeleton: torch.Tensor,
                    target_bone_lengths: torch.Tensor,
                    lengths_in_mm: bool = True) -> torch.Tensor:
    """Rebuild each joint root-to-leaf at the target bone length along
    the original bone direction (the root keeps its position)."""
    parents = _parents_on(skeleton.device)
    est_bones = skeleton - skeleton.index_select(-2, parents)
    est_len = torch.linalg.vector_norm(est_bones, dim=-1)
    pos = est_len > 0
    scale = torch.where(
        pos, target_bone_lengths / torch.where(pos, est_len,
                                               torch.ones_like(est_len)),
        torch.zeros_like(est_len))
    scale = torch.cat([torch.zeros_like(scale[..., :1]), scale[..., 1:]],
                      dim=-1)
    divisor = 1000.0 if lengths_in_mm else 1.0
    new_bones = est_bones * scale[..., None] / divisor
    # parents precede children in the joint order, so one pass suffices
    joints = list(skeleton.unbind(-2))
    for j in range(1, NUM_JOINTS):
        joints[j] = joints[KINEMATIC_PARENTS[j]] + new_bones[..., j, :]
    return torch.stack(joints, dim=-2)


def heatmap_argmax(heatmaps: torch.Tensor):
    """2D argmax of joint heatmaps (..., J, H, W) -> (coords (..., J, 2)
    as float [x, y], maxvals (..., J)): x = idx % W, y = floor(idx / W) of
    the flattened map's first maximum (torch.argmax keeps the first on
    both devices).  A joint whose peak is <= 0 gets (0, 0), as the
    reference's `get_max_preds` masks it."""
    *lead, j, h, w = heatmaps.shape
    flat = heatmaps.reshape(*lead, j, h * w)
    idx = torch.argmax(flat, dim=-1)
    maxvals = flat.amax(dim=-1)
    x = (idx % w).to(torch.float32)
    y = torch.floor(idx.to(torch.float32) / w)
    coords = torch.stack([x, y], dim=-1)
    return coords * (maxvals > 0.0).to(torch.float32)[..., None], maxvals
