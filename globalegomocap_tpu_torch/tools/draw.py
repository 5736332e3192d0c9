"""2D skeletons drawn on images, host numpy.

Counterpart of `globalegomocap_tpu/tools/draw.py` (reference:
utils/utils.py:14-30): bones as lines (the right side in its own
colour), joints as dots.  cv2 draws them where it imports; otherwise a
numpy rasterizer of the JAX package's does, whose thick lines are
squares stamped along the segment.  `backend()` says which of the two
`draw_joints` runs.
"""

from __future__ import annotations

import numpy as np

# (start, end, side): the reference's `lines` table (utils/utils.py:11-12)
BONES_2D = (
    (0, 1, "right"), (0, 4, "left"), (1, 2, "right"), (2, 3, "right"),
    (4, 5, "left"), (5, 6, "left"), (1, 7, "right"), (4, 11, "left"),
    (7, 8, "right"), (8, 9, "right"), (9, 10, "right"), (11, 12, "left"),
    (12, 13, "left"), (13, 14, "left"), (7, 11, "left"),
)

def _draw_line_np(img, p0, p1, color, thickness=2):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    xs = np.linspace(p0[0], p1[0], n).astype(int)
    ys = np.linspace(p0[1], p1[1], n).astype(int)
    h, w = img.shape[:2]
    r = thickness // 2
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            x = np.clip(xs + dx, 0, w - 1)
            y = np.clip(ys + dy, 0, h - 1)
            img[y, x] = color


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def backend() -> str:
    """'cv2' where cv2 imports, else 'numpy'."""
    return "numpy" if _cv2() is None else "cv2"


def draw_joints(joints2d: np.ndarray, img: np.ndarray,
                color=(0, 255, 0), right_color=(255, 0, 0),
                joint_color=(0, 0, 255)) -> np.ndarray:
    """Draw a (J, 2) 2D skeleton on an (H, W, 3) image in place, and
    return it."""
    joints2d = np.asarray(joints2d)
    j = joints2d.shape[0]
    bones = [(a, b, right_color if side == "right" else color)
             for a, b, side in BONES_2D if a < j and b < j]
    cv2 = _cv2()
    if cv2 is not None:
        for a, b, c in bones:
            cv2.line(img, tuple(joints2d[a].astype(int)),
                     tuple(joints2d[b].astype(int)), color=c, thickness=4)
        for k in range(j):
            cv2.circle(img, tuple(joints2d[k].astype(int)), radius=2,
                       color=joint_color, thickness=6)
    else:
        for a, b, c in bones:
            _draw_line_np(img, joints2d[a], joints2d[b], c, 4)
        for k in range(j):
            _draw_line_np(img, joints2d[k], joints2d[k], joint_color, 6)
    return img
