"""BVH motion-capture file reading with forward kinematics (numpy, scipy).

Counterpart of `globalegomocap_tpu/tools/bvh.py`, the port's own copy:
the reference's vendored npybvh parser and egocentric joint extraction
(MakeDataForOptimization/bvh_reader/npybvh/bvh.py and
read_egocentric_joint_position.py:13-33).  Joints are enumerated in
hierarchy order with End sites appended as '<parent>_end' children, so
the published `EGOCENTRIC_JOINTS` indices select the same 15 joints.
The forward kinematics is one vectorised pass over all frames.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np
from scipy.spatial.transform import Rotation

# Captury studio skeleton indices of the 15 egocentric joints
# (reference: read_egocentric_joint_position.py:10)
EGOCENTRIC_JOINTS = (6, 15, 16, 17, 10, 11, 12, 23, 24, 25, 26, 19, 20, 21,
                     22)


@dataclass
class BvhJoint:
    name: str
    parent: "BvhJoint | None"
    offset: np.ndarray = field(default_factory=lambda: np.zeros(3))
    channels: list = field(default_factory=list)
    children: list = field(default_factory=list)


class Bvh:
    """Parsed BVH animation: hierarchy + per-frame channel values."""

    def __init__(self):
        self.joints: dict[str, BvhJoint] = {}
        self.root: BvhJoint | None = None
        self.keyframes: np.ndarray | None = None
        self.frames = 0
        self.frame_time = 1.0 / 30.0

    @property
    def fps(self) -> float:
        return 1.0 / self.frame_time

    def joint_names(self) -> list[str]:
        return list(self.joints.keys())

    def parse_string(self, text: str):
        hier, motion = text.split("MOTION")
        self._parse_hierarchy(hier)
        self._parse_motion(motion)
        return self

    def parse_file(self, path: str):
        with open(path) as f:
            return self.parse_string(f.read())

    def _parse_hierarchy(self, text: str):
        stack: list[BvhJoint] = []
        for raw in text.splitlines():
            words = raw.strip().split()
            if not words:
                continue
            tok = words[0]
            if tok in ("JOINT", "ROOT"):
                parent = stack[-1] if tok == "JOINT" else None
                joint = BvhJoint(words[1], parent)
                self.joints[joint.name] = joint
                if parent:
                    parent.children.append(joint)
                else:
                    self.root = joint
                stack.append(joint)
            elif tok == "CHANNELS":
                stack[-1].channels = words[2:]
            elif tok == "OFFSET":
                stack[-1].offset = np.asarray([float(x) for x in words[1:4]])
            elif tok == "End":
                joint = BvhJoint(stack[-1].name + "_end", stack[-1])
                stack[-1].children.append(joint)
                self.joints[joint.name] = joint
                stack.append(joint)
            elif tok == "}":
                stack.pop()

    def _parse_motion(self, text: str):
        lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
        rows = []
        for ln in lines:
            if ln.startswith("Frames:"):
                self.frames = int(ln.split()[1])
            elif ln.startswith("Frame Time:"):
                self.frame_time = float(ln.split()[2])
            else:
                rows.append([float(x) for x in re.split(r"\s+", ln)])
        self.keyframes = np.asarray(rows)

    # ---- forward kinematics -------------------------------------------

    def _channel_layout(self):
        """[(joint, chan_start, chan_names)] in hierarchy order."""
        layout = []
        cursor = 0
        def walk(j: BvhJoint):
            nonlocal cursor
            if j.channels:
                layout.append((j, cursor, j.channels))
                cursor += len(j.channels)
            for c in j.children:
                walk(c)
        walk(self.root)
        return layout

    def all_frame_poses(self):
        """FK for every frame at once.

        Returns (positions (F, J, 3), names (J,)) with J = all joints
        including End sites, in the reference-compatible enumeration order.
        """
        names = self.joint_names()
        index = {n: i for i, n in enumerate(names)}
        F = self.frames
        pos = np.zeros((F, len(names), 3))
        # per-joint world rotation matrices, computed parent-first
        world_rot: dict[str, np.ndarray] = {}
        world_pos: dict[str, np.ndarray] = {}

        layout = {j.name: (start, chans) for j, start, chans
                  in self._channel_layout()}

        def local_rotation(joint: BvhJoint) -> np.ndarray:
            """(F, 3, 3) from the joint's rotation channels (intrinsic,
            applied in channel order)."""
            if joint.name not in layout:
                return np.broadcast_to(np.eye(3), (F, 3, 3))
            start, chans = layout[joint.name]
            rot = None
            order = ""
            angles = []
            for ci, ch in enumerate(chans):
                if ch.endswith("rotation"):
                    order += ch[0].upper()
                    angles.append(self.keyframes[:, start + ci])
            if not order:
                return np.broadcast_to(np.eye(3), (F, 3, 3))
            ang = np.stack(angles, axis=1)
            return Rotation.from_euler(order, ang,
                                       degrees=True).as_matrix()

        def local_translation(joint: BvhJoint) -> np.ndarray:
            t = np.broadcast_to(joint.offset, (F, 3)).copy()
            if joint.name in layout:
                start, chans = layout[joint.name]
                for ci, ch in enumerate(chans):
                    if ch.endswith("position"):
                        axis = "XYZ".index(ch[0].upper())
                        t[:, axis] = t[:, axis] + self.keyframes[:, start + ci]
            return t

        def walk(joint: BvhJoint):
            lr = local_rotation(joint)
            lt = local_translation(joint)
            if joint.parent is None:
                world_rot[joint.name] = lr
                world_pos[joint.name] = lt
            else:
                pr = world_rot[joint.parent.name]
                pp = world_pos[joint.parent.name]
                world_rot[joint.name] = np.einsum("fij,fjk->fik", pr, lr)
                world_pos[joint.name] = pp + np.einsum(
                    "fij,fj->fi", pr, lt)
            pos[:, index[joint.name]] = world_pos[joint.name]
            for c in joint.children:
                walk(c)

        walk(self.root)
        return pos, names

    def frame_pose(self, frame: int):
        """Single-frame convenience matching the reference Bvh API."""
        pos, names = self.all_frame_poses()
        return pos[frame], names


def extract_egocentric_sequence(bvh_path: str, start_frame: int = 0,
                                input_frame_rate: float | None = None,
                                output_frame_rate: float = 25.0
                                ) -> np.ndarray:
    """BVH -> (N, 15, 3) ground-truth sequence in metres at the output fps
    (reference: read_egocentric_joint_position.py:13-33: select the 15
    egocentric joints, mm -> m, stride = round(in_fps / out_fps))."""
    anim = Bvh().parse_file(bvh_path)
    in_fps = input_frame_rate or anim.fps
    step = max(1, round(in_fps / output_frame_rate))
    pos, _ = anim.all_frame_poses()
    sel = pos[start_frame::step][:, list(EGOCENTRIC_JOINTS), :]
    return (sel / 1000.0).astype(np.float32)
