"""A small PLY triangle-mesh writer and the skeleton meshing (numpy only).

Counterpart of `globalegomocap_tpu/tools/ply.py`, the same vertices,
faces and bytes: joints become icosphere meshes and bones capless
cylinders, written as binary (or ascii) PLY, one file per frame
(`save_skeleton_sequence`, the parity CLI's --save).
"""

from __future__ import annotations

import os

import numpy as np

from globalegomocap_tpu_torch.ops.skeleton import BONE_LINES


def icosphere(radius: float = 0.02, subdivisions: int = 1):
    """Unit icosahedron subdivided `subdivisions` times, scaled by radius.
    Returns (vertices (V, 3), faces (F, 3))."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])
    for _ in range(subdivisions):
        mid_cache: dict = {}
        new_faces = []
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid_cache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                verts.append(m)
                mid_cache[key] = len(verts) - 1
            return mid_cache[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts)
        faces = np.asarray(new_faces)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return verts, faces


def cylinder(start: np.ndarray, end: np.ndarray, radius: float = 0.005,
             segments: int = 8):
    """Capless cylinder mesh between two points."""
    start = np.asarray(start, dtype=np.float64)
    end = np.asarray(end, dtype=np.float64)
    axis = end - start
    length = np.linalg.norm(axis)
    if length < 1e-9:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=int)
    axis = axis / length
    # orthonormal frame
    ref = np.array([0.0, 0.0, 1.0]) if abs(axis[2]) < 0.9 \
        else np.array([1.0, 0.0, 0.0])
    u = np.cross(axis, ref)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = (np.outer(np.cos(ang), u) + np.outer(np.sin(ang), v)) * radius
    verts = np.concatenate([start + ring, end + ring])
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        faces += [[i, j, segments + i], [j, segments + j, segments + i]]
    return verts, np.asarray(faces)


def skeleton_mesh(joints: np.ndarray, joint_radius: float = 0.02,
                  bone_radius: float = 0.005):
    """Joints (15, 3) -> one combined (vertices, faces) mesh (the
    reference's `Skeleton.skeleton_to_mesh`)."""
    all_v, all_f = [], []
    offset = 0
    sphere_v, sphere_f = icosphere(joint_radius)
    for j in joints:
        all_v.append(sphere_v + np.asarray(j))
        all_f.append(sphere_f + offset)
        offset += len(sphere_v)
    for a, b in BONE_LINES:
        cv, cf = cylinder(joints[a], joints[b], bone_radius)
        if len(cv):
            all_v.append(cv)
            all_f.append(cf + offset)
            offset += len(cv)
    return np.concatenate(all_v), np.concatenate(all_f)


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              binary: bool = True):
    """Write a triangle mesh as PLY."""
    v = np.asarray(vertices, dtype=np.float32)
    f = np.asarray(faces, dtype=np.int32)
    header = (
        "ply\n"
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0\n"
        f"element vertex {len(v)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(f)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n")
    if binary:
        with open(path, "wb") as fh:
            fh.write(header.encode())
            fh.write(v.astype("<f4").tobytes())
            face_rec = np.empty(len(f), dtype=[("n", "u1"), ("idx", "<i4", 3)])
            face_rec["n"] = 3
            face_rec["idx"] = f
            fh.write(face_rec.tobytes())
    else:
        with open(path, "w") as fh:
            fh.write(header)
            for x, y, z in v:
                fh.write(f"{x} {y} {z}\n")
            for a, b, c in f:
                fh.write(f"3 {a} {b} {c}\n")


def save_skeleton_sequence(joints_seq: np.ndarray, out_dir: str,
                           prefix: str = "out"):
    """Export a (N, 15, 3) sequence as out_%04d.ply files
    (reference: optimizer.py:279-284 save_mesh)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, joints in enumerate(np.asarray(joints_seq)):
        v, f = skeleton_mesh(joints)
        p = os.path.join(out_dir, f"{prefix}_{i:04d}.ply")
        write_ply(p, v, f)
        paths.append(p)
    return paths
