"""The port's preprocessing ETL against the JAX package on the CPU:
`ops/skeleton.py::heatmap_argmax`, the lift, `.mat` loading, the SLAM
reader, `build_chunk`, `process_sequence` and `cli/preprocess.py`, the
BVH parser and the Captury block.  The same numpy inputs from a seed go
through both packages; raw captures are written by
`chip_smoke.write_raw_capture` (the chip check's phase 3l at a small
size).

Tolerances: the argmax is exact (integer coordinates, the first maximum
on ties); the lift runs in float32 in JAX's order of operations
(camera2world agrees to 5.5e-7 relative, tests/test_torch_geometry.py),
held at 2e-6; the SLAM fits at rtol 1e-4, atol 1e-5 against JAX (two
float32 SVD paths) and at JAX's own TestSlamReader tolerance (rtol
1e-3, atol 1e-4) against the planted scale; chunk fields at 1e-5 (a
pose is a lifted point moved by a fitted camera); the host-side parsers
(trajectory, BVH, Captury) are the same numpy code and exactly equal."""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import savemat
from scipy.spatial.transform import Rotation

import chip_smoke
from globalegomocap_tpu.cli import preprocess as jcli
from globalegomocap_tpu.data.test_data import load_test_chunk as jload
from globalegomocap_tpu.ops import fisheye as jfe
from globalegomocap_tpu.ops.skeleton import heatmap_argmax as jargmax
from globalegomocap_tpu.tools import bvh as jbvh
from globalegomocap_tpu.tools import captury_camera as jcap
from globalegomocap_tpu.tools import process_test_data as jptd
from globalegomocap_tpu.tools import slam_reader as jsr
from globalegomocap_tpu_torch.cli import preprocess as tcli
from globalegomocap_tpu_torch.data.synthetic import (
    render_heatmaps, synthetic_camera_trajectory, synthetic_motion)
from globalegomocap_tpu_torch.data.test_data import load_test_chunk as tload
from globalegomocap_tpu_torch.ops import fisheye as tfe
from globalegomocap_tpu_torch.ops.skeleton import heatmap_argmax as targmax
from globalegomocap_tpu_torch.tools import bvh as tbvh
from globalegomocap_tpu_torch.tools import captury_camera as tcap
from globalegomocap_tpu_torch.tools import process_test_data as tptd
from globalegomocap_tpu_torch.tools import slam_reader as tsr
import tests.torch_port_helpers  # noqa: F401  (one intra-op thread)
from tests import test_tools as jax_tool_tests

CPU = "cpu"
FIELDS = ("estimated_local", "estimated_global", "gt_global",
          "camera_poses", "heatmaps")


def assert_chunks_close(a, b, atol=1e-5):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=0 if f == "heatmaps" else atol,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# argmax and lift
# ---------------------------------------------------------------------------

def test_heatmap_argmax_matches_jax_on_ties_and_empty_maps():
    """Integer-valued maps (many tied maxima: the first one wins), an
    all-zero and an all-negative map (zeroed), over two leading axes; and
    JAX's own test case."""
    rng = np.random.default_rng(0)
    maps = rng.integers(0, 4, size=(2, 3, 15, 16, 20)).astype(np.float32)
    maps[0, 1] = 0.0
    maps[1, 2, 3] = -2.0
    maps[1, 0, 4, 7, 19] = 9.0             # the last cell of a row
    for hm in (maps, np.zeros((2, 3, 8, 9), np.float32)):
        if not hm.any():
            hm[0, 0, 5, 7], hm[0, 1, 2, 3], hm[1, 2, 0, 0] = 1.0, 2.0, 0.5
        wc, wv = jargmax(jnp.asarray(hm))
        gc, gv = targmax(torch.from_numpy(hm))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gc[0, 0].tolist() == [7, 5] and gc[0, 2].tolist() == [0, 0]


def test_lift_matches_jax():
    """Maps rendered at a known pose, lifted by both packages; a joint
    whose map is all zero lands at pixel (128, 0) in both."""
    local = synthetic_motion(12, seed=3)
    heat = render_heatmaps(local)
    heat[0, :, :, 5] = 0.0
    depths = np.linalg.norm(local, axis=-1).astype(np.float32)
    want = jptd.lift_heatmaps_to_pose(heat, depths,
                                      jfe.default_camera("egosyn"))
    cam = tfe.default_camera("egosyn")
    got = tptd.lift_heatmaps_to_pose(heat, depths, cam, CPU)
    assert got.dtype == np.float32 and got.shape == (12, 15, 3)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    corner = tfe.camera2world(cam, torch.tensor([[128.0, 0.0]]),
                              torch.tensor([depths[0, 5]]))[0]
    np.testing.assert_allclose(got[0, 5], corner.numpy(), rtol=1e-6)
    assert np.linalg.norm(got - local, axis=-1).mean() < 0.06


# ---------------------------------------------------------------------------
# .mat frames, the SLAM reader
# ---------------------------------------------------------------------------

def test_load_mat_frames_natural_sort_and_offset_window(tmp_path):
    """img-2 sorts before img-10; the window [1, 4) of the listing."""
    hdir, ddir = tmp_path / "heatmaps", tmp_path / "depths"
    hdir.mkdir()
    ddir.mkdir()
    for k in (1, 2, 3, 10, 11):
        savemat(hdir / f"img-{k}.mat", {"heatmap": np.full(
            (64, 64, 15), float(k), dtype=np.float32)})
        savemat(ddir / f"img-{k}.mat", {"depth": np.full(
            (1, 15), 10.0 * k, dtype=np.float32)})
    got = tptd.load_mat_frames(str(hdir), str(ddir), 1, 4)
    want = jptd.load_mat_frames(str(hdir), str(ddir), 1, 4)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][:, 0, 0, 0], [2, 3, 10])
    np.testing.assert_array_equal(got[1][:, 0], [20, 30, 100])


def write_trajectory(path, cams, fps=25.0, scale=1.0, times=None):
    quat = Rotation.from_matrix(cams[:, :3, :3]).as_quat()
    times = np.arange(len(cams)) / fps if times is None else times
    with open(path, "w") as f:
        for tt, m, q in zip(times, cams, quat):
            f.write(" ".join(map(str, [tt, *(m[:3, 3] / scale), *q])) + "\n")


def test_trajectory_parser_half_frames_and_short_lines(tmp_path):
    """Timestamps at half frames (Python's round, half to even), lines
    of fewer than 8 fields and blank lines skipped, the half-open frame
    window; the matrices re-based and scaled as JAX's."""
    cams = synthetic_camera_trajectory(16, seed=5)
    times = np.arange(16) / 25.0
    times[3::4] += 0.5 / 25.0                       # k + 0.5 frames
    p = str(tmp_path / "frame_trajectory.txt")
    write_trajectory(p, cams, times=times)
    with open(p, "a") as f:
        f.write("\n0.2 1.0 2.0 3.0 0 0 0\n   \n0.24 1 2\n")
    for window in ((0, 16), (2, 9), (7, 8)):
        got = tsr.parse_trajectory_file(p, 25.0, *window)
        want = jsr.parse_trajectory_file(p, 25.0, *window)
        for g, w in zip(got, want):
            assert g.dtype == np.float64
            np.testing.assert_array_equal(g, w)
    ids = [round(tt * 25.0) for tt in times]
    assert len(tsr.parse_trajectory_file(p, 25.0, 2, 9)[0]) == sum(
        2 <= i < 9 for i in ids)
    got = tsr.read_trajectory(p, 25.0, 2, 12, scale=1.7, device=CPU)
    want = jsr.read_trajectory(p, 25.0, 2, 12, scale=1.7)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], np.eye(4), atol=1e-6)


def test_read_trajectory_with_scale_matches_jax(tmp_path):
    """JAX's TestSlamReader case (the head at the camera, the scale 3.7
    recovered exactly), and a capture whose fit is approximate (the head
    offset turned with the camera, a planted 2.5): the matrices, R_1 and
    t_1 against JAX's."""
    p = str(tmp_path / "frame_trajectory.txt")
    n = 20
    cams = synthetic_camera_trajectory(n + 5, seed=6)
    write_trajectory(p, cams, scale=2.5)
    local = synthetic_motion(n + 5, seed=6).astype(np.float32)[5:]
    rel = np.linalg.inv(cams[5])[None] @ cams[5:]
    homo = np.concatenate([local, np.ones((n, 15, 1))], axis=2)
    gt_approx = np.einsum("nij,nkj->nki", rel, homo)[..., :3]
    head = local.copy()
    head[:, 0, :] = 0.0
    exact = tsr.read_trajectory(p, 25.0, 5, 5 + n, scale=3.7, device=CPU)
    gt_exact = np.einsum("nij,nkj->nki", exact, np.concatenate(
        [head, np.ones((n, 15, 1))], axis=2))[..., :3]
    for lp, gt in ((head, gt_exact), (local, gt_approx)):
        got = tsr.read_trajectory_with_scale(p, 25.0, lp, gt, 5, 5 + n,
                                             device=CPU)
        want = jsr.read_trajectory_with_scale(p, 25.0, lp, gt, 5, 5 + n)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-5)
        if lp is head:
            np.testing.assert_allclose(got[0][:, :3, 3], exact[:, :3, 3],
                                       rtol=1e-3, atol=1e-4)
    # GT that the unscaled trajectory carries exactly: the scale is 1
    c, _, _ = tsr.recover_metric_scale(
        torch.from_numpy(rel.astype(np.float32)), local, gt_approx)
    assert float(c) == pytest.approx(1.0, abs=1e-5)


# ---------------------------------------------------------------------------
# chunks, the sequence, the CLI
# ---------------------------------------------------------------------------

def test_build_chunk_matches_jax(tmp_path):
    """tests/test_tools.py's end-to-end chunk (20 frames, GT in the
    re-based frame), the same maps given to both packages."""
    n = 20
    local = synthetic_motion(n, seed=4)
    cams = synthetic_camera_trajectory(n, seed=4)
    slam = str(tmp_path / "frame_trajectory.txt")
    write_trajectory(slam, cams)
    rel = np.linalg.inv(cams[0])[None] @ cams
    gt = np.einsum("nij,nkj->nki", rel, np.concatenate(
        [local, np.ones((n, 15, 1))], axis=2))[..., :3].astype(np.float32)
    heat = render_heatmaps(local)
    depths = np.linalg.norm(local, axis=-1).astype(np.float32)
    got = tptd.build_chunk(heat, depths, slam, gt, 25.0, 0, n,
                           tfe.default_camera("egosyn"), CPU)
    want = jptd.build_chunk(heat, depths, slam, gt, 25.0, 0, n,
                            jfe.default_camera("egosyn"))
    assert_chunks_close(got, want)
    assert np.linalg.norm(got.estimated_global - got.gt_global,
                          axis=-1).mean() < 0.25


def chunk_names(paths):
    return [os.path.basename(os.path.dirname(p)) for p in paths]


def test_process_sequence_cross_loads_with_jax(tmp_path, capsys):
    """A raw capture of 3 chunks through both packages' process_sequence:
    the same directories and printed lines; JAX's test_data.pkl read by
    the port's loader and the port's by JAX's, field by field."""
    paths = chip_smoke.write_raw_capture(str(tmp_path / "raw"), 104, 130,
                                         26, 130, 26, seed=0)
    args = (paths["slam"], paths["heatmap_dir"], paths["depth_dir"],
            paths["gt"])
    got = tptd.process_sequence(*args, str(tmp_path / "port"), 26, 130,
                                chunk_size=26, mat_start_frame=26,
                                device=CPU)
    port_lines = capsys.readouterr().out.splitlines()
    want = jptd.process_sequence(*args, str(tmp_path / "jax"), 26, 130,
                                 chunk_size=26, mat_start_frame=26)
    jax_lines = capsys.readouterr().out.splitlines()
    assert chunk_names(got) == chunk_names(want) == [
        "data_start_26_end_52", "data_start_52_end_78",
        "data_start_78_end_104"]
    assert [ln.split(":")[0] for ln in port_lines] == [
        ln.split(":")[0] for ln in jax_lines] == [
        "chunk 26..52", "chunk 52..78", "chunk 78..104"]
    for a, b in zip(port_lines, jax_lines):
        assert float(a.split()[-1]) == pytest.approx(float(b.split()[-1]),
                                                     abs=1e-4)
    for g, w in zip(got, want):
        assert_chunks_close(tload(w), tload(g))
        assert_chunks_close(jload(g), jload(w))


def test_preprocess_cli_with_calibration_and_mat_start(tmp_path, capsys):
    """Both CLIs on a capture whose GT array starts a chunk before
    --start (--mat_start_frame 26 --start 52) and a calibration JSON
    (the pose_fisheye rig): the same chunks."""
    paths = chip_smoke.write_raw_capture(str(tmp_path / "raw"), 104, 130,
                                         26, 130, 26, seed=1)
    calib = str(tmp_path / "calib.json")
    with open(calib, "w") as f:
        json.dump(tfe.POSE_FISHEYE_CALIBRATION, f)
    argv = [f"--{k}={v}" for k, v in paths.items()] + [
        "--start", "52", "--end", "130", "--chunk", "26",
        "--mat_start_frame", "26", "--calibration", calib]
    got = tcli.main(argv + ["--out", str(tmp_path / "port"), "--device",
                            "cpu"])
    want = jcli.main(argv + ["--out", str(tmp_path / "jax")])
    lines = capsys.readouterr().out.splitlines()
    assert chunk_names(got) == chunk_names(want) == [
        "data_start_52_end_78", "data_start_78_end_104"]
    assert [ln.split(":")[0] for ln in lines] == ["chunk 52..78",
                                                  "chunk 78..104"] * 2
    for g, w in zip(got, want):
        assert_chunks_close(tload(g), tload(w))
    with open(paths["gt"], "rb") as f:
        gt = pickle.load(f)
    np.testing.assert_array_equal(tload(got[0]).gt_global, gt[26:52])
    # the calibration reached the lift: the egosyn camera lifts elsewhere
    egosyn = tcli.main(argv[:-2] + ["--out", str(tmp_path / "ego"),
                                    "--device", "cpu"])
    assert np.abs(tload(egosyn[0]).estimated_local
                  - tload(got[0]).estimated_local).max() > 1e-3


def test_preprocess_cli_passes_jax_flags_and_defaults(monkeypatch):
    """Both CLIs hand process_sequence the same arguments, at the
    defaults and with every optional flag; the port adds --device
    (default cuda)."""
    calls = {}

    def recorder(name):
        def record(*args, **kw):
            calls[name] = (args, {k: v for k, v in kw.items()
                                  if k != "device"})
            calls[name + " device"] = kw.get("device")
        return record
    monkeypatch.setattr(jptd, "process_sequence", recorder("jax"))
    monkeypatch.setattr(tptd, "process_sequence", recorder("port"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    base = ["--slam", "s", "--heatmap_dir", "h", "--depth_dir", "d",
            "--gt", "g", "--out", "o", "--start", "551", "--end", "3300"]
    for extra in ([], ["--fps", "30", "--chunk", "50", "--mat_start_frame",
                       "500", "--calibration", "c.json"]):
        jcli.main(base + extra)
        tcli.main(base + extra)
        assert calls["port"] == calls["jax"]
        assert calls["port device"] == torch.device("cuda")
    tcli.main(base + ["--device", "cpu"])
    assert calls["port device"] == torch.device("cpu")


# ---------------------------------------------------------------------------
# BVH and Captury
# ---------------------------------------------------------------------------

def generated_bvh(n_joints=28, frames=7, frame_time=0.02, seed=0):
    """A hierarchy of `n_joints` joints (a spine with branches, End sites
    on the leaves) and `frames` frames of random root motion and
    rotations, at 1 / frame_time fps."""
    rng = np.random.default_rng(seed)
    children = {i: [] for i in range(n_joints)}
    for j in range(1, n_joints):
        children[int(rng.integers(max(0, j - 3), j))].append(j)
    n_chan = []

    def joint(j, depth):
        pad = "  " * depth
        kind = "ROOT" if j == 0 else "JOINT"
        off = rng.uniform(-80, 80, 3)
        chans = ("6 Xposition Yposition Zposition Zrotation Xrotation "
                 "Yrotation" if j == 0 else "3 Zrotation Yrotation Xrotation")
        n_chan.append(6 if j == 0 else 3)
        lines = [f"{pad}{kind} J{j}", f"{pad}{{",
                 f"{pad}  OFFSET {off[0]:.4f} {off[1]:.4f} {off[2]:.4f}",
                 f"{pad}  CHANNELS {chans}"]
        for c in children[j]:
            lines += joint(c, depth + 1)
        if not children[j]:
            lines += [f"{pad}  End Site", f"{pad}  {{",
                      f"{pad}    OFFSET 0.0 -20.0 0.0", f"{pad}  }}"]
        return lines + [f"{pad}}}"]
    lines = ["HIERARCHY"] + joint(0, 0)
    motion = rng.uniform(-40, 40, size=(frames, sum(n_chan)))
    lines += ["MOTION", f"Frames: {frames}", f"Frame Time: {frame_time}"]
    lines += [" ".join(f"{v:.5f}" for v in row) for row in motion]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("which", ["jax_test", "generated"])
def test_bvh_matches_jax(tmp_path, which):
    """JAX's BVH text (tests/test_tools.py::TestBvh) and a generated
    28-joint hierarchy at 50 fps: names, FK of every frame; on the
    generated one the 15 egocentric joints at 25 fps (stride 2)."""
    text = (generated_bvh() if which == "generated"
            else jax_tool_tests.TestBvh.BVH_TEXT)
    p = tmp_path / "motion.bvh"
    p.write_text(text)
    got, want = tbvh.Bvh().parse_file(str(p)), jbvh.Bvh().parse_file(str(p))
    assert got.joint_names() == want.joint_names()
    assert (got.frames, got.fps) == (want.frames, want.fps)
    gp, gn = got.all_frame_poses()
    wp, wn = want.all_frame_poses()
    assert gn == wn
    np.testing.assert_array_equal(gp, wp)
    if which == "jax_test":
        np.testing.assert_allclose(gp[1, 1], [-9, 2, 3], atol=1e-5)
        return
    assert len(gn) >= 27 and max(jbvh.EGOCENTRIC_JOINTS) < len(gn)
    seq = tbvh.extract_egocentric_sequence(str(p), start_frame=1)
    np.testing.assert_array_equal(
        seq, jbvh.extract_egocentric_sequence(str(p), start_frame=1))
    assert seq.shape == (3, 15, 3) and seq.dtype == np.float32
    np.testing.assert_allclose(
        seq[1], gp[3][list(tbvh.EGOCENTRIC_JOINTS)] / 1000.0, rtol=1e-6)


def test_captury_block_matches_jax(tmp_path):
    """tests/test_aux.py's two-camera file."""
    lines = []
    for cam_id in (0, 1):
        block = [f"camera\t{cam_id}\n"] + ["junk\n"] * 26
        block[11] = f"distortion {cam_id}.1 {cam_id}.2 0.0 0.0 0.0\n"
        for k, row in enumerate(range(17, 20)):
            block[row] = f"ext {cam_id}.0 {k}.0 0.0 1.0\n"
        for k, row in enumerate(range(21, 24)):
            block[row] = f"int {500 + cam_id} 0.0 {320 + k}.0\n"
        lines += block
    p = tmp_path / "cams.calib"
    p.write_text("".join(lines))
    for n in (0, 1):
        got = tcap.load_captury_camera(str(p), n)
        want = jcap.load_captury_camera(str(p), n)
        for f in ("intrinsic", "extrinsic", "distortion"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.intrinsic[0][0] == 501 and got.extrinsic.shape == (3, 4)
    with pytest.raises(ValueError, match="camera 7"):
        tcap.load_captury_camera(str(p), 7)
