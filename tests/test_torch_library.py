"""The port's remaining library against the JAX package's: the Blender
camera conversions (`ops/blender.py`, to 1e-12), `draw_joints` on its
cv2 branch and on its numpy branch (cv2 hidden from both packages; the
images equal), `MetricLogger`'s JSONL and TensorBoard files,
`SpanTimer`'s summary, `covered_frames` over a grid, `per_joint_error`
and `align_per_frame` (1e-5), `load_priors_from_torch` on one .pth.tar
pair against JAX's (poses at 2 + 1 fixed iterations within 1e-4 m),
`make_chunk_optimizer` against `optimize_chunk` (bit for bit), and the
names: every name a JAX `__init__.py` re-exports imports from the
port's counterpart, and every public top-level def or class of a JAX
module has one in the port's module, except the departures ROADMAP.md
lists."""

import ast
import json
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import globalegomocap_tpu
import globalegomocap_tpu_torch
from globalegomocap_tpu.evaluation import metrics as jmetrics
from globalegomocap_tpu.ops import blender as jblender
from globalegomocap_tpu.optimize import window as jwindow
from globalegomocap_tpu.tools import draw as jdraw
from globalegomocap_tpu.utils.logging import MetricLogger as JLogger
from globalegomocap_tpu_torch.evaluation import metrics as tmetrics
from globalegomocap_tpu_torch.ops import blender as tblender
from globalegomocap_tpu_torch.optimize import window as twindow
from globalegomocap_tpu_torch.tools import draw as tdraw
from globalegomocap_tpu_torch.utils.logging import MetricLogger
from globalegomocap_tpu_torch.utils.profiling import SpanTimer
from tests.torch_port_helpers import (
    TINY_PRIOR, chunks, jcfg, port_chunk, port_state, slice_config, tcfg)

JAX_ROOT = os.path.dirname(globalegomocap_tpu.__file__)
PORT_ROOT = os.path.dirname(globalegomocap_tpu_torch.__file__)

# ROADMAP.md "Left out on purpose": (JAX module, name)
DEPARTURES = {
    ("train/__init__.py", "TrainState"),
    ("native/__init__.py", "native_available"),
    ("train/train_vae.py", "TrainState"),
    ("train/train_vae.py", "make_epoch_step"),
    ("native/hostcrop.py", "native_available"),
    ("models/conv_vae.py", "BaseVAE"),
    ("models/conv_vae.py", "ConvBNAct"),
    ("optimize/prior_bank.py", "motion_accel_stat_jax"),
    ("evaluation/metrics.py", "calculate_errors_jit"),
}
DEPARTED_MODULES = {"models/torch_convert.py"}


# ---------------------------------------------------------------- blender

def test_blender_conversions_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(4):
        loc1, loc2 = rng.normal(size=3), rng.normal(size=3)
        rot1, rot2 = rng.uniform(-np.pi, np.pi, (2, 3))
        for name in ("cv_rt_from_blender", "cv_rt_from_cv"):
            for a, b in zip(getattr(tblender, name)(loc1, rot1),
                            getattr(jblender, name)(loc1, rot1)):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        for a, b in zip(
                tblender.relative_transform_from_blender(loc1, rot1, loc2,
                                                         rot2),
                jblender.relative_transform_from_blender(loc1, rot1, loc2,
                                                         rot2)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    cams = np.tile(np.eye(4), (5, 1, 1))
    cams[:, :3, 3] = rng.normal(size=(5, 3))
    last = tblender.cv_rt_from_cv(loc1, rot1)[2]
    np.testing.assert_allclose(
        tblender.consecutive_global_cameras(cams, last),
        jblender.consecutive_global_cameras(cams, last), rtol=0, atol=1e-12)


# ---------------------------------------------------------------- drawing

def _skeleton_image(draw):
    rng = np.random.default_rng(3)
    joints = rng.uniform(20, 200, size=(15, 2))
    joints[3] = (-30.0, 250.0)              # off the image: clipped
    return draw(joints, np.zeros((240, 256, 3), np.uint8))


@pytest.mark.parametrize("branch", ["cv2", "numpy"])
def test_draw_joints_matches_jax(branch, monkeypatch):
    if branch == "numpy":
        monkeypatch.setitem(sys.modules, "cv2", None)
    else:
        pytest.importorskip("cv2")
    assert tdraw.backend() == branch
    got = _skeleton_image(tdraw.draw_joints)
    want = _skeleton_image(jdraw.draw_joints)
    assert got.any()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- logging

def test_metric_logger_jsonl(tmp_path):
    lg = MetricLogger(str(tmp_path / "port"), tensorboard=False)
    jl = JLogger(str(tmp_path / "jax"), tensorboard=False)
    for logger in (lg, jl):
        logger.scalar("loss", 1.5, 0)
        logger.scalar("loss", np.float32(1.2), 1)
        logger.close()
    assert not lg.tensorboard
    rows = [[json.loads(ln) for ln in open(tmp_path / d / "metrics.jsonl")]
            for d in ("port", "jax")]
    assert len(rows[0]) == 2 and rows[0][1]["value"] == pytest.approx(1.2)
    for a, b in zip(*rows):
        assert set(a) == set(b) == {"t", "name", "value", "step"}
        assert (a["name"], a["value"], a["step"]) == \
            (b["name"], b["value"], b["step"])


class _Writer:
    """A stand-in SummaryWriter: importing the real one loads TensorBoard
    (and TensorFlow where installed), 9-13 s here, while what the logger
    owes it is the directory and the calls."""
    made = []

    def __init__(self, log_dir):
        os.makedirs(log_dir)
        self.log_dir, self.scalars, self.closed = log_dir, [], False
        _Writer.made.append(self)

    def add_scalar(self, name, value, step):
        self.scalars.append((name, value, step))

    def close(self):
        self.closed = True


def test_metric_logger_tensorboard(tmp_path, monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=_Writer))
    lg = MetricLogger(str(tmp_path), tensorboard=True)
    lg.scalar("loss", np.float32(0.5), 3)
    lg.close()
    assert lg.tensorboard and os.path.exists(tmp_path / "metrics.jsonl")
    w = _Writer.made[-1]
    assert w.log_dir == str(tmp_path / "tensorboard")
    assert os.path.isdir(tmp_path / "tensorboard")
    assert w.scalars == [("loss", 0.5, 3)] and w.closed


def test_metric_logger_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lg = MetricLogger(str(tmp_path), tensorboard=True)
    lg.scalar("loss", 0.5, 0)
    lg.close()
    assert not lg.tensorboard and not os.path.isdir(tmp_path / "tensorboard")
    assert len(open(tmp_path / "metrics.jsonl").readlines()) == 1


def test_span_timer_summary():
    t = SpanTimer()
    for _ in range(3):
        with t.span("solve", sync_value=torch.zeros(2)):
            pass
    with t.span("stage"):
        pass
    s = t.summary()
    assert set(s) == {"solve", "stage"}
    assert set(s["solve"]) == {"mean_s", "total_s", "count"}
    assert s["solve"]["count"] == 3 and s["solve"]["total_s"] >= 0
    assert json.loads(t.report()) == s


# ---------------------------------------------------------------- windows

def test_covered_frames_matches_jax():
    for n in range(0, 60):
        for seq_len, stride in ((10, 8), (10, 10), (5, 2), (10, 1)):
            assert twindow.covered_frames(n, seq_len, stride) == \
                jwindow.covered_frames(n, seq_len, stride), (n, seq_len)


# ---------------------------------------------------------------- metrics

def test_per_joint_error_and_align_per_frame_match_jax():
    rng = np.random.default_rng(5)
    gt = rng.normal(size=(12, 15, 3)).astype(np.float32)
    pred = (0.9 * gt + rng.normal(scale=0.05, size=gt.shape)
            + 0.3).astype(np.float32)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    np.testing.assert_allclose(
        tmetrics.per_joint_error(tp, tg).numpy(),
        np.asarray(jax.jit(jmetrics.per_joint_error)(jp, jg)), rtol=1e-5)
    np.testing.assert_allclose(
        tmetrics.align_per_frame(tp, tg).numpy(),
        np.asarray(jax.jit(jmetrics.align_per_frame)(jp, jg)),
        rtol=1e-5, atol=1e-5)
    for align in (False, True):
        np.testing.assert_allclose(
            float(tmetrics.camera_position_error(tp, tg, align)),
            float(jax.jit(jmetrics.camera_position_error,
                          static_argnums=2)(jp, jg, align)), rtol=1e-5)


# --------------------------------------------------- priors and optimizers

@pytest.fixture(scope="module")
def pth_pair(tmp_path_factory):
    """Two Flax initialisations of the tiny prior written as reference
    .pth.tar training checkpoints (local, global)."""
    from globalegomocap_tpu.optimize.driver import build_model
    model = build_model(slice_config(jcfg))
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, 10, 45)), False))
    paths = []
    d = tmp_path_factory.mktemp("pth")
    for i, seed in enumerate((10, 11)):
        v = init(jax.random.PRNGKey(seed))
        p = str(d / f"prior{i}.pth.tar")
        torch.save({"epoch": 3, "state_dict": port_state(v)}, p)
        paths.append(p)
    return paths


def test_load_priors_from_torch_matches_jax(pth_pair):
    from globalegomocap_tpu.optimize.driver import (
        load_priors_from_torch as jload)
    from globalegomocap_tpu_torch.optimize.driver import (
        load_priors_from_torch as tload)
    def cfg(pkg):
        """The reference-parity path's plain stack at 2 + 1 iterations
        (JAX compiles it in half the time of serve's fused stack)."""
        return pkg.OptimizeConfig(
            prior=pkg.PriorConfig(**TINY_PRIOR),
            solver=pkg.SolverConfig(method="lbfgs_fixed", max_iter=2,
                                    global_max_iter=1, history_size=2),
            heatmap_crop=8)
    chunk = chunks(26, seeds=(3,))[0]
    jopt = jload(cfg(jcfg), *pth_pair)
    topt = tload(cfg(tcfg), *pth_pair, device="cpu")
    assert topt.device.type == "cpu"
    _, _, jmid, jopt_pose, _ = jopt.run(chunk, with_metrics=False)
    _, _, tmid, topt_pose, _ = topt.run(port_chunk(chunk),
                                        with_metrics=False)
    np.testing.assert_allclose(tmid, jmid, rtol=0, atol=1e-4)
    np.testing.assert_allclose(topt_pose, jopt_pose, rtol=0, atol=1e-4)


def test_make_chunk_optimizer_is_optimize_chunk(pth_pair):
    from globalegomocap_tpu_torch.cli.serve import load_state
    from globalegomocap_tpu_torch.optimize import pipeline
    from globalegomocap_tpu_torch.optimize.driver import (
        build_model, resolve_camera)
    cfg = slice_config(tcfg, max_iter=2, global_max_iter=1,
                       heatmap_crop=0)
    model = build_model(cfg)
    states = [load_state(p, model) for p in pth_pair]
    camera = resolve_camera(cfg)
    fn = pipeline.make_chunk_optimizer(model, cfg, camera)
    c = port_chunk(chunks(18, seeds=(4,))[0])
    args = [torch.from_numpy(np.asarray(getattr(c, f), np.float32)) for f in
            ("estimated_local", "camera_poses", "heatmaps", "gt_global")]
    got = fn(*states, *args)
    models = []
    for s in states:
        m = build_model(cfg)
        m.load_state_dict(s)
        models.append(m.eval().requires_grad_(False))
    with torch.no_grad():
        want = pipeline.optimize_chunk(*models, *args, camera, cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ------------------------------------------------------------------ names

def _exported(init_path):
    """The names an __init__.py imports from its package's modules."""
    names = set()
    for node in ast.parse(open(init_path).read()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


def _defined(path):
    """Public top-level defs, classes and assigned names of a module."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def _jax_modules(basename=None):
    for dirpath, _, files in os.walk(JAX_ROOT):
        rel_dir = os.path.relpath(dirpath, JAX_ROOT)
        if "pallas" in rel_dir.split(os.sep) or "__pycache__" in rel_dir:
            continue      # the kernels: ops/*.py and csrc/ in the port
        for f in sorted(files):
            if f.endswith(".py") and (basename is None or f == basename):
                yield os.path.normpath(os.path.join(rel_dir, f))


@pytest.mark.parametrize("rel", sorted(_jax_modules("__init__.py")))
def test_package_reexports_every_jax_name(rel):
    import importlib
    pkg = "globalegomocap_tpu_torch" + (
        "." + os.path.dirname(rel).replace(os.sep, ".")
        if os.path.dirname(rel) else "")
    mod = importlib.import_module(pkg)
    missing = sorted(n for n in _exported(os.path.join(JAX_ROOT, rel))
                     if (rel, n) not in DEPARTURES and not hasattr(mod, n))
    assert not missing, (pkg, missing)


def test_every_jax_module_name_has_a_counterpart():
    missing = []
    for rel in _jax_modules():
        if rel.endswith("__init__.py") or rel in DEPARTED_MODULES:
            continue
        port = os.path.join(PORT_ROOT, rel)
        if not os.path.exists(port):
            missing.append(rel)
            continue
        missing += [f"{rel}::{n}" for n in sorted(
            _defined(os.path.join(JAX_ROOT, rel)) - _defined(port))
            if (rel, n) not in DEPARTURES]
    assert not missing, missing
