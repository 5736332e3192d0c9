"""The port's options of the parity CLI and the library against the JAX
package: calibration files, flax msgpack priors (both directions), the
soft-smooth, overlap-consistency and GMM energy terms, the one-euro
filter and the scatter merge, the circular-history and compact L-BFGS
directions, the stage-1 residual, the soft-smooth anchor and the
rematerialised decode in the per-chunk path, and the CLI's --save and
--profile_dir; also the repairs of `merge=False`, `energy.gmm` and the
default mode of `optimize_chunks_batched`.

Tolerances: energies and gradients as tests/test_torch_energy.py (rtol
2e-5 / 1e-3); solver runs as tests/test_torch_lbfgs.py and
tests/test_lbfgs_fixed.py (rtol 1e-5, atol 1e-5; the compact direction
against the two-loop at rtol 1e-4, atol 1e-5, and its solve by its value
at rtol 1e-2); per-chunk runs at 2 + 1
iterations field by field as tests/test_torch_chunk.py (rtol 1e-3,
atol 2e-4); filters and merges at float32 rounding (rtol 1e-6, atol
1e-6)."""

import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from globalegomocap_tpu.data.test_data import save_test_chunk
from globalegomocap_tpu.energy import terms as jt
from globalegomocap_tpu.models.checkpoint import save_msgpack as jax_save
from globalegomocap_tpu.ops import filtering as jfilt
from globalegomocap_tpu.ops import fisheye as jfish
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu.optimize import lbfgs as jl
from globalegomocap_tpu.optimize import pipeline as jpipe
from globalegomocap_tpu.optimize import window as jwin
from globalegomocap_tpu.tools import ply as jply
from globalegomocap_tpu_torch.cli import optimize_sequence as tcli
from globalegomocap_tpu_torch.energy import terms as tt
from globalegomocap_tpu_torch.evaluation.metrics import (
    align_sequence_globally)
from globalegomocap_tpu_torch.models import checkpoint as tck
from globalegomocap_tpu_torch.models.convert import params_to_flax
from globalegomocap_tpu_torch.ops import filtering as tfilt
from globalegomocap_tpu_torch.ops import fisheye as tfish
from globalegomocap_tpu_torch.optimize import driver as tdriver
from globalegomocap_tpu_torch.optimize import lbfgs as tl
from globalegomocap_tpu_torch.optimize import pipeline as tpipe
from globalegomocap_tpu_torch.optimize import window as twin
from globalegomocap_tpu_torch.tools import ply as tply
from tests.test_torch_chunk import chunk_config
from tests.test_torch_lbfgs import B, D, _problem
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_chunk, port_state, tcfg)

PRIOR = ["--latent_dim", "32", "--hidden_dims", "8,8,16,16,32"]
FIELDS = ("estimated", "mid_local", "optimized", "gt")


@pytest.fixture(scope="module")
def prior():
    v = jax_variables(jdriver.build_model(chunk_config(jcfg)), seed=0)
    return v, port_state(v), chunks(26, seeds=(1,))[0]


# ---------------------------------------------------------------------------
# calibration files
# ---------------------------------------------------------------------------

def test_calibration_file_matches_jax(tmp_path):
    """A rig's calibration JSON (the pose_fisheye table with a shifted
    centre): the same four tensors as JAX's `load_calibration`, and the
    driver takes the path as its camera."""
    calib = dict(tfish.POSE_FISHEYE_CALIBRATION)
    calib["intrinsic"] = [[500, 0, 641.5, 0], [0, 500, 509.25, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]]
    path = str(tmp_path / "rig.json")
    with open(path, "w") as f:
        json.dump(calib, f)
    got, want = tfish.load_calibration(path), jfish.load_calibration(path)
    for name in ("center", "poly_c2w", "poly_w2c", "img_size"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    cam = tdriver.resolve_camera(chunk_config(tcfg, camera=path))
    np.testing.assert_array_equal(cam.center.numpy(), [641.5, 509.25])


@pytest.mark.parametrize("drop", ["intrinsic", "polynomialW2C"])
def test_calibration_without_a_key_raises(tmp_path, drop):
    calib = dict(tfish.EGOSYN_CALIBRATION)
    del calib[drop]
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump(calib, f)
    with pytest.raises(ValueError, match=drop):
        tfish.load_calibration(path)


# ---------------------------------------------------------------------------
# flax msgpack
# ---------------------------------------------------------------------------

def test_msgpack_reads_the_jax_file_bit_for_bit(prior, tmp_path):
    """The JAX package's save_msgpack file: every array bit for bit, and
    the port's writer gives the same bytes for the same variables."""
    v, sd, _ = prior
    jax_save(v, str(tmp_path / "jax.msgpack"))
    got = tck.load_msgpack(str(tmp_path / "jax.msgpack"))
    want = jax.tree_util.tree_map(np.asarray, v)
    paths = jax.tree_util.tree_leaves_with_path(want)
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(flat) == {p for p, _ in paths}
    for p, a in paths:
        assert flat[p].dtype == a.dtype and np.array_equal(flat[p], a), p
    tck.save_msgpack(params_to_flax(sd), str(tmp_path / "port.msgpack"))
    assert (tmp_path / "port.msgpack").read_bytes() == \
        (tmp_path / "jax.msgpack").read_bytes()


def test_flax_reads_the_port_file(prior, tmp_path):
    """flax's msgpack_restore on the port's file; the CLI loads it into
    the prior's state dict."""
    v, sd, _ = prior
    path = str(tmp_path / "port.msgpack")
    tck.save_msgpack(params_to_flax(sd), path)
    with open(path, "rb") as f:
        got = serialization.msgpack_restore(f.read())
    for p, a in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, v)):
        b = dict(jax.tree_util.tree_leaves_with_path(got))[p]
        assert b.dtype == a.dtype and np.array_equal(b, a), p
    model = tdriver.build_model(chunk_config(tcfg))
    state = tcli.load_variables(path, model)
    for k, t in sd.items():
        assert torch.equal(state[k], t), k


def test_msgpack_scalars_and_containers_both_ways():
    """Every type flax's serialiser writes for a variables tree or a
    trainer checkpoint: nil, bools, ints of each width, floats, strings,
    bin, lists, nested maps, numpy scalars and arrays of several
    dtypes."""
    tree = {"a": None, "b": [True, False], "c": {"i": [0, 127, 128, -1, -33,
                                                     300, 70000, -70000,
                                                     2 ** 40, -2 ** 40]},
            "d": 1.25, "e": "x" * 40, "f": b"\x01" * 300,
            "g": np.float32(2.5),
            "k": np.arange(6, dtype=np.int16).reshape(2, 3),
            "m": np.linspace(0, 1, 5, dtype=np.float64)}
    flax_bytes = serialization.msgpack_serialize(tree)
    assert tck.packb(tree) == flax_bytes
    for back in (tck.unpackb(flax_bytes),
                 serialization.msgpack_restore(tck.packb(tree))):
        assert back["c"] == tree["c"] and back["e"] == tree["e"]
        assert back["f"] == tree["f"]
        assert back["g"] == tree["g"] and back["g"].dtype == np.float32
        for k in ("k", "m"):
            assert back[k].dtype == tree[k].dtype
            np.testing.assert_array_equal(back[k], tree[k])


@pytest.mark.parametrize("cut", [1, 100, -3])
def test_a_truncated_msgpack_file_raises(prior, tmp_path, cut):
    v, _, _ = prior
    jax_save(v, str(tmp_path / "p.msgpack"))
    raw = (tmp_path / "p.msgpack").read_bytes()
    (tmp_path / "cut.msgpack").write_bytes(raw[:cut])
    with pytest.raises(ValueError, match="msgpack"):
        tck.load_msgpack(str(tmp_path / "cut.msgpack"))


# ---------------------------------------------------------------------------
# energies, filters, merges
# ---------------------------------------------------------------------------

def _windows(seed=0, w=3, t=10):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.3, size=(w, t, 15, 3)).astype(np.float32)


def test_soft_smooth_energy_matches_jax():
    pose, smoothed = _windows(1), _windows(2)
    je = jax.vmap(jt.soft_smooth_energy)(jnp.asarray(pose),
                                         jnp.asarray(smoothed))
    jg = jax.vmap(jax.grad(jt.soft_smooth_energy))(jnp.asarray(pose),
                                                   jnp.asarray(smoothed))
    p = torch.from_numpy(pose).requires_grad_(True)
    te = tt.soft_smooth_energy(p, torch.from_numpy(smoothed))
    (tg,) = torch.autograd.grad(te.sum(), p)
    np.testing.assert_allclose(te.detach().numpy(), je, rtol=2e-5)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("w", [1, 4])
def test_overlap_consistency_energy_matches_jax(w):
    """All windows of a chunk; one window has no neighbour (0)."""
    poses = _windows(3, w=w)
    je = jt.overlap_consistency_energy(jnp.asarray(poses), 8)
    jg = jax.grad(jt.overlap_consistency_energy)(jnp.asarray(poses), 8)
    p = torch.from_numpy(poses).requires_grad_(True)
    te = tt.overlap_consistency_energy(p, 8)
    tg = torch.autograd.grad(te, p)[0] if te.requires_grad \
        else torch.zeros_like(p)
    np.testing.assert_allclose(float(te.detach()), float(je), rtol=2e-5)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-3, atol=1e-4)


def test_total_energy_soft_smooth_and_gmm_terms_match_jax():
    """total_energy_from_pose with smoothed_pose and a GMM score function
    (a stand-in log-likelihood) in both packages, value and gradient."""
    pose, anchor, smoothed = _windows(4), _windows(5), _windows(6)
    bl = np.full((3, 15), 0.2, np.float32)
    kw = dict(weight_3d=0.01, smooth=0.001, bone_length=0.01, vae=0.0,
              reproj=0.0, gmm=0.5, soft_smooth=0.3)
    cam_j, cam_t = jfish.default_camera("egosyn"), tfish.default_camera(
        "egosyn")

    def j_one(p, a, b, s):
        return jt.total_energy_from_pose(
            p, a, b, None, cam_j, jt.EnergyWeights.create(**kw), False,
            gmm_score_fn=lambda x: -0.5 * jnp.sum(x * x, -1),
            smoothed_pose=s)
    args = [jnp.asarray(x) for x in (pose, anchor, bl, smoothed)]
    je = jax.vmap(j_one)(*args)
    jg = jax.vmap(jax.grad(j_one))(*args)
    p = torch.from_numpy(pose).requires_grad_(True)
    te = tt.total_energy_from_pose(
        p, torch.from_numpy(anchor), torch.from_numpy(bl), None, cam_t,
        tt.EnergyWeights.create(**kw), False,
        gmm_score_fn=lambda x: -0.5 * (x * x).sum(-1),
        smoothed_pose=torch.from_numpy(smoothed))
    (tg,) = torch.autograd.grad(te.sum(), p)
    np.testing.assert_allclose(te.detach().numpy(), je, rtol=2e-5)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-3, atol=1e-4)


def test_one_euro_filter_matches_jax():
    rng = np.random.default_rng(7)
    seq = np.cumsum(rng.normal(scale=0.05, size=(34, 15, 3)), 0).astype(
        np.float32)
    ts = np.arange(1, 35, dtype=np.float32) / 25.0
    for beta in (0.0, 0.3):
        want = jfilt.one_euro_filter(jnp.asarray(ts), jnp.asarray(seq),
                                     beta=beta)
        got = tfilt.one_euro_filter(torch.from_numpy(ts),
                                    torch.from_numpy(seq), beta=beta)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_scatter_merge_matches_jax_and_the_matmul_merge():
    wins = _windows(8, w=4)
    want = jwin.merge_windows(jnp.asarray(wins), 8)
    got = twin.merge_windows(torch.from_numpy(wins), 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), twin.merge_windows_matmul(torch.from_numpy(wins),
                                               8).numpy(),
        rtol=1e-6, atol=1e-6)
    batched = twin.merge_windows(torch.from_numpy(np.stack([wins, -wins])),
                                 8, batch_dims=1)
    np.testing.assert_allclose(batched[1].numpy(), -got.numpy(), rtol=1e-6)


@pytest.mark.parametrize("matmul_merge,method", [
    (False, "gaussian"), (False, "one_euro"), (True, "one_euro")])
def test_merge_window_fields_matches_jax(matmul_merge, method):
    """The pipeline's merge with the scatter mean and the smoothing after
    it (one_euro with timestamps (1..n) / 25), per chunk and with the
    flat path's chunk axis."""
    f = [_windows(10 + i, w=4) for i in range(5)]
    kw = dict(matmul_merge=matmul_merge, final_smooth_method=method)
    want = jpipe.merge_window_fields(
        jpipe.WindowFields(*map(jnp.asarray, f)), chunk_config(jcfg, **kw))
    got = tpipe.merge_window_fields(
        tpipe.WindowFields(*map(torch.from_numpy, f)),
        chunk_config(tcfg, **kw))
    flat = tpipe.merge_window_fields(
        tpipe.WindowFields(*(torch.from_numpy(np.stack([x, x]))
                             for x in f)),
        chunk_config(tcfg, **kw), batch_dims=1)
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_array_equal(getattr(flat, name)[1].numpy(), a)


# ---------------------------------------------------------------------------
# the solver's circular history and compact direction
# ---------------------------------------------------------------------------

def _histories(seed, m=6, fill=None):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(B, D)).astype(np.float32)
    s = rng.normal(size=(B, m, D)).astype(np.float32)
    y = (s * rng.uniform(0.5, 2.0, size=(B, m, 1))
         + 0.1 * rng.normal(size=(B, m, D))).astype(np.float32)
    rho = (1.0 / np.einsum("bmd,bmd->bm", s, y)).astype(np.float32)
    first = rng.integers(0, m + 1, size=(B, 1)) if fill is None else fill
    valid = np.arange(m)[None, :] >= first
    return g, s, y, rho, valid


def test_compact_direction_matches_jax_and_the_two_loop():
    g, s, y, rho, valid = _histories(3)
    s, y = s * valid[..., None], y * valid[..., None]
    dj = jax.vmap(jl._compact_direction)(*(jnp.asarray(x) for x in (
        g, s, y, valid)))
    args = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (g, s, y, rho, valid)]
    dt = tl._compact_direction(*args)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(dt.numpy(),
                               tl._two_loop_direction(*args).numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ptr", [0, 2, 5])
def test_circular_direction_matches_jax(ptr):
    """Each lane at its own pointer (ptr, ptr + 1, ...) against JAX's
    circular two-loop per lane and the rolled two-loop on the same pairs
    in rolled order."""
    g, s, y, rho, valid = _histories(5 + ptr)
    m = s.shape[1]
    ptrs = (ptr + np.arange(B)) % m
    dj = jax.vmap(jl._two_loop_direction_circular)(
        *(jnp.asarray(x) for x in (g, s, y, rho, valid)),
        jnp.asarray(ptrs, jnp.int32))
    dt = tl._two_loop_direction_circular(
        *(torch.from_numpy(x) for x in (g, s, y, rho, valid)),
        torch.from_numpy(ptrs))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-6)
    order = (ptrs[:, None] + np.arange(m)[None]) % m    # oldest first
    rolled = [np.take_along_axis(x, order[..., None] if x.ndim == 3
                                 else order, 1) for x in (s, y, rho, valid)]
    d_roll = tl._two_loop_direction(torch.from_numpy(g),
                                    *(torch.from_numpy(x) for x in rolled))
    np.testing.assert_allclose(dt.numpy(), d_roll.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("option,history", [
    ("circular_history", 3), ("circular_history", 25),
    ("compact_direction", 10)])
def test_lbfgs_fixed_options_match_jax(option, history):
    """jax.vmap of JAX's lbfgs_minimize_fixed with the option, on the
    seeded quadratics, 8 iterations (a history of 3 wraps); the circular
    history also equals the port's own rolled run."""
    a, rhs, x0 = _problem(seed=6)
    kw = dict(max_iter=8, history_size=history, fused_probes=True,
              **{option: True})

    def jloss(x, a_, r_):
        return 0.5 * x @ a_ @ x - r_ @ x
    rj = jax.vmap(lambda x, a_, r_: jl.lbfgs_minimize_fixed(
        lambda z: jloss(z, a_, r_), x, **kw))(
        jnp.asarray(x0), jnp.asarray(a), jnp.asarray(rhs))
    ta, tr = torch.from_numpy(a), torch.from_numpy(rhs)

    def tloss(x):
        return (0.5 * torch.einsum("...bi,bij,...bj->...b", x, ta, x)
                - torch.einsum("bi,...bi->...b", tr, x))
    rt = tl.lbfgs_minimize_fixed(tloss, torch.from_numpy(x0), **kw)
    if option == "compact_direction":
        # the matrix form rounds otherwise than the recursion, and that
        # can move a candidate pick: JAX's own trajectory test holds the
        # compact solve by its value at rtol 1e-2
        np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f),
                                   rtol=1e-2, atol=1e-6)
        return
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f), rtol=1e-5,
                               atol=1e-5)
    if option == "circular_history":
        r0 = tl.lbfgs_minimize_fixed(tloss, torch.from_numpy(x0),
                                     **{**kw, option: False})
        np.testing.assert_allclose(rt.x.numpy(), r0.x.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("other", ["pallas_direction", "compact_direction"])
def test_circular_history_with_a_rolled_reader_raises(other):
    """As in JAX: those direction readers take the rolled layout."""
    _, _, x0 = _problem()
    with pytest.raises(ValueError, match="circular_history"):
        tl.lbfgs_minimize_fixed(lambda v: v.square().sum(-1),
                                torch.from_numpy(x0), circular_history=True,
                                **{other: True})


# ---------------------------------------------------------------------------
# the per-chunk path's options against JAX
# ---------------------------------------------------------------------------

def _run_both(prior, energy=None, solver=None):
    """SequenceOptimizer.run of both packages at the parity CLI's
    lbfgs_fixed knobs, 2 + 1 iterations, full maps (the port's pallas
    sampling is the plain version here, JAX's dense the same function)."""
    v, sd, c = prior
    out = []
    for pkg, drv, sampling in ((jcfg, jdriver, "dense"),
                               (tcfg, tdriver, "pallas")):
        cfg = chunk_config(pkg, sampling, max_iter=2, global_max_iter=1)
        cfg = replace(cfg, energy=replace(cfg.energy, **(energy or {})),
                      solver=replace(cfg.solver, **(solver or {})))
        kw = {} if pkg is jcfg else {"device": "cpu"}
        w = v if pkg is jcfg else sd
        opt = drv.SequenceOptimizer(drv.build_model(cfg), w, w, cfg, **kw)
        out.append(opt.run(c if pkg is jcfg else port_chunk(c))[1:])
    return out


@pytest.mark.parametrize("energy,solver", [
    ({"local_residual": True}, None),
    ({"soft_smooth": 0.5}, {"remat": True})],
    ids=["local_residual", "soft_smooth-remat"])
def test_pipeline_options_match_jax(prior, energy, solver):
    jf, tf = _run_both(prior, energy, solver)
    for name, a, b in zip(FIELDS, tf, jf):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=2e-4,
                                   err_msg=name)


def test_remat_equals_the_run_without_it(prior):
    """The rematerialised decode recomputes the same activations."""
    v, sd, c = prior
    res = []
    for remat in (False, True):
        cfg = chunk_config(tcfg, "pallas", max_iter=2, global_max_iter=1,
                           energy=tcfg.EnergyConfig(soft_smooth=0.5))
        cfg = replace(cfg, solver=replace(cfg.solver, remat=remat))
        opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sd, sd,
                                        cfg, device="cpu")
        res.append(opt.run(port_chunk(c), with_metrics=False)[1:])
    for name, a, b in zip(FIELDS, *res):
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# the repairs: merge=False, energy.gmm, the vmap default
# ---------------------------------------------------------------------------

def _port_run(prior, **overrides):
    _, sd, c = prior
    cfg = chunk_config(tcfg, "pallas", max_iter=1, global_max_iter=1,
                       **overrides)
    opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sd, sd, cfg,
                                    device="cpu")
    return opt.run(port_chunk(c), with_metrics=False)[1:]


@pytest.mark.parametrize("overrides", [
    {"merge": False}, {"energy": tcfg.EnergyConfig(gmm=0.5)}],
    ids=["merge-false", "gmm"])
def test_options_no_module_reads_run_as_in_jax(prior, overrides):
    """No module of the JAX package reads cfg.merge, and the GMM term
    joins only with a score function, which no entry point passes: both
    run and give the default's result."""
    for name, a, b in zip(FIELDS, _port_run(prior, **overrides),
                          _port_run(prior)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_optimize_chunks_batched_defaults_to_vmap(prior):
    """JAX's default mode: with no mode, each chunk through the per-chunk
    pipeline, not the flat solve."""
    _, sd, _ = prior
    cfg = chunk_config(tcfg, "pallas", max_iter=1, global_max_iter=1)
    opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sd, sd, cfg,
                                    device="cpu")
    calls = []
    per_chunk = tpipe.optimize_chunk

    def counted(*args, **kwargs):
        calls.append(1)
        return per_chunk(*args, **kwargs)
    cs = [port_chunk(c) for c in chunks(26, seeds=(1, 2))]
    tpipe.optimize_chunk = counted
    try:
        res = opt.optimize_chunks_batched(opt.stage(cs))
    finally:
        tpipe.optimize_chunk = per_chunk
    assert len(calls) == 2 and res.optimized.shape == (2, 26, 15, 3)


@pytest.mark.parametrize("name", ["optimize_sequence", "serve",
                                  "evaluate_all"])
def test_the_port_cli_takes_every_flag_of_the_jax_cli(name):
    """The JAX serve and evaluate_all take the parity CLI's parser as
    their parent and add their own flags inside `main`; the port's
    parser of the same CLI has each of them."""
    import importlib
    import inspect
    import re
    jmod = importlib.import_module(f"globalegomocap_tpu.cli.{name}")
    tmod = importlib.import_module(f"globalegomocap_tpu_torch.cli.{name}")
    from globalegomocap_tpu.cli import optimize_sequence as jseq
    want = set(re.findall(r'add_argument\("(--[a-z_]+)"',
                          inspect.getsource(jmod)))
    if name != "optimize_sequence":
        want |= {f for a in jseq.build_parser()._actions
                 for f in a.option_strings}
    have = {f for a in tmod.build_parser()._actions for f in a.option_strings}
    assert want - have == set()


# ---------------------------------------------------------------------------
# the CLI's --save and --profile_dir
# ---------------------------------------------------------------------------

def test_ply_writer_matches_jax_byte_for_byte(tmp_path):
    seq = _windows(20, w=1, t=3)[0]
    a = tply.save_skeleton_sequence(seq, str(tmp_path / "port"))
    b = jply.save_skeleton_sequence(seq, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in a] == \
        [os.path.basename(p) for p in b] == [f"out_{i:04d}.ply"
                                             for i in range(3)]
    for p, q in zip(a, b):
        assert open(p, "rb").read() == open(q, "rb").read()
    v, f = tply.skeleton_mesh(seq[0])
    tply.write_ply(str(tmp_path / "a.ply"), v, f, binary=False)
    jply.write_ply(str(tmp_path / "b.ply"), v, f, binary=False)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()


def test_cli_save_and_profile_dir(prior, tmp_path, capsys):
    """--save true writes the three globally aligned sequences of each
    chunk as PLY, byte for byte what the JAX writer makes of the same
    aligned arrays (the port's alignment of the port's run); --profile_dir writes a Chrome trace and leaves the
    metrics as they are."""
    v, sd, c = prior
    seq = tmp_path / "seqA"
    save_test_chunk(c, str(seq / "data_start_0_end_26"))
    ck = str(tmp_path / "prior.msgpack")
    jax_save(v, ck)
    argv = ["--data_path", str(seq), "--local_ckpt", ck, "--global_ckpt",
            ck, "--device", "cpu", "--solver", "lbfgs_fixed", "--max_iter",
            "1", "--global_max_iter", "1"] + PRIOR
    out, trace = tmp_path / "out", tmp_path / "trace"
    avg = tcli.main(argv + ["--save", "true", "--out_dir", str(out),
                            "--profile_dir", str(trace)])
    plain = tcli.main(argv)
    assert "SKIPPED" not in capsys.readouterr().out
    for k, x in plain.items():
        np.testing.assert_array_equal(avg[k], x, err_msg=k)
    traces = os.listdir(trace)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(trace / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    base = out / "data_start_0_end_26"
    assert sorted(os.listdir(base)) == ["gt_global_aligned",
                                        "input_global_aligned",
                                        "optimized_global_aligned"]
    cfg = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sd, sd, cfg,
                                    device="cpu")
    est, _, opt_seq, gt = (torch.from_numpy(x) for x in opt.run(
        port_chunk(c), with_metrics=False)[1:])
    for name, arr in (("optimized_global_aligned",
                       align_sequence_globally(opt_seq, gt)),
                      ("input_global_aligned",
                       align_sequence_globally(est, gt)),
                      ("gt_global_aligned", gt)):
        ref = jply.save_skeleton_sequence(arr.numpy(),
                                          str(tmp_path / "ref" / name))
        assert len(os.listdir(base / name)) == 26
        for p in ref:
            got = (base / name / os.path.basename(p)).read_bytes()
            assert got == open(p, "rb").read(), (name, p)
