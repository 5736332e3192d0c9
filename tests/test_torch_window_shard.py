"""The port's window-sharded solve (`parallel/window_shard.py`,
`SequenceOptimizer.optimize_chunk_sharded`) against the JAX package's on
its 8 virtual CPU devices (tests/conftest.py), on the 42-frame chunk of
tests/test_window_shard.py: 5 windows at stride 8, which divide neither
2 nor 3 ranks, so the edge padding and the slice before the merge run.

The ranks are three gloo processes on the CPU (`parallel.mesh.spawn`),
spawned once for the module, which solve over all three and then over
ranks 0 and 1 as a group of their own; they run
`tests/torch_parallel_workers.py`, which imports no JAX.  Tolerances:
JAX's own test's (rtol 2e-4, atol 1e-5) against JAX's window-sharded
solve; 1e-5 relative (1e-6 absolute) against the port's one-rank solve,
for the crops cut in the solve, the full maps and the fused energy."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from globalegomocap_tpu.config import (
    EnergyConfig, OptimizeConfig, PriorConfig, SolverConfig)
from globalegomocap_tpu.data.synthetic import synthetic_chunk
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu.parallel.mesh import make_mesh as jax_mesh
from globalegomocap_tpu_torch import config as tc
from globalegomocap_tpu_torch.optimize import pipeline
from globalegomocap_tpu_torch.parallel import mesh as pm
from globalegomocap_tpu_torch.parallel.window_shard import (
    optimize_chunk_window_sharded)
from tests import torch_parallel_workers as workers
from tests.torch_port_helpers import port_chunk, port_state

WORLDS = [2, 3]


def small_cfg(pkg, **kw):
    """tests/test_window_shard.py's configuration, from either package's
    config classes; the guard off."""
    base = dict(
        prior=pkg.PriorConfig(latent_dim=16, seq_len=10,
                              hidden_dims=(8, 8, 16)),
        energy=pkg.EnergyConfig(global_residual=True),
        solver=pkg.SolverConfig(method="lbfgs_fixed", max_iter=3,
                                history_size=2, step_candidates=(1.0, 0.1)),
        sampling_impl="dense", fold_bn=False, heatmap_crop_min_mass=0.0)
    base.update(kw)
    return pkg.OptimizeConfig(**base)


class _J:   # the JAX package's config classes, as small_cfg takes them
    PriorConfig, EnergyConfig, SolverConfig, OptimizeConfig = (
        PriorConfig, EnergyConfig, SolverConfig, OptimizeConfig)


def fused(pkg):
    return small_cfg(pkg, heatmap_crop=4, solver=pkg.SolverConfig(
        method="lbfgs_fixed", max_iter=3, history_size=2,
        step_candidates=(1.0, 0.1), fused_probes=True, fused_energy=True),
        fold_bn=True, dense_decoder=True, decoder_impl="conv")


@pytest.fixture(scope="module")
def case():
    """JAX's weights (the test's seeds 0 and 1), the chunk, the port's
    cases and JAX's window-sharded solve at heatmap_crop 4."""
    jc = small_cfg(_J, heatmap_crop=4)
    model = jdriver.build_model(jc)
    x = jnp.zeros((1, 10, 45))
    v1 = model.init(jax.random.PRNGKey(0), x, False)
    v2 = model.init(jax.random.PRNGKey(1), x, False)
    chunk = synthetic_chunk(42, seed=3)
    jopt = jdriver.SequenceOptimizer(model, v1, v2, jc)
    want = jopt.optimize_chunk_sharded(chunk, mesh=jax_mesh())
    l, g, c = port_state(v1), port_state(v2), port_chunk(chunk)
    cases = [("crop4", small_cfg(tc, heatmap_crop=4), l, g, c),
             ("fullmap", small_cfg(tc, heatmap_crop=0), l, g, c),
             ("fused", fused(tc), l, g, c)]
    return cases, jax.tree_util.tree_map(np.asarray, want)._asdict()


@pytest.fixture(scope="module")
def solved(case):
    """Each world's ranks' results, and the one-rank solve of the same
    worker: one group of 3 ranks solves every case, then ranks 0 and 1 as
    a group of their own."""
    cases, _ = case
    one = workers.window_sharded(pm.make_mesh(device="cpu"), cases)
    out = pm.spawn(workers.two_and_all, 3, ["cpu"] * 3, timeout_s=300,
                   threads=1,
                   args=([("window_sharded", (cases,))],
                         [("window_sharded", (cases,))]))
    return {3: [r["all"][0] for r in out],
            2: [r["two"][0] for r in out[:2]]}, one


@pytest.mark.parametrize("world", WORLDS)
def test_window_sharded_solve_matches_jax(case, solved, world):
    """Every rank returns the same merged chunk (42 frames), through the
    library function and SequenceOptimizer's method alike, within the
    JAX test's tolerance of JAX's window-sharded solve and 1e-5 of one
    rank's."""
    _, want = case
    ranks, one = solved
    for rec in ranks[world]:
        for key in ("crop4", "crop4/driver"):
            for name, w in want.items():
                got = rec[key][name]
                assert got.shape == w.shape == (42, 15, 3), name
                np.testing.assert_array_equal(got,
                                              ranks[world][0][key][name])
                np.testing.assert_allclose(got, w, rtol=2e-4, atol=1e-5,
                                           err_msg=f"{key} {name}")
                np.testing.assert_allclose(got, one[key][name], rtol=1e-5,
                                           atol=1e-6, err_msg=f"{key} {name}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["fullmap", "fused"])
def test_window_sharded_paths_match_one_rank(solved, world, key):
    """The full-map path and the fused energy (the kernels' plain
    versions here) sharded over 2 and 3 ranks: one rank's result."""
    ranks, one = solved
    for rec in ranks[world]:
        for name, w in one[key].items():
            assert np.isfinite(rec[key][name]).all()
            np.testing.assert_allclose(rec[key][name], w, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{key} {name}")


def test_one_rank_is_the_per_chunk_solve(case):
    """On a mesh of one rank the window-sharded solve is
    `pipeline.optimize_chunk`, bit for bit."""
    cases, _ = case
    _, cfg, l, g, c = cases[0]
    opt = workers.driver.SequenceOptimizer(
        workers.driver.build_model(cfg), l, g, cfg, device="cpu")
    args = (opt.local_model, opt.global_model) + tuple(
        torch.as_tensor(np.asarray(x, dtype=np.float32)) for x in (
            c.estimated_local, c.camera_poses, c.heatmaps, c.gt_global)) + (
        opt._camera_dev, cfg)
    a = pipeline.optimize_chunk(*args)
    b = optimize_chunk_window_sharded(*args, mesh=pm.make_mesh(device="cpu"))
    for f in a._fields:
        torch.testing.assert_close(getattr(b, f), getattr(a, f), rtol=0,
                                   atol=0)


def test_the_joint_solve_is_refused(case):
    """energy.overlap_consistency couples the windows: ValueError, as in
    JAX."""
    cases, _ = case
    _, cfg, l, g, c = cases[0]
    cfg = replace(cfg, energy=replace(cfg.energy, overlap_consistency=0.5))
    opt = workers.driver.SequenceOptimizer(
        workers.driver.build_model(cfg), l, g, cfg, device="cpu")
    with pytest.raises(ValueError, match="overlap_consistency"):
        opt.optimize_chunk_sharded(c)
