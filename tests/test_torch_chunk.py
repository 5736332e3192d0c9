"""The port's per-chunk path (`SequenceOptimizer.run` -> `optimize_chunk`
-> per-window `lbfgs_minimize_fixed`) against the JAX package's `run` on
full maps, the configuration of the reference-parity CLI
(`--solver lbfgs_fixed`, fused probes off, history 25, 4 step
candidates, eval-mode BatchNorm): field by field at 2+1 iterations and by
the 17 metrics within 5 % at the CLI's 25+25.  The port's `pallas`
sampling is the heatmap_sample kernel's plain version on the CPU; its JAX
counterpart here is the `dense` reference sampling (the same function),
which keeps the JAX side out of interpret mode for speed.  Also: the
per-chunk path with crops cut on the device inside the solve, and the
crop-mass guard measured on raw maps."""

from dataclasses import replace

import numpy as np
import pytest

from globalegomocap_tpu.data.synthetic import synthetic_chunk_v2
from globalegomocap_tpu.evaluation.metrics import METRIC_KEYS
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.optimize import driver as tdriver
from tests.torch_port_helpers import (
    TINY_PRIOR, chunks, jax_variables, jcfg, port_chunk, port_state, tcfg)

JAX_IMPL = {"gather": "gather", "dense": "dense", "pallas": "dense"}


def chunk_config(pkg, sampling="gather", max_iter=25, global_max_iter=None,
                 **overrides):
    """The parity CLI's configuration with --solver lbfgs_fixed."""
    kw = dict(
        prior=pkg.PriorConfig(**TINY_PRIOR),
        solver=pkg.SolverConfig(method="lbfgs_fixed", max_iter=max_iter,
                                history_size=25, global_max_iter=(
                                    global_max_iter),
                                step_candidates=(1.0, 0.5, 0.1, 0.02)),
        sampling_impl=sampling, heatmap_crop=0, camera="egosyn")
    kw.update(overrides)
    return pkg.OptimizeConfig(**kw)


@pytest.fixture(scope="module")
def inputs():
    jm = jdriver.build_model(chunk_config(jcfg))
    v = jax_variables(jm, seed=0)
    return v, port_state(v), chunks(26, seeds=(1,))[0]


def _run_both(inputs, sampling, **knobs):
    v, sd, c = inputs
    jc = chunk_config(jcfg, JAX_IMPL[sampling], **knobs)
    tc = chunk_config(tcfg, sampling, **knobs)
    jout = jdriver.SequenceOptimizer(jdriver.build_model(jc), v, v, jc).run(c)
    topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                     device="cpu")
    return jout, topt.run(port_chunk(c)), topt


@pytest.mark.parametrize("sampling", ["gather", "dense", "pallas"])
def test_run_matches_jax_field_by_field(inputs, sampling):
    """2 stage-1 and 1 stage-2 iterations on full 64x64 maps: every
    returned field at the batched-solver tolerance of
    tests/test_torch_pipeline.py."""
    (_, *jf), (_, *tf), _ = _run_both(inputs, sampling, max_iter=2,
                                      global_max_iter=1)
    for name, a, b in zip(("estimated", "mid_local", "optimized", "gt"),
                          tf, jf):
        assert a.shape == np.asarray(b).shape == (26, 15, 3), name
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=2e-4,
                                   err_msg=name)


def test_run_metrics_match_jax_at_parity_knobs(inputs):
    """25+25 iterations, history 25, the slice's pallas sampling: the
    line search may branch on rounding after many iterations, so the 17
    metrics within 5 %.  (The gather and dense samplings are held field
    by field above.)"""
    (jerr, *_), (terr, *_), _ = _run_both(inputs, "pallas")
    for key in METRIC_KEYS[:17]:
        a, b = float(terr[key]), float(jerr[key])
        assert abs(a - b) <= 0.05 * abs(b), (key, a, b)


def test_in_solve_crops_match_jax(inputs):
    """heatmap_crop=8 on the per-chunk path: crops cut on the device
    before windowing, the gather sampling of the crops, 2+1 iterations."""
    (_, *jf), (_, *tf), _ = _run_both(inputs, "gather", max_iter=2,
                                      global_max_iter=1, heatmap_crop=8,
                                      heatmap_crop_min_mass=0.0)
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("guard_crop", [0, 16])
def test_guard_on_raw_maps_matches_jax(inputs, guard_crop):
    """The per-chunk guard: the same coverage on clean and degraded maps,
    and the same effective configuration (a trip with guard_crop=0 falls
    back to the full maps, with the robust tier).  The JAX package sums
    each map's 4096 clipped values on the device in float32, the port in
    numpy's pairwise float32 sums (the staging pass's statistic): the
    means differ at ~5e-5 relative, hence rtol 1e-4."""
    v, sd, _ = inputs
    jc = chunk_config(jcfg, heatmap_crop=8, guard_crop=guard_crop)
    tc = chunk_config(tcfg, heatmap_crop=8, guard_crop=guard_crop)
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), v, v, jc)
    topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                     device="cpu")
    for c, tripped in ((chunks(26, seeds=(1,))[0], False),
                       (synthetic_chunk_v2(26, seed=5), True)):
        heat = np.asarray(c.heatmaps)
        tcov, jcov = topt._crop_coverage(heat), jopt._crop_coverage(heat)
        np.testing.assert_allclose(tcov, jcov, rtol=1e-4)
        assert (tcov < 0.9) == tripped
        teff, jeff = topt._effective_cfg(heat), jopt._effective_cfg(heat)
        assert (teff.heatmap_crop, teff.crop_center) == (
            jeff.heatmap_crop, jeff.crop_center)
        assert teff.solver.max_iter == jeff.solver.max_iter
        if tripped:
            assert teff.heatmap_crop == guard_crop


def test_pallas_direction_on_the_cpu_is_the_two_loop(inputs):
    """SolverConfig.pallas_direction reaches the direction wrapper, whose
    plain version on the CPU is the two-loop recursion itself."""
    v, sd, c = inputs
    out = []
    for flag in (False, True):
        tc = chunk_config(tcfg, max_iter=2, global_max_iter=1)
        tc = replace(tc, solver=replace(tc.solver, pallas_direction=flag))
        topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                         device="cpu")
        out.append(topt.run(port_chunk(c), with_metrics=False)[3])
    np.testing.assert_array_equal(out[0], out[1])
