"""The port's serve path as a whole against the JAX package: host staging
(`stage(on_host=True)`) and the flat batched two-stage solve
(`optimize_chunks_batched(mode="flat")`) on the same chunks and weights,
with the tiny prior, on the peak-crop path and on the guard-trip path
(coverage 0.1: k=16 crops centred at the projected estimate and the
robust solver tier)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.evaluation.metrics import (
    METRIC_KEYS, calculate_errors as j_errors)
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.evaluation.metrics import (
    calculate_errors as t_errors)
from globalegomocap_tpu_torch.optimize import driver as tdriver
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_chunk, port_state, slice_config,
    tcfg)

COVERAGES = [None, 0.1]
IDS = ["peak", "guard"]


@pytest.fixture(scope="module")
def inputs():
    jmodel = jdriver.build_model(slice_config(jcfg))
    v = jax_variables(jmodel, seed=0)
    return v, port_state(v), chunks()


def _solve_both(inputs, coverage, **knobs):
    v, sd, cs = inputs
    jc, tc = slice_config(jcfg, **knobs), slice_config(tcfg, **knobs)
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), v, v, jc)
    jres = jopt.optimize_chunks_batched(
        jopt.stage(cs, coverage=coverage, on_host=True), mode="flat")
    topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                     device="cpu")
    tstaged = topt.stage([port_chunk(c) for c in cs], coverage=coverage,
                         on_host=True)
    tres = topt.optimize_chunks_batched(tstaged, mode="flat")
    jres = jax.tree_util.tree_map(np.asarray, jres)
    return jres, tres, tstaged


@pytest.mark.parametrize("coverage", COVERAGES, ids=IDS)
def test_chunk_result_matches_jax(inputs, coverage):
    """Two stage-1 and one stage-2 iterations: every ChunkResult field
    agrees at the batched-solver tolerance of test_fused_energy.py:261.
    The guard path keeps its k=16 estimate-centred crops but not the
    robust tier here, which would lift stage 1 to 15 iterations: with a
    random prior, float32 reassociation grows along the trajectory
    (max |diff| 3e-6 at 3 iterations, 7e-4 at 10, 4e-2 at 15) until an
    Armijo choice branches.  The metric test below runs the tier."""
    jres, tres, staged = _solve_both(inputs, coverage, max_iter=2,
                                     global_max_iter=1,
                                     robust_tier_on_guard=False)
    assert staged.heat.shape[-1] == (8 if coverage is None else 16) ** 2 * 15
    for name in jres._fields:
        a, b = getattr(tres, name), getattr(jres, name)
        assert tuple(a.shape) == b.shape, name
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("coverage", COVERAGES, ids=IDS)
def test_metrics_match_jax_at_slice_knobs(inputs, coverage):
    """The slice's own iteration counts (12 and 3): Armijo choices may
    branch after many iterations, so the check is the 17 metrics within
    5 % relative (the precedent of test_fused_energy.py:297-308)."""
    jres, tres, _ = _solve_both(inputs, coverage)
    terr = t_errors(tres.estimated, tres.mid, tres.optimized, tres.gt)
    for c in range(jres.optimized.shape[0]):
        jerr = j_errors(*(jnp.asarray(x[c]) for x in (
            jres.estimated, jres.mid, jres.optimized, jres.gt)))
        for key in METRIC_KEYS[:17]:
            a, b = float(terr[key][c]), float(jerr[key])
            assert abs(a - b) <= 0.05 * abs(b), (c, key, a, b)
