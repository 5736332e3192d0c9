"""Host staging of the port against the JAX package's
`SequenceOptimizer.stage(on_host=True)`: the staged crops (after the bf16
cast) and their origins are bit-exact, the crop-mass guard's coverage
agrees (rtol 1e-6), and a tripped guard re-crops at k=16 around the
projected estimate identically."""

import numpy as np
import pytest
import jax
import torch

from globalegomocap_tpu.data.synthetic import synthetic_chunk, \
    synthetic_chunk_v2
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.optimize import driver as tdriver
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_chunk, port_state, slice_config,
    tcfg)


@pytest.fixture(scope="module")
def optimizers():
    out = {}
    for dtype in ("bfloat16", "float32"):
        jc = slice_config(jcfg, heatmap_dtype=dtype)
        tc = slice_config(tcfg, heatmap_dtype=dtype)
        jm = jdriver.build_model(jc)
        v = jax_variables(jm, seed=0)
        sd = port_state(v)
        out[dtype] = (jdriver.SequenceOptimizer(jm, v, v, jc),
                      tdriver.SequenceOptimizer(tdriver.build_model(tc), sd,
                                                sd, tc, device="cpu"))
    return out


def _f32(x):
    """Staged heat as float32 numpy (bf16 upcasts exactly)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jax.numpy.asarray(x).astype(jax.numpy.float32))


def _stage_both(optimizers, dtype, cs, coverage=None):
    jopt, topt = optimizers[dtype]
    js = jopt.stage(cs, coverage=coverage, on_host=True)
    ts = topt.stage([port_chunk(c) for c in cs], coverage=coverage,
                    on_host=True)
    return js, ts


def _assert_same_staging(js, ts, n_chunks):
    assert ts.n_chunks == n_chunks
    c = n_chunks                      # the JAX side pads to its device count
    np.testing.assert_array_equal(_f32(ts.heat), _f32(js.heat)[:c])
    np.testing.assert_array_equal(ts.origins.numpy(),
                                  np.asarray(js.origins)[:c])
    assert ts.full_hw == tuple(js.full_hw)
    for name in ("est", "cams", "gt"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name))[:c])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_peak_staging_bit_exact(optimizers, dtype):
    cs = chunks()
    js, ts = _stage_both(optimizers, dtype, cs)
    assert ts.heat.dtype == (torch.bfloat16 if dtype == "bfloat16"
                             else torch.float32)
    assert ts.heat.shape == (2, 26, 8 * 8 * 15)
    _assert_same_staging(js, ts, len(cs))
    np.testing.assert_allclose(ts.crop_coverage, js.crop_coverage,
                               rtol=1e-6)
    assert ts.crop_coverage >= 0.9         # clean maps keep the fast tier


def test_guard_trip_recrop_bit_exact(optimizers):
    """Injected coverage 0.1: k=16 crops centred at the projected
    estimate, and the robust solver tier."""
    cs = chunks()
    js, ts = _stage_both(optimizers, "bfloat16", cs, coverage=0.1)
    assert ts.heat.shape == (2, 26, 16 * 16 * 15)
    _assert_same_staging(js, ts, len(cs))
    jopt, topt = optimizers["bfloat16"]
    jeff, teff = jopt._cfg_for_coverage(0.1), topt._cfg_for_coverage(0.1)
    assert (teff.heatmap_crop, teff.crop_center) == (16, "estimate")
    assert (teff.heatmap_crop, teff.crop_center) == (jeff.heatmap_crop,
                                                     jeff.crop_center)
    for f in ("max_iter", "history_size", "step_candidates",
              "global_max_iter"):
        assert getattr(teff.solver, f) == getattr(jeff.solver, f), f
    assert (teff.solver.max_iter, teff.solver.history_size) == (15, 10)


def test_degraded_maps_trip_the_guard(optimizers):
    """Maps with a background floor and distractors lower the measured
    coverage below 0.90: both packages trip and re-crop the same way."""
    cs = [synthetic_chunk_v2(26, seed=5), synthetic_chunk(26, seed=6)]
    js, ts = _stage_both(optimizers, "bfloat16", cs)
    np.testing.assert_allclose(ts.crop_coverage, js.crop_coverage,
                               rtol=1e-6)
    assert ts.crop_coverage < 0.9
    assert ts.heat.shape[-1] == 16 * 16 * 15
    _assert_same_staging(js, ts, len(cs))
