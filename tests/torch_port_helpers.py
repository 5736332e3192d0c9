"""Shared fixtures of the tests/test_torch_*.py files: one configuration,
one set of prior weights and one set of chunks, built for both the JAX
package (the reference) and the PyTorch port.  Data crosses between the
two packages as numpy arrays."""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import torch

# One intra-op thread per test process.  The suite runs in several
# processes on one host (pytest-xdist), and each process's PyTorch would
# otherwise start a full-width OpenMP pool: the pools' spinning threads
# then wait on each other at every parallel region (mkldnn convolutions,
# BLAS), and a test that takes 20 s alone took 500 s in the suite.  Every
# test file is imported by every worker at collection, so this holds for
# the whole run.
torch.set_num_threads(1)

from globalegomocap_tpu import config as jcfg
from globalegomocap_tpu.data.synthetic import synthetic_chunk
from globalegomocap_tpu_torch import config as tcfg
from globalegomocap_tpu_torch.data.test_data import TestChunk
from globalegomocap_tpu_torch.models.convert import params_from_flax

# the tiny prior of tests/test_golden.py
TINY_PRIOR = dict(latent_dim=32, seq_len=10, hidden_dims=(8, 8, 16, 16, 32))


def slice_config(pkg, max_iter: int = 12, global_max_iter: int = 3,
                 prior: dict = TINY_PRIOR, **overrides):
    """The serve path's production stack at float32 compute, built from
    either package's config module (`pkg` is `jcfg` or `tcfg`)."""
    kw = dict(
        prior=pkg.PriorConfig(**prior),
        solver=pkg.SolverConfig(
            method="lbfgs_fixed", max_iter=max_iter, history_size=2,
            step_candidates=(1.0, 0.1), lr=2.0, fused_probes=True,
            fused_energy=True, global_max_iter=global_max_iter, unroll=1),
        energy=pkg.EnergyConfig(global_residual=True),
        sampling_impl="dense", heatmap_dtype="bfloat16", heatmap_crop=8,
        guard_crop=16, heatmap_crop_min_mass=0.90, robust_tier_on_guard=True,
        fold_bn=True, dense_decoder=True, decoder_impl="conv",
        matmul_merge=True, final_smooth=True, final_smooth_sigma=1.0,
        camera="egosyn")
    kw.update(overrides)
    return pkg.OptimizeConfig(**kw)


def jax_variables(model, seed: int):
    """Flax ConvVAE variables from `seed`, with BatchNorm running
    statistics drawn from numpy so that BN folding has work to do."""
    v = model.init(jax.random.PRNGKey(seed),
                   jnp.zeros((1, model.seq_len, model.in_channels)), False)
    rng = np.random.default_rng(seed)
    stats = {}
    for name in sorted(v["batch_stats"]):
        shape = np.shape(v["batch_stats"][name]["bn"]["mean"])
        stats[name] = {"bn": {
            "mean": jnp.asarray(rng.uniform(-0.1, 0.1, shape), jnp.float32),
            "var": jnp.asarray(rng.uniform(0.8, 1.2, shape), jnp.float32)}}
    return {"params": v["params"], "batch_stats": stats}


def port_state(variables) -> dict:
    """The same weights as the port's state dict."""
    return params_from_flax(jax.tree_util.tree_map(np.asarray, variables))


def port_chunk(chunk) -> TestChunk:
    """A JAX-package TestChunk as the port's (same numpy arrays)."""
    return TestChunk(*(np.asarray(x) for x in chunk))


def chunks(n_frames: int = 26, seeds=(1, 2)):
    """JAX-package synthetic chunks (the maps come from the JAX fisheye)."""
    return [synthetic_chunk(n_frames, seed=s) for s in seeds]


def hold(got, w32, w64, rtol, atol, name=""):
    """`got` against JAX's float32 result `w32` and its exact (float64)
    result `w64`: no further from w64 than w32 is (or than atol + rtol
    times the tensor's largest magnitude, where JAX's run is closer than
    that), and so within rtol of w32 plus twice the float32 error of
    JAX's own run.
    JAX's float32 train-mode runs carry the error of their batch
    statistics' float32 reductions (up to 1.4e-4 on a reconstruction
    here, where eval mode agrees with float64 to 3e-7)."""
    got, w32, w64 = (np.asarray(x, np.float64) for x in (got, w32, w64))
    jax_err = float(np.max(np.abs(w32 - w64)))
    port_err = float(np.max(np.abs(got - w64)))
    floor = atol + rtol * float(np.max(np.abs(w64)))
    assert port_err <= max(jax_err, floor), (name, port_err, jax_err)
    np.testing.assert_allclose(got, w32, rtol=rtol, atol=atol + 2 * jax_err,
                               err_msg=name)


def hold_init(got: dict, want: dict) -> None:
    """Two state dicts equal leaf for leaf within 1e-6 of each leaf's
    largest magnitude (Flax's init against the port's: the truncated
    normal's erf_inv rounds an ulp apart from XLA's in a few draws)."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.to(torch.float32)
        scale = float(w.abs().max()) or 1.0
        gap = float((got[k].to(torch.float32) - w).abs().max())
        assert gap <= 1e-6 * scale, (k, gap, scale)


__all__ = ["jcfg", "tcfg", "slice_config", "jax_variables", "port_state",
           "port_chunk", "chunks", "TINY_PRIOR", "hold", "hold_init"]
