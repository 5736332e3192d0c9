"""The port's L-BFGS direction (`ops/lbfgs_direction.py`, plain version on
the CPU) against the JAX package's `lbfgs_direction_pallas` (under
`vmap`) and `lbfgs_direction_pallas_batched`, both in interpret mode,
with the tolerances of tests/test_lbfgs_fixed.py:195-287 (rtol 1e-4,
atol 1e-5); and the port's per-lane `lbfgs_minimize_fixed` against the
JAX solver under `vmap`, with fused probes and the direction kernel each
on and off."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.ops.pallas.lbfgs_direction import (
    lbfgs_direction_pallas, lbfgs_direction_pallas_batched)
from globalegomocap_tpu.optimize import lbfgs as jl
from globalegomocap_tpu_torch.ops import cuda_build
from globalegomocap_tpu_torch.ops.lbfgs_direction import (
    lbfgs_direction, two_loop_direction)
from globalegomocap_tpu_torch.optimize import lbfgs as tl

D = 32


def _history(b, m, seed):
    """Partly filled histories: lane i holds its newest n_i pairs (n_i
    from 0 to m), curvature pairs with s.y > 0, one lane whose newest
    pair has y.y = 0 (gamma falls back to 1)."""
    rng = np.random.default_rng(seed)
    s = np.zeros((b, m, D), np.float32)
    y = np.zeros((b, m, D), np.float32)
    valid = np.zeros((b, m), bool)
    fill = rng.integers(0, m + 1, size=b)
    fill[0], fill[-1] = m, 0
    for i in range(b):
        for k in range(m - fill[i], m):
            si = rng.normal(size=D).astype(np.float32)
            yi = (si * rng.uniform(0.5, 2.0)
                  + 0.1 * rng.normal(size=D)).astype(np.float32)
            s[i, k], y[i, k], valid[i, k] = si, yi, True
    rho = np.where(valid, 1.0 / np.maximum(np.sum(s * y, -1), 1e-12),
                   0.0).astype(np.float32)
    if b > 2 and fill[1] > 0:
        y[1, m - 1] = 0.0                      # y.y = 0 in the newest slot
    g = rng.normal(size=(b, D)).astype(np.float32)
    return g, s, y, rho, valid


@pytest.mark.parametrize("m", [1, 2, 10, 25])
@pytest.mark.parametrize("b", [5, 13])
def test_direction_matches_pallas_kernels(m, b):
    args = _history(b, m, seed=m * 100 + b)
    jargs = tuple(jnp.asarray(a) for a in args)
    t = two_loop_direction(*(torch.from_numpy(a) for a in args)).numpy()
    via_vmap = np.asarray(jax.vmap(lbfgs_direction_pallas)(*jargs))
    batched = np.asarray(lbfgs_direction_pallas_batched(*jargs))
    np.testing.assert_allclose(t, via_vmap, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t, batched, rtol=1e-4, atol=1e-5)
    assert np.isfinite(t).all()


def test_wrapper_on_cpu_is_the_plain_version():
    args = tuple(torch.from_numpy(a) for a in _history(7, 10, seed=1))
    cuda_build.reset_launches()
    np.testing.assert_array_equal(lbfgs_direction(*args).numpy(),
                                  two_loop_direction(*args).numpy())
    assert cuda_build.LAUNCHES["lbfgs_direction"] == 0
    bad = list(args)
    bad[4] = args[4].to(torch.uint8)
    with pytest.raises(TypeError, match="valid"):
        lbfgs_direction(*bad)
    bad = list(args)
    bad[2] = args[2][:, :5].contiguous()
    with pytest.raises(ValueError, match="y_hist"):
        lbfgs_direction(*bad)


B = 6


def _problem(seed=4):
    """Per-lane objectives 0.5 x'Ax - b'x + 0.1 sum(tanh(x)^2)."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(B):
        m = rng.normal(size=(D, D))
        mats.append(m @ m.T / D + 0.5 * np.eye(D))
    a = np.stack(mats).astype(np.float32)
    rhs = rng.normal(size=(B, D)).astype(np.float32)
    x0 = rng.normal(scale=0.5, size=(B, D)).astype(np.float32)
    return a, rhs, x0


@pytest.mark.parametrize("fused_probes", [False, True])
@pytest.mark.parametrize("pallas_direction", [False, True])
def test_minimize_fixed_matches_jax_under_vmap(fused_probes,
                                               pallas_direction):
    a, rhs, x0 = _problem()
    kw = dict(max_iter=6, history_size=4, lr=2.0,
              step_candidates=(1.0, 0.5, 0.1, 0.02),
              fused_probes=fused_probes, pallas_direction=pallas_direction)

    def jsolve(x, am, bm):
        def loss(v):
            return (0.5 * v @ am @ v - bm @ v
                    + 0.1 * jnp.sum(jnp.tanh(v) ** 2))
        r = jl.lbfgs_minimize_fixed(loss, x, **kw)
        return r.x, r.f
    jx, jf = jax.vmap(jsolve)(jnp.asarray(x0), jnp.asarray(a),
                              jnp.asarray(rhs))

    ta, tb = torch.from_numpy(a), torch.from_numpy(rhs)

    def tloss(v):                                        # (..., B, D)
        return (0.5 * torch.einsum("...bi,bij,...bj->...b", v, ta, v)
                - torch.einsum("bi,...bi->...b", tb, v)
                + 0.1 * torch.tanh(v).square().sum(-1))
    res = tl.lbfgs_minimize_fixed(tloss, torch.from_numpy(x0), **kw)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res.f.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5)
    k = len(kw["step_candidates"])
    assert res.n_evals == (6 * k + 1 if fused_probes else 6 * (k + 1) + 1)


def test_fused_probes_off_calls_the_loss_as_the_jax_solver_does():
    """fused_probes=False: per iteration one value-only probe call of all
    K candidates (no graph) and one value-and-grad at the new point."""
    a, rhs, x0 = _problem(seed=2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(rhs)
    calls = []

    def tloss(v):
        calls.append((tuple(v.shape), torch.is_grad_enabled()))
        return (0.5 * torch.einsum("...bi,bij,...bj->...b", v, ta, v)
                - torch.einsum("bi,...bi->...b", tb, v))
    tl.lbfgs_minimize_fixed(tloss, torch.from_numpy(x0), max_iter=2,
                            history_size=2, step_candidates=(1.0, 0.1))
    assert calls == [((1, B, D), True), ((2, B, D), False),
                     ((1, B, D), True), ((2, B, D), False),
                     ((1, B, D), True)]


@pytest.mark.parametrize("option", ["circular_history",
                                    "compact_direction"])
def test_later_slice_options_raise(option):
    a, rhs, x0 = _problem()
    with pytest.raises(NotImplementedError, match=option):
        tl.lbfgs_minimize_fixed(lambda v: v.square().sum(-1),
                                torch.from_numpy(x0), **{option: True})
