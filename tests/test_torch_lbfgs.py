"""The port's batched fixed-iteration L-BFGS against the JAX solver on a
seeded batch of quadratics: the same iterates after every iteration count
(rtol 1e-5), and the same two-loop direction.  The quadratics are sized
(d=32, condition ~10) so that 12 iterations stay far from the minimum:
there the line-search choices sit in float32 rounding noise and may
branch between any two implementations."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.optimize import lbfgs as jl
from globalegomocap_tpu_torch.optimize import lbfgs as tl

B, D = 6, 32


def _problem(seed=4):
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(B):
        m = rng.normal(size=(D, D))
        mats.append(m @ m.T / D + 0.5 * np.eye(D))
    a = np.stack(mats).astype(np.float32)
    rhs = rng.normal(size=(B, D)).astype(np.float32)
    x0 = rng.normal(scale=0.5, size=(B, D)).astype(np.float32)
    return a, rhs, x0


def _jax_vg(a, rhs):
    a, rhs = jnp.asarray(a), jnp.asarray(rhs)

    def vg(x3):
        def f(x3_):
            return (0.5 * jnp.einsum("rbi,bij,rbj->rb", x3_, a, x3_)
                    - jnp.einsum("bi,rbi->rb", rhs, x3_))
        vals, pull = jax.vjp(f, x3)
        (g,) = pull(jnp.ones_like(vals))
        return vals, g
    return vg


def _torch_vg(a, rhs):
    a, rhs = torch.from_numpy(a), torch.from_numpy(rhs)

    def vg(x3):
        with torch.enable_grad():
            x = x3.detach().requires_grad_(True)
            vals = (0.5 * torch.einsum("rbi,bij,rbj->rb", x, a, x)
                    - torch.einsum("bi,rbi->rb", rhs, x))
            (g,) = torch.autograd.grad(vals.sum(), x)
        return vals.detach(), g
    return vg


@pytest.mark.parametrize("history,cands", [(2, (1.0, 0.1)),
                                           (10, (1.0, 0.5, 0.1, 0.02))])
@pytest.mark.parametrize("iters", [1, 3, 6, 12])
def test_trajectory_matches_jax(history, cands, iters):
    a, rhs, x0 = _problem()
    kw = dict(max_iter=iters, history_size=history, lr=2.0,
              step_candidates=cands)
    rj = jl.lbfgs_minimize_fixed_batched(_jax_vg(a, rhs), jnp.asarray(x0),
                                         unroll=1, **kw)
    rt = tl.lbfgs_minimize_fixed_batched(_torch_vg(a, rhs),
                                         torch.from_numpy(x0), **kw)
    # the iterates are O(1) and each step takes 32-term dot products,
    # which round at ~4e-6: atol 1e-5 for entries that pass near zero
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rt.grad_norm.numpy(),
                               np.asarray(rj.grad_norm), rtol=1e-5,
                               atol=1e-5)
    assert rt.n_evals == int(rj.n_evals)


def test_two_loop_direction_matches_jax():
    """Partially filled histories (slot masking) and gamma from the newest
    valid pair."""
    rng = np.random.default_rng(7)
    m = 5
    g = rng.normal(size=(B, D)).astype(np.float32)
    s = rng.normal(size=(B, m, D)).astype(np.float32)
    y = (s + 0.1 * rng.normal(size=(B, m, D))).astype(np.float32)
    rho = (1.0 / np.einsum("bmd,bmd->bm", s, y)).astype(np.float32)
    valid = np.arange(m)[None, :] >= rng.integers(0, m + 1, size=(B, 1))
    dj = jax.vmap(jl._two_loop_direction)(
        jnp.asarray(g), jnp.asarray(s), jnp.asarray(y), jnp.asarray(rho),
        jnp.asarray(valid))
    dt = tl._two_loop_direction(
        torch.from_numpy(g), torch.from_numpy(s), torch.from_numpy(y),
        torch.from_numpy(rho), torch.from_numpy(valid))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-6)


def test_first_step_scale_and_no_improvement_gate():
    """Iteration 0 scales the step by min(1, 1/|g|_1); a row whose probes
    all increase the value does not move."""
    a, rhs, x0 = _problem(seed=9)
    x0[0] = np.linalg.solve(a[0].astype(np.float64),
                            rhs[0].astype(np.float64)).astype(np.float32)
    kw = dict(max_iter=1, history_size=2, lr=2.0, step_candidates=(1.0,))
    rt = tl.lbfgs_minimize_fixed_batched(_torch_vg(a, rhs),
                                         torch.from_numpy(x0), **kw)
    rj = jl.lbfgs_minimize_fixed_batched(_jax_vg(a, rhs), jnp.asarray(x0),
                                         **kw)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-5,
                               atol=1e-6)
    g0 = np.einsum("bij,bj->bi", a, x0) - rhs
    scale = np.minimum(1.0, 1.0 / np.abs(g0).sum(-1))
    moved = np.abs(rt.x.numpy() - x0).max(-1)
    assert np.all(moved[1:] > 0)
    np.testing.assert_allclose(
        rt.x.numpy()[1:], (x0 - 2.0 * scale[:, None] * g0)[1:], rtol=1e-5,
        atol=1e-6)
