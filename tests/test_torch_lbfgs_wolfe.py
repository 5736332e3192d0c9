"""The port's strong-Wolfe `lbfgs_minimize` and `adam_minimize` against
`jax.vmap` of the JAX package's, lane by lane, and the per-chunk path at
solver.method 'lbfgs' and 'adam' against the JAX `run`.

The lane-level problems are the seeded quadratics of
tests/test_torch_lbfgs.py plus 0.01 sum(x^4).  On an exact quadratic the
cubic interpolant of a zoom step whose first point lies beyond its second
has a denominator g2 - g1 + 2 d2 that is 0 in exact arithmetic, so the
trial step there is decided by rounding: JAX's own vmapped and unvmapped
solves give different iterates from the third iteration on (lane 3:
f -1.749 against -8.061).  The quartic term keeps the interpolant
regular; the pure quadratics are held at the iterations before any such
zoom (1 and 2)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from globalegomocap_tpu.evaluation.metrics import METRIC_KEYS
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu.optimize import lbfgs as jl
from globalegomocap_tpu_torch.optimize import driver as tdriver
from globalegomocap_tpu_torch.optimize import lbfgs as tl
from tests.test_torch_chunk import chunk_config
from tests.test_torch_lbfgs import B, D, _problem
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_chunk, port_state, tcfg)

QUARTIC = 0.01


def _jax_loss(a, rhs, quartic, radius=None):
    def loss(x, a_, r_):
        v = 0.5 * x @ a_ @ x - r_ @ x + quartic * jnp.sum(x ** 4)
        if radius is not None:
            v = jnp.where(jnp.sum(x * x) < radius ** 2, v, jnp.inf)
        return v
    return loss


def _torch_loss(a, rhs, quartic, radius=None, seen=None):
    a, rhs = torch.from_numpy(a), torch.from_numpy(rhs)

    def loss(x):
        v = (0.5 * torch.einsum("...bi,bij,...bj->...b", x, a, x)
             - torch.einsum("bi,...bi->...b", rhs, x)
             + quartic * (x ** 4).sum(-1))
        if radius is not None:
            v = torch.where((x * x).sum(-1) < radius ** 2, v,
                            torch.full_like(v, float("inf")))
            seen.append(int((~torch.isfinite(v)).sum()))
        return v
    return loss


def _jax_solve(a, rhs, x0, quartic, radius=None, **kw):
    loss = _jax_loss(a, rhs, quartic, radius)
    return jax.jit(jax.vmap(lambda x, a_, r_: jl.lbfgs_minimize(
        lambda z: loss(z, a_, r_), x, **kw)))(
        jnp.asarray(x0), jnp.asarray(a), jnp.asarray(rhs))


def _assert_lanes_match(rt, rj, rtol=1e-5, atol=1e-5):
    """Per lane: x, f, n_iter, n_evals (the iterates are O(1) and pass
    near zero, hence the atol, as in tests/test_torch_lbfgs.py)."""
    np.testing.assert_array_equal(rt.n_iter.numpy(), np.asarray(rj.n_iter))
    np.testing.assert_array_equal(rt.n_evals.numpy(),
                                  np.asarray(rj.n_evals))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("quartic,iters", [(QUARTIC, 1), (QUARTIC, 2),
                                           (QUARTIC, 3), (0.0, 1),
                                           (0.0, 2)])
def test_lbfgs_matches_jax_per_lane(quartic, iters):
    a, rhs, x0 = _problem()
    rj = _jax_solve(a, rhs, x0, quartic, max_iter=iters)
    rt = tl.lbfgs_minimize(_torch_loss(a, rhs, quartic),
                           torch.from_numpy(x0), max_iter=iters)
    _assert_lanes_match(rt, rj)
    # one batched call for the initial point, one per line-search step
    # and one final evaluation per iteration: at least the most
    # evaluations any lane made
    assert rt.n_calls >= int(rt.n_evals.max())


def test_lanes_stop_at_different_iterations():
    """Lane 0 starts at its minimum (g = 0 exactly) and stops on
    tolerance_grad before the first iteration; lanes 1 and 2 are
    well-conditioned and stop on tolerance_change within a few iterations;
    lanes 3-5 run to max_iter.  A lane that has stopped keeps its state
    while the others go on.  tolerance_change is 0.02 so that lanes 1 and
    2 stop before their line searches compare values within float32
    rounding of each other (at 1e-4 they do, and the packages stop lane 2
    one iteration apart)."""
    a, rhs, x0 = _problem(seed=15)
    a[:3] = np.eye(D, dtype=np.float32)
    rhs[0], x0[0] = 0.0, 0.0
    kw = dict(max_iter=6, tolerance_change=0.02)
    rj = _jax_solve(a, rhs, x0, QUARTIC, **kw)
    rt = tl.lbfgs_minimize(_torch_loss(a, rhs, QUARTIC),
                           torch.from_numpy(x0), **kw)
    _assert_lanes_match(rt, rj)
    n_iter = rt.n_iter.numpy()
    assert n_iter[0] == 0 and rt.n_evals[0] == 1
    np.testing.assert_array_equal(rt.x.numpy()[0], 0.0)
    assert 0 < n_iter[1] < 6 and 0 < n_iter[2] < 6
    assert (n_iter[3:] == 6).all()


def test_non_finite_values_bracket_the_search():
    """An objective that is inf beyond a radius, with lr = 20, so that the
    first trial steps overshoot: a non-finite value counts as an Armijo
    failure and the search brackets and zooms back inside (every x0 lies
    inside the radius)."""
    a, rhs, x0 = _problem(seed=5)
    radius = 4.0
    assert (np.sqrt((x0 * x0).sum(-1)) < radius).all()
    kw = dict(max_iter=3, lr=20.0)
    rj = _jax_solve(a, rhs, x0, QUARTIC, radius, **kw)
    seen = []
    rt = tl.lbfgs_minimize(_torch_loss(a, rhs, QUARTIC, radius, seen),
                           torch.from_numpy(x0), **kw)
    assert sum(seen) > 0
    assert bool(torch.isfinite(rt.f).all())
    _assert_lanes_match(rt, rj)


def test_both_reach_the_minimum():
    """A well-conditioned quadratic 0.5 (x - c)' A (x - c), run to
    convergence: both packages end at its minimiser c.  (Written around c
    so that f goes to 0 and float32 resolves its decrease to the end; in
    the form 0.5 x'Ax - b'x the values near the minimum round at 1e-6 of
    |f|, where the line search stalls 1e-3 from c.)"""
    rng = np.random.default_rng(2)
    m = rng.normal(size=(B, D, D)) / np.sqrt(D)
    a = (np.eye(D) + 0.1 * (m + m.transpose(0, 2, 1))).astype(np.float32)
    c = rng.normal(size=(B, D)).astype(np.float32)
    x0 = rng.normal(size=(B, D)).astype(np.float32)
    kw = dict(max_iter=60, tolerance_change=1e-12, tolerance_grad=1e-6)

    def jloss(x, a_, c_):
        return 0.5 * (x - c_) @ a_ @ (x - c_)
    rj = jax.jit(jax.vmap(lambda x, a_, c_: jl.lbfgs_minimize(
        lambda z: jloss(z, a_, c_), x, **kw)))(
        jnp.asarray(x0), jnp.asarray(a), jnp.asarray(c))
    ta, tc = torch.from_numpy(a), torch.from_numpy(c)
    rt = tl.lbfgs_minimize(
        lambda x: 0.5 * torch.einsum("...bi,bij,...bj->...b", x - tc, ta,
                                     x - tc),
        torch.from_numpy(x0), **kw)
    np.testing.assert_allclose(rt.x.numpy(), c, atol=1e-4)
    np.testing.assert_allclose(np.asarray(rj.x), c, atol=1e-4)
    assert (rt.n_iter.numpy() < 60).all()


def test_cubic_minimizer_degenerate_cases():
    """Coincident points, a negative discriminant and a non-finite value
    fall back to the midpoint of [lo, hi]; a regular interpolant (the
    cubic t^3 - 3t with its minimum at 1) is clipped to [lo, hi]."""
    inf = np.float32(np.inf)
    rows = np.array([
        # x1, f1, g1, x2, f2, g2, lo, hi
        [1.0, 2.0, -1.0, 1.0, 2.0, -1.0, 0.0, 4.0],    # coincident
        [0.0, 0.0, 2.0, 1.0, 4 / 3, 2.0, 0.2, 0.8],    # d1^2 < g1 g2
        [0.0, 0.0, -1.0, 2.0, inf, 1.0, 0.2, 1.8],     # non-finite f2
        [0.0, 0.0, -3.0, 2.0, 2.0, 9.0, 0.1, 1.9],     # regular: 1
        [0.0, 0.0, -3.0, 2.0, 2.0, 9.0, 1.5, 1.9],     # clipped to lo
    ], np.float32)
    want = np.array([2.0, 0.5, 1.0, 1.0, 1.5], np.float32)
    got_j = np.asarray(jax.vmap(jl._cubic_minimizer)(
        *(jnp.asarray(c) for c in rows.T)))
    got_t = tl._cubic_minimizer(*(torch.from_numpy(c.copy())
                                  for c in rows.T)).numpy()
    np.testing.assert_allclose(got_j, want, rtol=1e-6)
    np.testing.assert_allclose(got_t, got_j, rtol=1e-6)


def test_adam_matches_jax():
    """150 steps at lr 0.05, bias-corrected, steps + 1 evaluations."""
    a, rhs, x0 = _problem()
    loss = _jax_loss(a, rhs, QUARTIC)
    rj = jax.jit(jax.vmap(lambda x, a_, r_: jl.adam_minimize(
        lambda z: loss(z, a_, r_), x)))(
        jnp.asarray(x0), jnp.asarray(a), jnp.asarray(rhs))
    rt = tl.adam_minimize(_torch_loss(a, rhs, QUARTIC), torch.from_numpy(x0))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f), rtol=1e-5,
                               atol=1e-5)
    assert rt.n_evals == rt.n_calls == 151
    assert int(np.asarray(rj.n_evals)[0]) == 151


def test_bf16_state_stays_bf16():
    """A bf16 x0 keeps x in bf16 and the energies in float32, and the
    solve descends (JAX's lbfgs_minimize raises at a bf16 x0: its
    while-loop carry would change dtype, so there is no reference)."""
    a, rhs, x0 = _problem()
    loss32 = _torch_loss(a, rhs, QUARTIC)
    rt = tl.lbfgs_minimize(lambda x: loss32(x.to(torch.float32)),
                           torch.from_numpy(x0).to(torch.bfloat16),
                           max_iter=4)
    assert rt.x.dtype == torch.bfloat16 and rt.f.dtype == torch.float32
    f0 = loss32(torch.from_numpy(x0))
    assert bool((rt.f < f0).all()) and bool(torch.isfinite(rt.f).all())


# ---------------------------------------------------------------------------
# the per-chunk path at solver.method 'lbfgs' and 'adam'
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prior():
    v = jax_variables(jdriver.build_model(chunk_config(jcfg)), seed=0)
    return v, port_state(v), chunks(26, seeds=(1,))[0]


def _run_both(prior, method, max_iter, global_max_iter, **solver):
    """SequenceOptimizer.run of both packages at the parity CLI's
    configuration with solver.method = `method`; the port samples with
    `pallas` (its plain version on the CPU), JAX with `dense` (the same
    function, outside interpret mode)."""
    v, sd, c = prior
    out = []
    for pkg, drv, sampling in ((jcfg, jdriver, "dense"),
                               (tcfg, tdriver, "pallas")):
        cfg = chunk_config(pkg, sampling, max_iter=max_iter,
                           global_max_iter=global_max_iter)
        cfg = replace(cfg, solver=replace(cfg.solver, method=method,
                                          **solver))
        kw = {} if pkg is jcfg else {"device": "cpu"}
        w = v if pkg is jcfg else sd
        opt = drv.SequenceOptimizer(drv.build_model(cfg), w, w, cfg, **kw)
        out.append(opt.run(c if pkg is jcfg else port_chunk(c)))
    return out


@pytest.mark.parametrize("method,iters,solver", [
    ("lbfgs", (2, 1), {}), ("adam", (1, 1), {"adam_steps": 4})])
def test_run_matches_jax_field_by_field(prior, method, iters, solver):
    """Strong-Wolfe L-BFGS at 2 + 1 iterations and Adam at 4 steps a
    stage: every returned field at the per-chunk path's tolerance
    (tests/test_torch_chunk.py)."""
    (_, *jf), (_, *tf) = _run_both(prior, method, *iters, **solver)
    for name, a, b in zip(("estimated", "mid_local", "optimized", "gt"),
                          tf, jf):
        assert a.shape == np.asarray(b).shape == (26, 15, 3), name
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=2e-4,
                                   err_msg=name)


def test_run_metrics_match_jax_at_the_cli_defaults(prior):
    """25 + 25 iterations, history 25: trajectories branch on rounding
    after many iterations (ROADMAP section C), so the 17 metrics within
    5 %."""
    (jerr, *_), (terr, *_) = _run_both(prior, "lbfgs", 25, None)
    for key in METRIC_KEYS[:17]:
        a, b = float(terr[key]), float(jerr[key])
        assert abs(a - b) <= 0.05 * abs(b), (key, a, b)
