"""The port's L-BFGS direction (`ops/lbfgs_direction.py`, plain version on
the CPU) against the JAX package's `lbfgs_direction_pallas` (under
`vmap`) and `lbfgs_direction_pallas_batched`, both in interpret mode,
in float32 with the tolerances of tests/test_lbfgs_fixed.py:195-287
(rtol 1e-4, atol 1e-5) and in bf16; the port's per-lane
`lbfgs_minimize_fixed` against the JAX solver under `vmap`, with fused
probes and the direction kernel each on and off, and on a bf16 state.
The kernel's launch plan is the kernel source's and is checked on the
card (tests/test_torch_gpu.py)."""

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
    lbfgs_direction, pad_last, pad_width, two_loop_direction)
from globalegomocap_tpu_torch.optimize import lbfgs as tl

D = 32


def _history(b, m, seed, d=D):
    """Partly filled histories: lane i holds its newest n_i pairs (n_i
    from 0 to m), curvature pairs with s.y > 0, one lane whose newest
    pair has y.y = 0 (gamma falls back to 1)."""
    rng = np.random.default_rng(seed)
    s = np.zeros((b, m, d), np.float32)
    y = np.zeros((b, m, d), np.float32)
    valid = np.zeros((b, m), bool)
    fill = rng.integers(0, m + 1, size=b)
    fill[0], fill[-1] = m, 0
    for i in range(b):
        for k in range(m - fill[i], m):
            si = rng.normal(size=d).astype(np.float32)
            yi = (si * rng.uniform(0.5, 2.0)
                  + 0.1 * rng.normal(size=d)).astype(np.float32)
            s[i, k], y[i, k], valid[i, k] = si, yi, True
    rho = np.where(valid, 1.0 / np.maximum(np.sum(s * y, -1), 1e-12),
                   0.0).astype(np.float32)
    if b > 2 and fill[1] > 0:
        y[1, m - 1] = 0.0                      # y.y = 0 in the newest slot
    g = rng.normal(size=(b, d)).astype(np.float32)
    return g, s, y, rho, valid


# (b, m, dtype): float32 at every m and b; bf16 at b = 13 with the
# shortest and the per-chunk path's history only, since the JAX kernel's
# bf16 interpret mode is slow (about 5 s for the two cases on a CPU)
CASES = ([(b, m, "float32") for m in (1, 2, 10, 25) for b in (5, 13)]
         + [(13, m, "bfloat16") for m in (2, 25)])


@pytest.mark.parametrize("b,m,dtype", CASES,
                         ids=[f"{b}-{m}-{t}" for b, m, t in CASES])
def test_direction_matches_pallas_kernels(m, b, dtype):
    """float32: the JAX tolerances above.  bfloat16: grad, s, y and rho in
    bf16 on both sides, as the solver's bf16 state hands them over; the
    JAX kernel sums bf16 products with bf16 reductions, the port exact
    products in float32 (`jnp.dot`'s semantics), and both round every
    other step to bf16's 8 significand bits, so max|d_bf16 - d_jax| <=
    2e-2 max|d_f32| (7.8e-3 measured over m in {2, 10, 25} and b in
    {5, 13} on these inputs)."""
    args = _history(b, m, seed=m * 100 + b)
    if dtype == "float32":
        jargs = tuple(jnp.asarray(a) for a in args)
        t = two_loop_direction(*(torch.from_numpy(a) for a in args)).numpy()
        via_vmap = np.asarray(jax.vmap(lbfgs_direction_pallas)(*jargs))
        batched = np.asarray(lbfgs_direction_pallas_batched(*jargs))
        np.testing.assert_allclose(t, via_vmap, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t, batched, rtol=1e-4, atol=1e-5)
        assert np.isfinite(t).all()
        return
    scale = np.abs(two_loop_direction(
        *(torch.from_numpy(a) for a in args)).numpy()).max()
    jargs = tuple(jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
                  else jnp.asarray(a) for a in args)
    targs = tuple(torch.from_numpy(a).to(torch.bfloat16)
                  if a.dtype == np.float32 else torch.from_numpy(a)
                  for a in args)
    out = lbfgs_direction(*targs)
    assert out.dtype == torch.bfloat16
    t = out.to(torch.float32).numpy()
    for ref in (jax.vmap(lbfgs_direction_pallas)(*jargs),
                lbfgs_direction_pallas_batched(*jargs)):
        assert ref.dtype == jnp.bfloat16
        err = np.abs(t - np.asarray(ref, np.float32)).max()
        assert err <= 2e-2 * scale, (err, scale)
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


@pytest.mark.parametrize("granule", [1, 16])
@pytest.mark.parametrize("d", [2050, 36])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_padding_of_d_is_exact(dtype, d, granule):
    """The wrapper zero-pads a d the kernel's 16-byte slices do not hold
    (`pad_width`, `pad_last`) and slices the direction back: the plain
    version on the padded inputs, sliced back, is the plain version on
    the originals.  float32 to 1e-6 of each element and of its lane's
    largest element (a longer sum may reassociate, so an element that
    cancels to near zero moves by a float32 ulp of the lane's scale:
    9e-8 against |d| up to 6 measured), bf16 to one ulp of its 8
    significand bits."""
    args = tuple(torch.from_numpy(a) for a in _history(6, 10, seed=d, d=d))
    args = tuple(x.to(dtype) if x.is_floating_point() else x for x in args)
    elem = args[0].element_size()
    width = pad_width(d, elem, granule)
    assert width >= d and width * elem % (16 * granule) == 0
    g, s, y = pad_last(args[:3], width)
    assert (g[:, d:] == 0).all() and (s[..., :d] == args[1]).all()
    out = two_loop_direction(g, s, y, *args[3:])
    assert (out[:, d:] == 0).all()
    ref = two_loop_direction(*args).to(torch.float64)
    got = out[:, :d].to(torch.float64)
    if dtype == torch.float32:
        scale = ref.abs().amax(-1, keepdim=True)
        assert ((got - ref).abs() <= 1e-6 * (ref.abs() + scale)).all()
    else:
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(
            1e-30))) - 7)
        assert ((got - ref).abs() <= ulp).all()


def test_wrapper_takes_one_float_dtype():
    """float32 or bfloat16 for grad, s, y and rho, all four alike; the
    direction comes back in that dtype."""
    args = tuple(torch.from_numpy(a) for a in _history(7, 10, seed=2))
    bf = tuple(x.to(torch.bfloat16) if x.is_floating_point() else x
               for x in args)
    out = lbfgs_direction(*bf)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.to(torch.float32).numpy(),
                                  two_loop_direction(*bf).float().numpy())
    # grad sets the dtype; the first argument that differs is named
    for i, name in ((0, "s_hist"), (1, "s_hist"), (2, "y_hist"),
                    (3, "rho_hist")):
        mixed = list(bf)
        mixed[i] = args[i]
        with pytest.raises(TypeError, match=name):
            lbfgs_direction(*mixed)
    with pytest.raises(TypeError, match="grad"):
        lbfgs_direction(*(x.half() if x.is_floating_point() else x
                          for x in args))


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


def test_minimize_fixed_bf16_state_matches_jax_under_vmap():
    """A bf16 x0 keeps the solver state, and the direction kernel's
    inputs, in bf16 on both sides.  bf16 rounds at other places in the
    two frameworks (the JAX kernel's bf16 reductions, `jnp.dot` against
    the port's float32 sums), and the line search branches on that
    rounding in the first iterations, so the two are held where they
    end: on well-conditioned quadratics both reach the minimiser within
    bf16's resolution after 8 iterations (|dx| <= 5.2e-3 (1 + |x|) and
    |df| <= 1.6e-4 measured over three seeds), held at 2e-2 (1 + |x|) and
    1e-3 (1 + |f|)."""
    rng = np.random.default_rng(7)
    sym = rng.normal(size=(B, D, D))
    a = (np.eye(D) + 0.05 * (sym + sym.transpose(0, 2, 1))
         / np.sqrt(D)).astype(np.float32)
    rhs = rng.normal(size=(B, D)).astype(np.float32)
    x0 = rng.normal(scale=0.5, size=(B, D)).astype(np.float32)
    kw = dict(max_iter=8, history_size=4, lr=2.0,
              step_candidates=(1.0, 0.5, 0.1, 0.02), pallas_direction=True)

    def jsolve(x, am, bm):
        def loss(v):
            v = v.astype(jnp.float32)
            return 0.5 * v @ am @ v - bm @ v
        r = jl.lbfgs_minimize_fixed(loss, x, **kw)
        return r.x, r.f
    jx, jf = jax.vmap(jsolve)(jnp.asarray(x0, jnp.bfloat16), jnp.asarray(a),
                              jnp.asarray(rhs))
    ta, tb = torch.from_numpy(a), torch.from_numpy(rhs)

    def tloss(v):
        v = v.to(torch.float32)
        return (0.5 * torch.einsum("...bi,bij,...bj->...b", v, ta, v)
                - torch.einsum("bi,...bi->...b", tb, v))
    res = tl.lbfgs_minimize_fixed(tloss, torch.from_numpy(x0).to(
        torch.bfloat16), **kw)
    assert res.x.dtype == torch.bfloat16 and jx.dtype == jnp.bfloat16
    jx, jf = np.asarray(jx, np.float32), np.asarray(jf)
    np.testing.assert_array_less(
        np.abs(res.x.to(torch.float32).numpy() - jx), 2e-2 * (1 + np.abs(jx)))
    np.testing.assert_array_less(np.abs(res.f.numpy() - jf),
                                 1e-3 * (1 + np.abs(jf)))


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
