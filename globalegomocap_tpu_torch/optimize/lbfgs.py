"""The latent solvers with an explicit lane axis: fixed-iteration L-BFGS
with a parallel line search, L-BFGS with a strong-Wolfe line search, and
Adam.

Counterparts of `lbfgs_minimize_fixed`, `lbfgs_minimize_fixed_batched`,
`lbfgs_minimize` and `adam_minimize` in
`globalegomocap_tpu/optimize/lbfgs.py`.

The fixed-iteration solvers, same math: the first step is
scaled per lane by min(1, 1/|g|_1); K step candidates are probed in one
batched objective call and the first Armijo-satisfying one is taken
(falling back to the best probe); a lane moves only where the chosen probe
improves its value; a (s, y) pair enters the rolled history only when
y.s > 1e-10.  Both solvers run one loop (`_fixed_loop`).

`lbfgs_minimize_fixed` is the JAX per-lane solver with the lane (window)
axis written out, where the JAX pipeline `vmap`s it: x (B, d) and a loss
(..., B, d) -> (..., B).  `lbfgs_minimize_fixed_batched` is the solver of
the fused energy kernels, with fused probes and a value-and-grad callback.
A bf16 x0 (the bfloat16_delta and bfloat16_pure tiers) keeps the whole
state in bf16, as JAX's weak typing does; the energies stay float32.

The JAX `lax.scan` over iterations is a Python loop here; its `unroll`
factor has no meaning in eager PyTorch and is ignored by design.

`lbfgs_minimize` is the reference's torch.optim.LBFGS setup
(strong-Wolfe, lr 2, tolerance_change 1e-6), which the JAX package runs
per window under `vmap`: its `lax.while_loop`s and `lax.cond` become a
per-lane state machine here.  Every lane keeps its own line-search stage,
evaluation count, bracket and `done` flag, all updated with
`torch.where`, so a lane whose search or solve has ended keeps its state
exactly, as JAX's batched while-loop keeps it.  Every line-search step
evaluates all lanes in one batched objective call (static shapes); the
loops end when no lane is active, read once per step.  The direction is
the plain two-loop recursion, as in JAX.  A bf16 x0 keeps x, g, the
history and the step lengths in bf16 and the energies in float32; JAX's
`lbfgs_minimize` raises there (its while-loop carry would change dtype).

`LBFGSResult.n_calls` is the number of batched objective calls a solve
made (each evaluates every lane), where `n_evals` counts one lane's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from globalegomocap_tpu_torch.ops import lbfgs_direction as direction_ops
from globalegomocap_tpu_torch.ops.lbfgs_direction import (
    two_loop_direction as _two_loop_direction)


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    grad_norm: torch.Tensor
    n_iter: int | torch.Tensor     # per lane (B,) for lbfgs_minimize
    n_evals: int | torch.Tensor
    n_calls: int


def _roll_in(hist, new_row, do_update):
    """Drop the oldest slot and append new_row where do_update."""
    rolled = torch.cat([hist[:, 1:], new_row[:, None]], dim=1)
    mask = do_update.view((-1,) + (1,) * (hist.dim() - 1))
    return torch.where(mask, rolled, hist)


def _value_and_grad(loss_fn: Callable) -> Callable:
    """x (..., B, d) -> (loss_fn(x), d sum(loss_fn(x)) / dx), detached."""
    def value_and_grad(x3):
        with torch.enable_grad():
            x = x3.detach().requires_grad_(True)
            vals = loss_fn(x)
            (g,) = torch.autograd.grad(vals.sum(), x)
        return vals.detach(), g
    return value_and_grad


def _fixed_loop(value_and_grad, value, x0, max_iter, history_size, lr,
                step_candidates, c1, direction):
    """The shared iteration.  value_and_grad: (R, B, d) -> ((R, B),
    (R, B, d)); value: (R, B, d) -> (R, B), or None for fused probes
    (value-and-grad at every candidate, the accepted one's (f, g) kept)."""
    b, dim = x0.shape
    dtype, dev = x0.dtype, x0.device
    cands = torch.tensor(step_candidates, dtype=dtype, device=dev) * lr

    f0, g0 = value_and_grad(x0[None])
    x, f, g = x0, f0[0], g0[0]
    # in the state's dtype, as JAX's weakly typed minimum(1.0, ...) keeps
    # it: a float32 scale would promote every probe and the whole state
    first_scale = (1.0 / g.abs().sum(-1)).clamp(max=1.0).to(dtype)

    s_hist = torch.zeros((b, history_size, dim), dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho_hist = torch.zeros((b, history_size), dtype=dtype, device=dev)
    valid = torch.zeros((b, history_size), dtype=torch.bool, device=dev)
    for it in range(max_iter):
        d = direction(g, s_hist, y_hist, rho_hist, valid)
        good = ((d * g).sum(-1) < 0) & torch.isfinite(d).all(-1)
        d = torch.where(good[:, None], d, -g)
        dphi0 = (d * g).sum(-1)                             # (B,)

        scale = first_scale if it == 0 else torch.ones_like(first_scale)
        ts = cands[:, None] * scale[None, :]                # (K, B)
        xs = x[None] + ts[:, :, None] * d[None]             # (K, B, d)
        if value is None:
            fs_raw, gs = value_and_grad(xs)
        else:
            fs_raw = value(xs)
        fs = torch.where(torch.isfinite(fs_raw), fs_raw,
                         torch.full_like(fs_raw, float("inf")))

        armijo = fs <= f[None] + c1 * ts * dphi0[None]      # (K, B)
        first_ok = torch.argmax(armijo.to(torch.uint8), dim=0)
        best = torch.argmin(fs, dim=0)
        idx = torch.where(armijo.any(0), first_ok, best)    # (B,)
        f_sel = fs.gather(0, idx[None])[0]
        t_sel = ts.gather(0, idx[None])[0]
        improved = f_sel < f
        t = torch.where(improved, t_sel, torch.zeros_like(t_sel))

        step_vec = t[:, None] * d
        x = x + step_vec
        if value is None:
            g_sel = gs.gather(0, idx[None, :, None].expand(1, b, dim))[0]
            f_new = torch.where(improved, f_sel, f)
            g_new = torch.where(improved[:, None], g_sel, g)
        else:
            f_new, g_new = value_and_grad(x[None])
            f_new, g_new = f_new[0], g_new[0]
        y = g_new - g
        ys = (y * step_vec).sum(-1)
        do_update = ys > 1e-10
        s_hist = _roll_in(s_hist, step_vec, do_update)
        y_hist = _roll_in(y_hist, y, do_update)
        rho_hist = _roll_in(rho_hist, 1.0 / ys, do_update)
        valid = _roll_in(valid, torch.ones_like(do_update), do_update)
        f, g = f_new, g_new
    return x, f, g


def lbfgs_minimize_fixed(loss_fn: Callable, x0: torch.Tensor,
                         max_iter: int = 25, history_size: int = 10,
                         lr: float = 2.0,
                         step_candidates=(1.0, 0.5, 0.1, 0.02),
                         c1: float = 1e-4, fused_probes: bool = False,
                         compact_direction: bool = False,
                         circular_history: bool = False,
                         pallas_direction: bool = False,
                         unroll: int = 1) -> LBFGSResult:
    """Per-lane fixed-iteration L-BFGS over the lanes of x0 (B, d).

    loss_fn: (..., B, d) -> (..., B), lanes independent.  Every iteration
    probes all candidates in one call: value-only under no_grad, then a
    value-and-grad at the accepted point (fused_probes=False, the JAX
    default), or value-and-grad at every candidate (fused_probes=True).
    pallas_direction=True takes the direction from the `lbfgs_direction`
    kernel (the plain two-loop on the CPU).  `unroll` is accepted for
    signature parity and ignored."""
    del unroll
    if compact_direction:
        raise NotImplementedError(
            "solver.compact_direction=True is not ported yet")
    if circular_history:
        raise NotImplementedError(
            "solver.circular_history=True is not ported yet")

    def value(x3):
        with torch.no_grad():
            return loss_fn(x3)

    x, f, g = _fixed_loop(
        _value_and_grad(loss_fn), None if fused_probes else value, x0,
        max_iter, history_size, lr, step_candidates, c1,
        direction_ops.lbfgs_direction if pallas_direction
        else _two_loop_direction)
    k = len(step_candidates)
    n_evals = max_iter * k + 1 if fused_probes else max_iter * (k + 1) + 1
    return LBFGSResult(x=x, f=f, grad_norm=g.abs().amax(-1),
                       n_iter=max_iter, n_evals=n_evals,
                       n_calls=1 + max_iter * (1 if fused_probes else 2))


def lbfgs_minimize_fixed_batched(value_and_grad_batch: Callable,
                                 x0: torch.Tensor, max_iter: int = 25,
                                 history_size: int = 10, lr: float = 2.0,
                                 step_candidates=(1.0, 0.5, 0.1, 0.02),
                                 c1: float = 1e-4,
                                 unroll: int = 1) -> LBFGSResult:
    """value_and_grad_batch: (R, B, d) -> ((R, B), (R, B, d)), rows
    independent; R is the probe axis (1 for the initial eval, K inside
    the line search).  x0: (B, d).  Fused probes and the plain two-loop
    direction, as in the JAX solver.  `unroll` is accepted for signature
    parity with the JAX solver and ignored."""
    del unroll
    x, f, g = _fixed_loop(value_and_grad_batch, None, x0, max_iter,
                          history_size, lr, step_candidates, c1,
                          _two_loop_direction)
    return LBFGSResult(x=x, f=f, grad_norm=g.abs().amax(-1),
                       n_iter=max_iter,
                       n_evals=max_iter * len(step_candidates) + 1,
                       n_calls=1 + max_iter)


def _cubic_minimizer(x1, f1, g1, x2, f2, g2, lo, hi):
    """Minimiser of the cubic Hermite interpolant through (x1, f1, g1) and
    (x2, f2, g2), clipped to [lo, hi]; the midpoint of [lo, hi] where the
    interpolation is degenerate (coincident points, a negative
    discriminant, a non-finite candidate).  Elementwise over lanes."""
    dx = x1 - x2
    apart = dx.abs() > 1e-20
    d1 = g1 + g2 - 3.0 * (f1 - f2) / torch.where(apart, dx,
                                                 torch.ones_like(dx))
    d2_sq = d1 * d1 - g1 * g2
    d2 = torch.sqrt(torch.clamp_min(d2_sq, 0.0))
    denom = g2 - g1 + 2.0 * d2
    denom_ok = denom.abs() > 1e-20
    cand = x2 - (x2 - x1) * ((g2 + d2 - d1) / torch.where(
        denom_ok, denom, torch.ones_like(denom)))
    ok = (d2_sq >= 0.0) & apart & denom_ok & torch.isfinite(cand)
    cand = torch.where(ok, cand, 0.5 * (lo + hi))
    return torch.minimum(torch.maximum(cand, lo), hi)


def _pick(cond, *pairs):
    """torch.where(cond, a, b) for each (a, b) of `pairs`."""
    return [torch.where(cond, a, b) for a, b in pairs]


def _strong_wolfe(value_and_grad, x, d, t0, f0, g0, searching, c1, c2,
                  max_evals):
    """The strong-Wolfe line search of every lane where `searching`, along
    d (B, dim) from x: JAX's bracket-and-zoom, one batched call per step.

    t0 (B,) first trial steps; f0 (B,) and g0 (B, dim) at x.  Returns
    (t*, f(x + t* d), g(x + t* d), evaluations per lane, batched calls).
    A lane whose search ends keeps its state while others go on; a lane
    that runs out of evaluations falls back to its bracket's low end if it
    beats f0, else to t = 0; one final call evaluates every lane at t*."""
    dtype = x.dtype
    dphi0 = (g0 * d).sum(-1)
    zero = torch.zeros_like(t0)
    stage = torch.where(searching, 0, 2)         # 0 bracket, 1 zoom, 2 done
    nev = torch.zeros_like(stage)
    t, t_prev, f_prev, dphi_prev = t0, zero, f0, dphi0
    t_lo, f_lo, d_lo, t_hi, f_hi, d_hi = zero, f0, dphi0, zero, f0, dphi0
    t_star = zero
    calls = 0
    while True:
        live = (stage < 2) & (nev < max_evals)
        if not bool(live.any()):
            break
        f_t, g_t = value_and_grad(x + t[:, None] * d)
        calls += 1
        dphi_t = (g_t * d).sum(-1)
        nev_t = nev + 1
        # a non-finite value is an Armijo failure: the search brackets and
        # shrinks instead of expanding further
        armijo = (~torch.isfinite(f_t)) | (f_t > f0 + c1 * t * dphi0)
        wolfe = dphi_t.abs() <= -c2 * dphi0

        # bracketing: [prev, t] on an Armijo failure, accept on Wolfe,
        # [t, prev] when ascending, else extrapolate (capped at 10 t)
        fail_b = armijo | ((nev_t > 1) & (f_t >= f_prev))
        accept_b = (~fail_b) & wolfe
        zoom2 = (~fail_b) & (~wolfe) & (dphi_t >= 0.0)
        t_next = _cubic_minimizer(t_prev, f_prev, dphi_prev, t, f_t, dphi_t,
                                  t + 0.01 * (t - t_prev), t * 10.0)
        stage_b = torch.where(accept_b, 2, torch.where(fail_b | zoom2, 1, 0))
        bt_lo, bf_lo, bd_lo, bt_hi, bf_hi, bd_hi = [
            torch.where(fail_b, a, torch.where(zoom2, b, c)) for a, b, c in (
                (t_prev, t, t_lo), (f_prev, f_t, f_lo),
                (dphi_prev, dphi_t, d_lo), (t, t_prev, t_hi),
                (f_t, f_prev, f_hi), (dphi_t, dphi_prev, d_hi))]
        zb_lo = torch.minimum(bt_lo, bt_hi)
        zb_hi = torch.maximum(bt_lo, bt_hi)
        zw = zb_hi - zb_lo
        t_zoom = _cubic_minimizer(bt_lo, bf_lo, bd_lo, bt_hi, bf_hi, bd_hi,
                                  zb_lo + 0.1 * zw, zb_hi - 0.1 * zw)
        bt = torch.where(stage_b == 0, t_next,
                         torch.where(stage_b == 1, t_zoom, t))
        extend = stage_b == 0
        bt_prev, bf_prev, bd_prev = _pick(
            extend, (t, t_prev), (f_t, f_prev), (dphi_t, dphi_prev))
        bt_star = torch.where(accept_b, t, t_star)

        # zoom (Nocedal & Wright, algorithm 3.6): on an Armijo failure
        # hi = t, else hi = lo where dphi_t (hi - lo) >= 0, then lo = t
        fail_z = armijo | (f_t >= f_lo)
        accept_z = (~fail_z) & wolfe
        swap = dphi_t * (t_hi - t_lo) >= 0
        zt_hi, zf_hi, zd_hi = [
            torch.where(fail_z, a, torch.where(swap, b, c)) for a, b, c in (
                (t, t_lo, t_hi), (f_t, f_lo, f_hi), (dphi_t, d_lo, d_hi))]
        zt_lo, zf_lo, zd_lo = _pick(fail_z, (t_lo, t), (f_lo, f_t),
                                    (d_lo, dphi_t))
        lo_z, hi_z = torch.minimum(zt_lo, zt_hi), torch.maximum(zt_lo, zt_hi)
        width = hi_z - lo_z
        t_next_z = _cubic_minimizer(zt_lo, zf_lo, zd_lo, zt_hi, zf_hi, zd_hi,
                                    lo_z + 0.1 * width, hi_z - 0.1 * width)
        collapsed = width <= 1e-9 * torch.clamp_min(hi_z.abs(), 1.0)
        stage_z = torch.where(accept_z | collapsed, 2, 1)
        zt = torch.where(stage_z == 1, t_next_z, t)
        zt_star = torch.where(accept_z, t,
                              torch.where(collapsed, zt_lo, t_star))

        # each lane takes its stage's branch, and only a live lane moves
        bracketing = stage == 0
        new = _pick(bracketing, (stage_b, stage_z), (bt, zt),
                    (bt_prev, t_prev), (bf_prev, f_prev), (bd_prev, dphi_prev),
                    (bt_lo, zt_lo), (bf_lo, zf_lo), (bd_lo, zd_lo),
                    (bt_hi, zt_hi), (bf_hi, zf_hi), (bd_hi, zd_hi),
                    (bt_star, zt_star))
        old = (stage, t, t_prev, f_prev, dphi_prev, t_lo, f_lo, d_lo, t_hi,
               f_hi, d_hi, t_star)
        (stage, t, t_prev, f_prev, dphi_prev, t_lo, f_lo, d_lo, t_hi, f_hi,
         d_hi, t_star) = [torch.where(live, a, b).to(b.dtype)
                          for a, b in zip(new, old)]
        nev = torch.where(live, nev_t, nev)

    fallback = torch.where(f_lo < f0, t_lo, zero)
    t_star = torch.where(stage < 2, fallback, t_star).to(dtype)
    f_star, g_star = value_and_grad(x + t_star[:, None] * d)
    return t_star, f_star, g_star, nev + 1, calls + 1


def lbfgs_minimize(loss_fn: Callable, x0: torch.Tensor, max_iter: int = 25,
                   history_size: int = 25, lr: float = 2.0,
                   tolerance_change: float = 1e-6,
                   tolerance_grad: float = 1e-7, c1: float = 1e-4,
                   c2: float = 0.9, max_ls_evals: int = 25) -> LBFGSResult:
    """Per-lane L-BFGS with a strong-Wolfe line search over the lanes of
    x0 (B, d); loss_fn: (..., B, d) -> (..., B), lanes independent.

    The reference's torch configuration: the first step min(1, 1/|g|_1)
    lr, later steps from lr; a (s, y) pair enters the history only where
    y.s > 1e-10; a direction that does not descend restarts from -g.  A
    lane stops on max|g| <= tolerance_grad, max|t d| <= tolerance_change
    or |df| < tolerance_change, or after max_iter iterations.  n_iter and
    n_evals are per lane (B,) int64 tensors."""
    value_and_grad = _value_and_grad(loss_fn)
    b, dim = x0.shape
    dtype, dev = x0.dtype, x0.device
    f, g = value_and_grad(x0)
    x, d = x0, -g
    s_hist = torch.zeros((b, history_size, dim), dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho_hist = torch.zeros((b, history_size), dtype=dtype, device=dev)
    valid = torch.zeros((b, history_size), dtype=torch.bool, device=dev)
    n_iter = torch.zeros(b, dtype=torch.int64, device=dev)
    n_evals = torch.ones_like(n_iter)
    done = g.abs().amax(-1) <= tolerance_grad
    calls = 1
    while True:
        active = (~done) & (n_iter < max_iter)
        if not bool(active.any()):
            break
        t0 = torch.where(n_iter == 0,
                         (1.0 / g.abs().sum(-1)).clamp(max=1.0) * lr,
                         torch.full_like(f, lr)).to(dtype)
        t, f_new, g_new, nev, c = _strong_wolfe(
            value_and_grad, x, d, t0, f, g, active, c1, c2, max_ls_evals)
        calls += c
        step = t[:, None] * d
        y = g_new - g
        ys = (y * step).sum(-1)
        do_update = active & (ys > 1e-10)
        s_hist = _roll_in(s_hist, step, do_update)
        y_hist = _roll_in(y_hist, y, do_update)
        rho_hist = _roll_in(rho_hist, 1.0 / ys, do_update)
        valid = _roll_in(valid, torch.ones_like(do_update), do_update)
        d_new = _two_loop_direction(g_new, s_hist, y_hist, rho_hist, valid)
        descent = ((d_new * g_new).sum(-1) < 0) & torch.isfinite(d_new).all(-1)
        d_new = torch.where(descent[:, None], d_new, -g_new)
        stop = ((g_new.abs().amax(-1) <= tolerance_grad)
                | (step.abs().amax(-1) <= tolerance_change)
                | ((f_new - f).abs() < tolerance_change))
        lane = active[:, None]
        x = torch.where(lane, x + step, x)
        g = torch.where(lane, g_new, g)
        d = torch.where(lane, d_new, d)
        f = torch.where(active, f_new, f)
        done = torch.where(active, stop, done)
        n_evals = n_evals + torch.where(active, nev, 0)
        n_iter = n_iter + active.to(n_iter.dtype)
    return LBFGSResult(x=x, f=f, grad_norm=g.abs().amax(-1), n_iter=n_iter,
                       n_evals=n_evals, n_calls=calls)


def adam_minimize(loss_fn: Callable, x0: torch.Tensor, steps: int = 150,
                  lr: float = 0.05, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> LBFGSResult:
    """Fixed-step, bias-corrected Adam over the lanes of x0 (B, d), with
    `lbfgs_minimize`'s calling convention; steps + 1 evaluations.  The
    bias corrections b^(i+1) are taken in x0's dtype, as JAX takes them
    from its step counter `arange(steps, dtype=x0.dtype)`."""
    value_and_grad = _value_and_grad(loss_fn)
    x, m, v = x0, torch.zeros_like(x0), torch.zeros_like(x0)
    b1_t = torch.tensor(b1, dtype=x0.dtype, device=x0.device)
    b2_t = torch.tensor(b2, dtype=x0.dtype, device=x0.device)
    for i in range(steps):
        _, g = value_and_grad(x)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        k = torch.tensor(i + 1.0, dtype=x0.dtype, device=x0.device)
        mh = m / (1 - b1_t ** k)
        vh = v / (1 - b2_t ** k)
        x = x - lr * mh / (torch.sqrt(vh) + eps)
    f, g = value_and_grad(x)
    return LBFGSResult(x=x, f=f, grad_norm=g.abs().amax(-1), n_iter=steps,
                       n_evals=steps + 1, n_calls=steps + 1)
