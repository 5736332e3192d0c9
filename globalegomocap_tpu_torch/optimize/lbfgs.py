"""Fixed-iteration L-BFGS with a parallel line search and an explicit lane
axis.

Counterpart of `lbfgs_minimize_fixed` and `lbfgs_minimize_fixed_batched`
in `globalegomocap_tpu/optimize/lbfgs.py`, same math: the first step is
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
    n_iter: int
    n_evals: int


def _roll_in(hist, new_row, do_update):
    """Drop the oldest slot and append new_row where do_update."""
    rolled = torch.cat([hist[:, 1:], new_row[:, None]], dim=1)
    mask = do_update.view((-1,) + (1,) * (hist.dim() - 1))
    return torch.where(mask, rolled, hist)


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

    def value_and_grad(x3):
        with torch.enable_grad():
            x = x3.detach().requires_grad_(True)
            vals = loss_fn(x)
            (g,) = torch.autograd.grad(vals.sum(), x)
        return vals.detach(), g

    def value(x3):
        with torch.no_grad():
            return loss_fn(x3)

    x, f, g = _fixed_loop(
        value_and_grad, None if fused_probes else value, x0, max_iter,
        history_size, lr, step_candidates, c1,
        direction_ops.lbfgs_direction if pallas_direction
        else _two_loop_direction)
    k = len(step_candidates)
    n_evals = max_iter * k + 1 if fused_probes else max_iter * (k + 1) + 1
    return LBFGSResult(x=x, f=f, grad_norm=g.abs().amax(-1),
                       n_iter=max_iter, n_evals=n_evals)


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
                       n_evals=max_iter * len(step_candidates) + 1)
