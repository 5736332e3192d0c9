"""Fixed-iteration L-BFGS with an explicit batch axis and a parallel
line search.

Counterpart of `lbfgs_minimize_fixed_batched` and `_two_loop_direction`
in `globalegomocap_tpu/optimize/lbfgs.py`, same math: the first step is
scaled by min(1, 1/|g|_1); K step candidates are probed in one batched
objective call and the first Armijo-satisfying one is taken (falling back
to the best probe); a row moves only where the chosen probe improves its
value; a (s, y) pair enters the rolled history only when y.s > 1e-10.

The JAX `lax.scan` over iterations is a Python loop here; its `unroll`
factor has no meaning in eager PyTorch and is ignored by design.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    grad_norm: torch.Tensor
    n_iter: int
    n_evals: int


def _two_loop_direction(grad, s_hist, y_hist, rho_hist, valid):
    """Batched two-loop recursion: grad (B, d), s/y (B, m, d) ordered
    oldest..newest, rho/valid (B, m).  Returns the direction -H g."""
    m = s_hist.shape[1]
    q = grad
    alphas = [None] * m
    for i in range(m):
        idx = m - 1 - i                                  # newest first
        a = rho_hist[:, idx] * (s_hist[:, idx] * q).sum(-1)
        a = torch.where(valid[:, idx], a, torch.zeros_like(a))
        q = q - a[:, None] * y_hist[:, idx]
        alphas[idx] = a
    # initial Hessian scaling gamma = s.y / y.y of the newest pair
    sy = (s_hist[:, m - 1] * y_hist[:, m - 1]).sum(-1)
    yy = (y_hist[:, m - 1] * y_hist[:, m - 1]).sum(-1)
    gamma = torch.where(valid[:, m - 1] & (yy > 0), sy / yy,
                        torch.ones_like(sy))
    r = gamma[:, None] * q
    for i in range(m):
        b = rho_hist[:, i] * (y_hist[:, i] * r).sum(-1)
        upd = s_hist[:, i] * (alphas[i] - b)[:, None]
        r = r + torch.where(valid[:, i, None], upd, torch.zeros_like(upd))
    return -r


def _roll_in(hist, new_row, do_update):
    """Drop the oldest slot and append new_row where do_update."""
    rolled = torch.cat([hist[:, 1:], new_row[:, None]], dim=1)
    mask = do_update.view((-1,) + (1,) * (hist.dim() - 1))
    return torch.where(mask, rolled, hist)


def lbfgs_minimize_fixed_batched(value_and_grad_batch: Callable,
                                 x0: torch.Tensor, max_iter: int = 25,
                                 history_size: int = 10, lr: float = 2.0,
                                 step_candidates=(1.0, 0.5, 0.1, 0.02),
                                 c1: float = 1e-4,
                                 unroll: int = 1) -> LBFGSResult:
    """value_and_grad_batch: (R, B, d) -> ((R, B), (R, B, d)), rows
    independent; R is the probe axis (1 for the initial eval, K inside
    the line search).  x0: (B, d).  `unroll` is accepted for signature
    parity with the JAX solver and ignored."""
    del unroll
    b, dim = x0.shape
    dtype, dev = x0.dtype, x0.device
    cands = torch.tensor(step_candidates, dtype=dtype, device=dev) * lr
    k = len(step_candidates)

    f0, g0 = value_and_grad_batch(x0[None])
    x, f, g = x0, f0[0], g0[0]
    first_scale = torch.minimum(torch.ones_like(f),
                                1.0 / g.abs().sum(-1))

    s_hist = torch.zeros((b, history_size, dim), dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho_hist = torch.zeros((b, history_size), dtype=dtype, device=dev)
    valid = torch.zeros((b, history_size), dtype=torch.bool, device=dev)
    for it in range(max_iter):
        d = _two_loop_direction(g, s_hist, y_hist, rho_hist, valid)
        good = ((d * g).sum(-1) < 0) & torch.isfinite(d).all(-1)
        d = torch.where(good[:, None], d, -g)
        dphi0 = (d * g).sum(-1)                             # (B,)

        scale = first_scale if it == 0 else torch.ones_like(first_scale)
        ts = cands[:, None] * scale[None, :]                # (K, B)
        xs = x[None] + ts[:, :, None] * d[None]             # (K, B, d)
        fs_raw, gs = value_and_grad_batch(xs)
        fs = torch.where(torch.isfinite(fs_raw), fs_raw,
                         torch.full_like(fs_raw, float("inf")))

        armijo = fs <= f[None] + c1 * ts * dphi0[None]      # (K, B)
        first_ok = torch.argmax(armijo.to(torch.uint8), dim=0)
        best = torch.argmin(fs, dim=0)
        idx = torch.where(armijo.any(0), first_ok, best)    # (B,)
        f_sel = fs.gather(0, idx[None])[0]
        g_sel = gs.gather(0, idx[None, :, None].expand(1, b, dim))[0]
        t_sel = ts.gather(0, idx[None])[0]
        improved = f_sel < f
        t = torch.where(improved, t_sel, torch.zeros_like(t_sel))

        step_vec = t[:, None] * d
        x = x + step_vec
        f_new = torch.where(improved, f_sel, f)
        g_new = torch.where(improved[:, None], g_sel, g)
        y = g_new - g
        ys = (y * step_vec).sum(-1)
        do_update = ys > 1e-10
        s_hist = _roll_in(s_hist, step_vec, do_update)
        y_hist = _roll_in(y_hist, y, do_update)
        rho_hist = _roll_in(rho_hist, 1.0 / ys, do_update)
        valid = _roll_in(valid, torch.ones_like(do_update), do_update)
        f, g = f_new, g_new
    return LBFGSResult(x=x, f=f, grad_norm=g.abs().amax(-1),
                       n_iter=max_iter, n_evals=max_iter * k + 1)
