"""The L-BFGS two-loop recursion, one lane per row.

Replaces the Pallas TPU kernels of `globalegomocap_tpu/ops/pallas/
lbfgs_direction.py`: `lbfgs_direction_pallas` and, under `vmap`, the
lane-blocked `lbfgs_direction_pallas_batched`.  grad (B, d), s/y
histories (B, m, d) ordered oldest..newest, rho (B, m), valid (B, m) bool
-> the direction -H g (B, d), with the slot masking and the initial
scaling gamma = s.y / y.y of the newest valid pair.

`two_loop_direction` is the plain PyTorch version (the JAX package's
`optimize/lbfgs.py::_two_loop_direction`, which its fixed solvers run when
the kernel is off).  `lbfgs_direction` dispatches: a CUDA tensor launches
`csrc/lbfgs_direction.cu` (built and bound by `ops/cuda_build.py`) or
raises; a CPU tensor runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from globalegomocap_tpu_torch.ops import cuda_build

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"lbfgs_direction_launch": (
    [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _VP], _CI)}
# q, alpha and the warps' partial sums share the block's shared memory
_SMEM_LIMIT = 48 * 1024


def _library():
    return cuda_build.library("lbfgs_direction", _SIGNATURES)


def _dot(a, b):
    """Row-wise dot product in float32, rounded once to the inputs' dtype:
    `jnp.dot`'s bf16 semantics (exact products, a float32 sum)."""
    return (a.to(torch.float32) * b.to(torch.float32)).sum(-1).to(a.dtype)


def two_loop_direction(grad, s_hist, y_hist, rho_hist, valid):
    """Batched two-loop recursion: grad (B, d), s/y (B, m, d) ordered
    oldest..newest, rho/valid (B, m), float32 or bf16 (the state's dtype
    throughout).  Returns the direction -H g."""
    m = s_hist.shape[1]
    q = grad
    alphas = [None] * m
    for i in range(m):
        idx = m - 1 - i                                  # newest first
        a = rho_hist[:, idx] * _dot(s_hist[:, idx], q)
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
        b = rho_hist[:, i] * _dot(y_hist[:, i], r)
        upd = s_hist[:, i] * (alphas[i] - b)[:, None]
        r = r + torch.where(valid[:, i, None], upd, torch.zeros_like(upd))
    return -r


def lbfgs_direction(grad, s_hist, y_hist, rho_hist, valid):
    """The two-loop direction (B, d): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if grad.dim() != 2 or s_hist.dim() != 3:
        raise ValueError(f"grad must be (B, d) and s_hist (B, m, d), got "
                         f"{tuple(grad.shape)} and {tuple(s_hist.shape)}")
    b, m, d = s_hist.shape
    dev = grad.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if b < 1 or m < 1 or d < 1:
        raise ValueError("empty lane, history or parameter axis")
    f32 = (torch.float32,)
    cuda_build.expect(grad, "grad", (b, d), f32, dev)
    cuda_build.expect(s_hist, "s_hist", (b, m, d), f32, dev)
    cuda_build.expect(y_hist, "y_hist", (b, m, d), f32, dev)
    cuda_build.expect(rho_hist, "rho_hist", (b, m), f32, dev)
    cuda_build.expect(valid, "valid", (b, m), (torch.bool,), dev)
    if cuda_build.use_plain(dev):
        return two_loop_direction(grad, s_hist, y_hist, rho_hist, valid)
    if (d + m + 8) * 4 > _SMEM_LIMIT:
        raise ValueError(f"d={d}, m={m}: q does not fit one block's "
                         f"{_SMEM_LIMIT} bytes of shared memory")
    out = torch.empty_like(grad)
    err = _library().lbfgs_direction_launch(
        grad.data_ptr(), s_hist.data_ptr(), y_hist.data_ptr(),
        rho_hist.data_ptr(), valid.data_ptr(), out.data_ptr(), b, m, d,
        cuda_build.stream_of(dev))
    cuda_build.launched("lbfgs_direction", err)
    return out
