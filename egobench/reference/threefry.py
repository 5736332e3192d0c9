"""JAX's threefry2x32 normal draw, in plain int64 PyTorch.

The training step draws its reparameterisation noise as
`jax.random.normal(fold_in(PRNGKey(seed), step), shape)` (with 64-bit
types off): the bits of flat element i are threefry2x32(key, (hi(i),
lo(i))) xor-ed, their top 23 bits a float in [1, 2), moved to
[nextafter(-1, 0), 1), and sqrt(2) erf_inv of that, with XLA's float32
erf_inv polynomial (M. Giles' approximation).  Written from JAX's
definitions, so the reference draws the same noise without the program.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _hash(k1, k2, a, b):
    """threefry2x32 of int64 tensors (or Python ints) a, b under (k1, k2)."""
    ks = (k1 & MASK, k2 & MASK, (k1 ^ k2 ^ PARITY) & MASK)
    a, b = (a + ks[0]) & MASK, (b + ks[1]) & MASK
    for i in range(5):
        for r in ROT[i % 2]:
            a = (a + b) & MASK
            b = (((b << r) | (b >> (32 - r))) & MASK) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + i + 1) & MASK
    return a, b


def key(seed: int) -> tuple:
    return 0, int(seed) & MASK


def fold_in(k: tuple, data: int) -> tuple:
    return _hash(k[0], k[1], 0, int(data) & MASK)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).to(torch.float64)
    p = None
    for a, b in zip(ERFINV_LT5, ERFINV_GE5):
        c = torch.where(small, torch.tensor(a, dtype=torch.float32,
                                            device=x.device),
                        torch.tensor(b, dtype=torch.float32,
                                     device=x.device)).to(torch.float64)
        p = c if p is None else (c + p * w).to(torch.float32).to(
            torch.float64)
    return p.to(torch.float32) * x


def normal(k: tuple, shape, device, block: int = 1 << 22) -> torch.Tensor:
    """`jax.random.normal(k, shape)` in float32 on `device`."""
    n = math.prod(shape)
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0))
    span = (torch.tensor(1.0) - lo).to(torch.float64).item()
    out = torch.empty(n, dtype=torch.float32, device=device)
    for at in range(0, n, block):
        idx = torch.arange(at, min(n, at + block), dtype=torch.int64,
                           device=device)
        b1, b2 = _hash(k[0], k[1], idx >> 32, idx & MASK)
        word = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
        unit = word.view(torch.float32) - 1.0
        u = (unit.to(torch.float64) * span + lo.item()).to(torch.float32)
        u = torch.maximum(u, lo.to(device))
        e = _erf_inv(u)
        out[at:at + len(idx)] = e * torch.tensor(
            math.sqrt(2.0), dtype=torch.float32, device=device)
    return out.reshape(tuple(shape))
