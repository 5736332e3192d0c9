"""JAX's threefry random stream, in PyTorch integer ops.

Counterpart of the part of `jax.random` that the solver's sample init
draws through (`models/conv_vae.py::sample_init`): `PRNGKey`, the
threefry2x32 hash, `random_bits` with `jax_threefry_partitionable` on
(JAX's default), and `uniform` and `normal` in float32 and bfloat16.
The same key and shape give the same bits as JAX, on the CPU and on the
card alike.

- A key is JAX's two 32-bit words.  With 64-bit types off (JAX's
  default) a seed is taken modulo 2**32 and its high word is 0.
- The bits of element i of a draw are `threefry2x32(key, (hi(i),
  lo(i)))` of its flat index i, the 32-bit word `bits1 ^ bits2`, its low
  8 or 16 bits for the narrow widths.  `start` offsets the flat index,
  so a rank draws its rows of a global shape: `normal(key, (n, d),
  start=r * d)` is rows r..r+n of the draw of a larger shape.
- `uniform` keeps the top mantissa bits under exponent 1, as
  `jax.random.uniform` does.  bfloat16 has 7 mantissa bits, fewer than
  8, so JAX draws 8 bits for it: a bf16 draw is its own stream, not the
  float32 draw rounded.
- `normal` is `sqrt(2) * erf_inv(u)` of u uniform on [nextafter(-1,
  0), 1), as `jax.random.normal` computes it.  `erf_inv` is XLA's
  float32 polynomial (M. Giles' approximation, as XLA writes it), its
  Horner steps fused as XLA's CPU code fuses them (each step in float64,
  rounded once to float32).  In float32 it stays within 4.8e-7 of JAX
  on the CPU at (192, 2048), where `torch.erfinv` strays by 2.2e-5 (the
  tails); a bfloat16 draw rounds the float32 `erf_inv` to bf16 and
  multiplies by bf16's sqrt(2), and equals JAX's exactly
  (`tests/test_torch_random.py`).

The arithmetic runs in int64 masked to 32 bits (torch's uint32 has few
operators).  It is plain PyTorch, on the device of the caller's choice:
JAX's own draw is no Pallas kernel.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int) -> tuple[int, int]:
    """JAX's `PRNGKey(seed)` words (high, low) with 64-bit types off:
    the seed modulo 2**32 in the low word, 0 in the high one."""
    return 0, int(seed) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the counter words (x1, x2) under the key
    (k1, k2): 20 rounds with JAX's rotations and key schedule.  x1, x2
    are int64 tensors holding 32-bit words; so are the results."""
    ks = (k1 & MASK32, k2 & MASK32, (k1 ^ k2 ^ _PARITY) & MASK32)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK32
    return x[0], x[1]


def random_bits(key: tuple[int, int], bit_width: int, shape,
                start: int = 0, device=None) -> torch.Tensor:
    """`jax.random.bits(key, shape)` at `bit_width` (8, 16 or 32) under
    the partitionable threefry, from flat index `start`: an int64 tensor
    of the unsigned values."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width={bit_width}: 8, 16 or 32")
    n = math.prod(shape)
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    bits = b1 ^ b2
    if bit_width < 32:
        bits = bits & ((1 << bit_width) - 1)
    return bits.reshape(tuple(shape))


def _unit_floats(key, shape, dtype, start, device) -> torch.Tensor:
    """Floats in [1, 2) from the top mantissa bits, as JAX's `_uniform`
    builds them."""
    if dtype == torch.float32:
        bits = random_bits(key, 32, shape, start, device)
        word = (bits >> (32 - 23)) | 0x3F800000
        return word.to(torch.int32).view(torch.float32)
    if dtype == torch.bfloat16:
        bits = random_bits(key, 8, shape, start, device)
        word = (bits >> (8 - 7)) | 0x3F80
        return word.to(torch.int16).view(torch.bfloat16)
    raise ValueError(f"dtype={dtype}: float32 or bfloat16")


def uniform(key, shape, dtype=torch.float32, minval: float = 0.0,
            maxval: float = 1.0, start: int = 0, device=None
            ) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)`: the unit
    floats less 1, scaled and shifted in `dtype`, and held at minval."""
    lo = torch.tensor(minval, dtype=dtype, device=device)
    hi = torch.tensor(maxval, dtype=dtype, device=device)
    floats = _unit_floats(key, shape, dtype, start, device) - 1.0
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's ErfInv32 coefficients, for w = -log1p(-x*x) below 5 and above it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 `erf_inv` of float32 `x`: the degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3 of w = -log1p(-x*x), each Horner step
    one float64 multiply-add rounded to float32, and x times the largest
    float32 at |x| = 1."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).to(torch.float64)
    coef = [torch.where(small, torch.tensor(a, dtype=torch.float32,
                                            device=x.device),
                        torch.tensor(b, dtype=torch.float32,
                                     device=x.device)).to(torch.float64)
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = (c + p * w).to(torch.float32).to(torch.float64)
    out = p.to(torch.float32) * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       out)


def normal(key, shape, dtype=torch.float32, start: int = 0,
           device=None) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)` in float32 or bfloat16:
    sqrt(2) * erf_inv(u) of u uniform on [nextafter(-1, 0), 1) in
    `dtype`, with `erf_inv` in float32 and its result and sqrt(2) rounded
    to `dtype` before the product."""
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                               torch.tensor(0.0, dtype=dtype)))
    u = uniform(key, shape, dtype, lo, 1.0, start, device)
    e = erf_inv(u.to(torch.float32)).to(dtype)
    return e * torch.tensor(math.sqrt(2.0), dtype=dtype, device=device)
