"""JAX's threefry random streams, on the CPU and on the card.

Counterpart of the part of `jax.random` (and of Flax's key derivation)
that the port draws through: the solver's sample init
(`models/conv_vae.py::sample_init`), Flax's parameter initialisation
(`models/conv_vae.py::init_flax_like`), both trainers' reparameterisation
noise, the prior's samples (`tools/prior_tools.py`) and RANSAC's
hypotheses (`ops/umeyama.py`).  The same key and shape give the same
values as JAX, on the CPU and on the card alike:

- `prng_key`, `split`, `fold_in` and `fold_in_static` (Flax's
  `_fold_in_static`) work on keys, JAX's two 32-bit words as a tuple of
  Python ints.  With 64-bit types off (JAX's default) a seed is taken
  modulo 2**32 and its high word is 0.  `split(key, n)` is the
  partitionable threefry's: key i is `threefry2x32(key, (0, i))`;
  `fold_in(key, d)` is `threefry2x32(key, (0, d))`.
- `random_bits`, `uniform`, `normal` and `truncated_normal` draw arrays.
  The bits of element i of a draw are `threefry2x32(key, (hi(i),
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
- `truncated_normal(key, lower, upper)` is `jax.random.truncated_normal`:
  u uniform between erf(lower / sqrt 2) and erf(upper / sqrt 2), then
  sqrt(2) * erf_inv(u), clamped to the open interval.  The two erf values
  are float64 `math.erf` rounded to the dtype; at Flax's bounds (-2, 2)
  they are XLA's float32 and bf16 erf values exactly (held in the tests;
  XLA's float32 erf is a rational polynomial of its own, which elsewhere
  may differ from the rounded erf by an ulp).
- `permutation(key, n)` is JAX's `_shuffle` of arange(n): ceil(3 ln n /
  ln(2**32 - 1)) rounds, each a split, 32-bit sort keys and a stable
  sort; `choice(key, n, k)` (without replacement) its first k entries.

Every array draw goes through `draw`: on a CUDA device it launches
`csrc/threefry.cu` (built and bound by `ops/cuda_build.py`; one thread
an element, no fallback), on the CPU it runs `plain_draw`, the same
arithmetic in int64 torch ops masked to 32 bits (torch's uint32 has few
operators), in blocks of 2**16 elements, so that a large draw holds few
temporaries and they stay in cache.  JAX's own draw is no Pallas kernel:
XLA fuses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import math

import numpy as np
import torch

from globalegomocap_tpu_torch.ops import cuda_build

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_SQRT2 = math.sqrt(2.0)
# what one plain-version block draws at once
_BLOCK = 1 << 16

# the kinds of draw, as csrc/threefry.cu numbers them
BITS, UNIFORM, NORMAL, TRUNCATED = 0, 1, 2, 3
_FLOATS = (torch.float32, torch.bfloat16)
# nextafter(-1, 0) in each dtype: the low end of the normal's uniform
_NORMAL_LOW = {dt: float(torch.nextafter(torch.tensor(-1.0, dtype=dt),
                                         torch.tensor(0.0, dtype=dt)))
               for dt in _FLOATS}

_VP, _CI, _CLL, _CF = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
_SIGNATURES = {
    "threefry_draw_launch": (
        [_CI, _CI, _CI, ctypes.c_uint32, ctypes.c_uint32, _CLL, _CLL, _CF,
         _CF, _CF, _CF, _VP, _VP], _CI)}


def _library():
    return cuda_build.library("threefry", _SIGNATURES)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def prng_key(seed: int) -> tuple[int, int]:
    """JAX's `PRNGKey(seed)` words (high, low) with 64-bit types off:
    the seed modulo 2**32 in the low word, 0 in the high one."""
    return 0, int(seed) & MASK32


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the counter words (x1, x2) under the key
    (k1, k2): 20 rounds with JAX's rotations and key schedule.  x1, x2
    are int64 tensors holding 32-bit words; so are the results (new
    tensors; the rounds run in place on them)."""
    ks = (k1 & MASK32, k2 & MASK32, (k1 ^ k2 ^ _PARITY) & MASK32)
    a = (x1 + ks[0]).bitwise_and_(MASK32)
    b = (x2 + ks[1]).bitwise_and_(MASK32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(MASK32)
            # b = rotl(b, r) ^ a
            b = (b << r).bitwise_or_(b >> (32 - r)).bitwise_and_(MASK32) \
                .bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        b.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK32)
    return a, b


def _hash_words(k1: int, k2: int, x1: int, x2: int) -> tuple[int, int]:
    """`threefry2x32` of one pair of counter words, in Python ints: the
    key operations are a handful of hashes, cheaper without tensors."""
    ks = (k1 & MASK32, k2 & MASK32, (k1 ^ k2 ^ _PARITY) & MASK32)
    a, b = (x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = (((b << r) | (b >> (32 - r))) & MASK32) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + i + 1) & MASK32
    return a, b


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """`jax.random.split(key, num)` under the partitionable threefry: key
    i is the hash of the counter words (hi(i), lo(i))."""
    return [_hash_words(key[0], key[1], i >> 32, i & MASK32)
            for i in range(num)]


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """`jax.random.fold_in(key, data)`: the hash of the counter words
    (0, data), data taken as a uint32."""
    return _hash_words(key[0], key[1], 0, int(data) & MASK32)


def fold_in_static(key: tuple[int, int], *data) -> tuple[int, int]:
    """Flax's `_fold_in_static(key, data)` (flax/core/scope.py): SHA-1 over
    the strings (UTF-8) and ints (big-endian, fewest bytes) of `data`
    with no separator (`flax_fix_rng_separator` off, Flax's default), its
    first 4 bytes big-endian folded in.  A module's k-th parameter is
    drawn from `fold_in_static(root, *module_path, k)`."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or string, got: {x!r}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


# ---------------------------------------------------------------------------
# the plain version of a draw
# ---------------------------------------------------------------------------

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


def _bits(key, bit_width: int, start: int, n: int, device) -> torch.Tensor:
    """Flat bits of elements start..start+n, int64 (the plain hash)."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    bits = b1 ^ b2
    return bits & ((1 << bit_width) - 1) if bit_width < 32 else bits


def _unit_floats(key, dtype, start, n, device) -> torch.Tensor:
    """Floats in [1, 2) from the top mantissa bits, as JAX's `_uniform`
    builds them."""
    if dtype == torch.float32:
        word = (_bits(key, 32, start, n, device) >> (32 - 23)) | 0x3F800000
        return word.to(torch.int32).view(torch.float32)
    word = (_bits(key, 8, start, n, device) >> (8 - 7)) | 0x3F80
    return word.to(torch.int16).view(torch.bfloat16)


def _scalar(value: float, dtype, device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def _plain_block(kind, key, width, dtype, start, n, device, lo, hi,
                 clip) -> torch.Tensor:
    """One block of `plain_draw`, flat."""
    if kind == BITS:
        return _bits(key, width, start, n, device)
    lo_t, hi_t = _scalar(lo, dtype, device), _scalar(hi, dtype, device)
    floats = _unit_floats(key, dtype, start, n, device) - 1.0
    if dtype == torch.float32:      # XLA fuses the scale into an FMA
        f64 = torch.float64
        scaled = (floats.to(f64) * (hi_t - lo_t).to(f64)
                  + lo_t.to(f64)).to(dtype)
    else:
        scaled = floats * (hi_t - lo_t) + lo_t
    u = torch.maximum(lo_t, scaled)
    if kind == UNIFORM:
        return u
    e = erf_inv(u.to(torch.float32)).to(dtype)
    out = e * _scalar(_SQRT2, dtype, device)
    if kind == TRUNCATED:
        out = torch.clamp(out, _scalar(clip[0], dtype, device),
                          _scalar(clip[1], dtype, device))
    return out


def plain_draw(kind: int, key, shape, dtype=torch.float32, start: int = 0,
               device=None, width: int = 32, lo: float = 0.0,
               hi: float = 1.0, clip=None) -> torch.Tensor:
    """The plain PyTorch version of `draw` (same arguments), on any
    device: the CPU path, and the card kernel's yardstick."""
    n = math.prod(shape)
    out_dtype = torch.int64 if kind == BITS else dtype
    if n <= _BLOCK:
        flat = _plain_block(kind, key, width, dtype, start, n, device, lo,
                            hi, clip)
    else:
        flat = torch.empty(n, dtype=out_dtype, device=device)
        for at in range(0, n, _BLOCK):
            m = min(_BLOCK, n - at)
            flat[at:at + m] = _plain_block(kind, key, width, dtype,
                                           start + at, m, device, lo, hi,
                                           clip)
    return flat.reshape(tuple(shape))


# ---------------------------------------------------------------------------
# the draw: the kernel on the card, the plain version on the CPU
# ---------------------------------------------------------------------------

def draw(kind: int, key, shape, dtype=torch.float32, start: int = 0,
         device=None, width: int = 32, lo: float = 0.0, hi: float = 1.0,
         clip=None) -> torch.Tensor:
    """One draw of `shape` from flat index `start` under `key`: `kind`
    BITS (int64 values of `width` 8, 16 or 32 bits), UNIFORM on [lo, hi),
    NORMAL (lo, hi the uniform's bounds) or TRUNCATED (the normal of a
    uniform on [lo, hi), clamped to `clip`), float32 or bfloat16.  The
    bounds are values of `dtype`.  On a CUDA device it launches
    csrc/threefry.cu or raises; on the CPU it runs `plain_draw`."""
    if kind not in (BITS, UNIFORM, NORMAL, TRUNCATED):
        raise ValueError(f"kind={kind}: BITS, UNIFORM, NORMAL or TRUNCATED")
    if kind == BITS and width not in (8, 16, 32):
        raise ValueError(f"bit_width={width}: 8, 16 or 32")
    if kind != BITS and dtype not in _FLOATS:
        raise ValueError(f"dtype={dtype}: float32 or bfloat16")
    if kind == TRUNCATED and clip is None:
        raise ValueError("a truncated draw needs its clip bounds")
    dev = torch.device(device if device is not None else "cpu")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if cuda_build.use_plain(dev):
        return plain_draw(kind, key, shape, dtype, start, dev, width, lo, hi,
                          clip)
    n = math.prod(shape)
    if start < 0 or start + n > 1 << 63:
        raise ValueError(f"flat indices {start}..{start + n} out of range")
    out = torch.empty(tuple(shape), device=dev,
                      dtype=torch.int64 if kind == BITS else dtype)
    if n == 0:
        return out
    code = (0 if kind == BITS else 1 if dtype == torch.float32 else 2)
    c_lo, c_hi = clip if clip is not None else (0.0, 0.0)
    with torch.cuda.device(dev):
        err = _library().threefry_draw_launch(
            kind, code, width, key[0] & MASK32, key[1] & MASK32, start, n,
            lo, hi, c_lo, c_hi, out.data_ptr(), cuda_build.stream_of(dev))
    cuda_build.launched("threefry_draw", err)
    return out


def _round(value: float, dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def random_bits(key: tuple[int, int], bit_width: int, shape,
                start: int = 0, device=None) -> torch.Tensor:
    """`jax.random.bits(key, shape)` at `bit_width` (8, 16 or 32) under
    the partitionable threefry, from flat index `start`: an int64 tensor
    of the unsigned values."""
    return draw(BITS, key, shape, start=start, device=device,
                width=bit_width)


def uniform(key, shape, dtype=torch.float32, minval: float = 0.0,
            maxval: float = 1.0, start: int = 0, device=None
            ) -> torch.Tensor:
    """`jax.random.uniform(key, shape, dtype, minval, maxval)`: the unit
    floats less 1, scaled and shifted in `dtype`, and held at minval."""
    return draw(UNIFORM, key, shape, dtype, start, device,
                lo=_round(minval, dtype), hi=_round(maxval, dtype))


def normal(key, shape, dtype=torch.float32, start: int = 0,
           device=None) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype)` in float32 or bfloat16:
    sqrt(2) * erf_inv(u) of u uniform on [nextafter(-1, 0), 1) in
    `dtype`, with `erf_inv` in float32 and its result and sqrt(2) rounded
    to `dtype` before the product."""
    if dtype not in _FLOATS:
        raise ValueError(f"dtype={dtype}: float32 or bfloat16")
    return draw(NORMAL, key, shape, dtype, start, device,
                lo=_NORMAL_LOW[dtype], hi=1.0)


def truncated_normal(key, lower: float, upper: float, shape,
                     dtype=torch.float32, start: int = 0,
                     device=None) -> torch.Tensor:
    """`jax.random.truncated_normal(key, lower, upper, shape, dtype)`:
    u uniform on [erf(lower / sqrt 2), erf(upper / sqrt 2)) in `dtype`,
    sqrt(2) * erf_inv(u) as `normal` computes it, clamped to
    [nextafter(lower, inf), nextafter(upper, -inf)]."""
    lower_t = torch.tensor(lower, dtype=dtype)
    upper_t = torch.tensor(upper, dtype=dtype)
    sqrt2 = torch.tensor(_SQRT2, dtype=dtype)
    a = _round(math.erf(float(lower_t / sqrt2)), dtype)
    b = _round(math.erf(float(upper_t / sqrt2)), dtype)
    inf = torch.tensor(math.inf, dtype=dtype)
    clip = (float(torch.nextafter(lower_t, inf)),
            float(torch.nextafter(upper_t, -inf)))
    return draw(TRUNCATED, key, shape, dtype, start, device, lo=a, hi=b,
                clip=clip)


def permutation(key: tuple[int, int], n: int, device=None) -> torch.Tensor:
    """`jax.random.permutation(key, n)`: JAX's `_shuffle` of arange(n),
    int64 on `device`."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        sort_keys = random_bits(sub, 32, (n,), device=device)
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x


def choice(key: tuple[int, int], n: int, k: int, device=None
           ) -> torch.Tensor:
    """`jax.random.choice(key, n, (k,), replace=False)`: the first k
    entries of `permutation(key, n)`."""
    if k > n:
        raise ValueError(f"cannot take a larger sample (size {k}) than the "
                         f"population (size {n}) without replacement")
    return permutation(key, n, device)[:k]
