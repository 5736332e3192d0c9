"""The port's threefry stream (`ops/random.py`) against `jax.random` on
the CPU: the keys, the hash, the bits, the uniforms and the normals at
the shapes the sample init draws, up to serve's (192, 2048).

Tolerances: keys, bits and uniforms exact; bfloat16 normals exact;
float32 normals within 1e-6 absolute (measured 4.77e-7 at (192, 2048),
3,632 of 393,216 values off by one or two float32 steps: XLA's log1p
and its fused Horner steps round differently from torch's in the
tails).  `torch.erfinv` would stray by 2.2e-5 there, which the last
test shows."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from globalegomocap_tpu_torch.ops import random as R

SEEDS = [0, 7, 2**31 - 1, -3]
# every seed at two small shapes, and serve's (192, 2048) at two seeds
CASES = ([(s, shape) for s in SEEDS for shape in ((5,), (3, 7))]
         + [(7, (192, 2048)), (-3, (192, 2048))])
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, -1, -5, 2**31,
                                  2**32 + 3, 2**40, -2**31])
def test_prng_key_matches_jax(seed):
    """PRNGKey's two words with 64-bit types off: the seed modulo 2**32
    in the low word, for negative seeds and seeds of 2**31 and above."""
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert R.prng_key(seed) == tuple(int(w) for w in want)


def test_threefry_known_answer():
    """The Random123 known-answer vector that JAX's own tests use."""
    x1, x2 = R.threefry2x32(0x13198A2E, 0x03707344,
                            torch.tensor([0x243F6A88], dtype=torch.int64),
                            torch.tensor([0x85A308D3], dtype=torch.int64))
    assert (int(x1), int(x2)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed,shape", CASES)
def test_bits_match_jax(seed, shape):
    """32-, 16- and 8-bit words equal jax.random.bits exactly."""
    key = jax.random.PRNGKey(seed)
    for width, dt in ((32, jnp.uint32), (16, jnp.uint16), (8, jnp.uint8)):
        want = np.asarray(jax.random.bits(key, shape, dt)).astype(np.int64)
        got = R.random_bits(R.prng_key(seed), width, shape)
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(width))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, jdt, tdt):
    """Uniforms on [0, 1) and on the normal's [nextafter(-1, 0), 1)
    equal JAX's exactly; bfloat16 draws 8 bits, so it is its own stream
    and not the float32 draw rounded."""
    key = jax.random.PRNGKey(seed)
    lo = float(np.nextafter(np.array(-1.0, jdt), np.array(0.0, jdt)))
    for minval, maxval in ((0.0, 1.0), (lo, 1.0)):
        want = _np(jax.random.uniform(key, (192, 2048), jdt, minval, maxval))
        got = R.uniform(R.prng_key(seed), (192, 2048), tdt, minval, maxval)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)
    f32 = R.uniform(R.prng_key(seed), (64,), torch.float32)
    b16 = R.uniform(R.prng_key(seed), (64,), torch.bfloat16)
    assert not torch.equal(f32.to(torch.bfloat16), b16)


@pytest.mark.parametrize("seed,shape", CASES)
def test_normal_matches_jax(seed, shape):
    """float32 within 1e-6, bfloat16 exactly (PRNGKey(3)'s two bf16
    draws are JAX's [-0.01465, 0.7305], far from its float32 ones)."""
    key = jax.random.PRNGKey(seed)
    want = _np(jax.random.normal(key, shape, jnp.float32))
    got = R.normal(R.prng_key(seed), shape, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    want = _np(jax.random.normal(key, shape, jnp.bfloat16))
    got = R.normal(R.prng_key(seed), shape, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    pair = R.normal(R.prng_key(3), (2,), torch.bfloat16).float().tolist()
    assert pair == _np(jax.random.normal(jax.random.PRNGKey(3), (2,),
                                         jnp.bfloat16)).tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_start_draws_rows_of_the_global_draw(dtype):
    """A draw from `start` is the matching slice of the draw of the
    whole shape: bits and normals, at row offsets that split 12 rows
    over 2 and 3 ranks."""
    key = R.prng_key(7)
    whole = R.normal(key, (12, 32), dtype)
    bits = R.random_bits(key, 32, (12, 32))
    for ranks in (2, 3):
        per = 12 // ranks
        for r in range(ranks):
            part = R.normal(key, (per, 32), dtype, start=r * per * 32)
            torch.testing.assert_close(part, whole[r * per:(r + 1) * per],
                                       rtol=0, atol=0)
            torch.testing.assert_close(
                R.random_bits(key, 32, (per, 32), start=r * per * 32),
                bits[r * per:(r + 1) * per], rtol=0, atol=0)


def test_erf_inv_is_closer_to_jax_than_torch_erfinv():
    """The choice of erf_inv, measured: on JAX's own float32 uniforms at
    (192, 2048) XLA's polynomial as written here stays within 4.8e-7 of
    jax.scipy.special.erfinv, torch.erfinv strays by more than 1e-5."""
    key = jax.random.PRNGKey(7)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = jax.random.uniform(key, (192, 2048), jnp.float32, lo, 1.0)
    want = np.asarray(jax.scipy.special.erfinv(u))
    ut = torch.from_numpy(np.array(u))
    poly = np.abs(R.erf_inv(ut).numpy() - want).max()
    lib = np.abs(torch.erfinv(ut).numpy() - want).max()
    assert poly <= 5e-7 < 1e-5 < lib, (poly, lib)
    assert R.erf_inv(torch.tensor([1.0, -1.0])).tolist() == [
        torch.finfo(torch.float32).max, -torch.finfo(torch.float32).max]
    assert math.isclose(float(R.erf_inv(torch.tensor(0.5))),
                        0.4769362762044699, rel_tol=1e-6)
