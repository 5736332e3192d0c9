"""The port's threefry streams (`ops/random.py`) against `jax.random`
and Flax on the CPU: the keys (`PRNGKey`, `split`, `fold_in`, Flax's
static fold), the hash, the bits, the uniforms, the normals and the
truncated normals at the shapes the port draws, up to serve's (192,
2048), and `permutation` / `choice` without replacement.

Tolerances: keys, bits, uniforms, permutations and index sets exact;
bfloat16 normals and truncated normals exact; float32 normals within
1e-6 absolute (measured 4.77e-7 at (192, 2048), 3,632 of 393,216 values
off by one or two float32 steps: XLA's log1p and its fused Horner steps
round differently from torch's in the tails), float32 truncated normals
within 4.8e-7 (measured 2.4e-7 at (-2, 2), 4.8e-7 at (-1, 3)).
`torch.erfinv` would stray by 2.2e-5 there, which the last test
shows."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static

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


def _words(key) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_match_jax(seed):
    """split into 1, 2 and 5 keys and fold_in of steps, large words and
    2**32 - 1: JAX's keys exactly; a fold of a split key too."""
    key = jax.random.PRNGKey(seed)
    for num in (1, 2, 5):
        want = [tuple(int(w) for w in k) for k in
                np.asarray(jax.random.key_data(jax.random.split(key, num)))]
        assert R.split(R.prng_key(seed), num) == want
    for data in (0, 1, 3, 2**31 + 7, 2**32 - 1):
        assert R.fold_in(R.prng_key(seed), data) == _words(
            jax.random.fold_in(key, np.uint32(data)))
    sub = jax.random.split(jax.random.fold_in(key, 4))[1]
    assert R.fold_in(R.split(R.fold_in(R.prng_key(seed), 4))[1], 9) == \
        _words(jax.random.fold_in(sub, 9))


@pytest.mark.parametrize("data", [
    ("enc_0", "conv", 1), ("fc_mu", 2), ("local", "dec_1", "bn", 1),
    ("global", "final_conv", 1), ("a", 300), (0,), ("params",)])
def test_fold_in_static_matches_flax(data):
    """Flax's `_fold_in_static` (SHA-1 of the path and the counter, no
    separator): the same key, for strings, ints of one and two bytes and
    0 (no bytes)."""
    for seed in (0, 7):
        assert R.fold_in_static(R.prng_key(seed), *data) == _words(
            _fold_in_static(jax.random.PRNGKey(seed), data))
    assert R.fold_in_static(R.prng_key(3)) == R.prng_key(3)


@pytest.mark.parametrize("n", [1, 4, 60, 1625, 1700, 100000])
def test_permutation_and_choice_match_jax(n):
    """permutation(key, n) exactly, with one sort round up to n = 1625 and
    two from 1626 on; choice without replacement its first entries, and
    vmapped over split keys as `umeyama_ransac` draws it."""
    for seed in (0, -3):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            R.permutation(R.prng_key(seed), n).numpy(),
            np.asarray(jax.random.permutation(key, n)))
        k = min(n, 4)
        np.testing.assert_array_equal(
            R.choice(R.prng_key(seed), n, k).numpy(),
            np.asarray(jax.random.choice(key, n, (k,), replace=False)))
    if n == 60:
        keys = jax.random.split(jax.random.PRNGKey(2), 80)
        want = jax.vmap(lambda kk: jax.random.choice(
            kk, 60, (4,), replace=False))(keys)
        got = torch.stack([R.choice(kk, 60, 4)
                           for kk in R.split(R.prng_key(2), 80)])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="larger sample"):
        R.choice(R.prng_key(0), 3, 4)


@pytest.mark.parametrize("lower,upper", [(-2.0, 2.0), (-1.0, 3.0)])
@pytest.mark.parametrize("seed", [0, 7, -3])
def test_truncated_normal_matches_jax(seed, lower, upper):
    """truncated_normal at (192, 2048): float32 within 4.8e-7, bfloat16
    exactly, inside the open interval; a draw from `start` the rows of
    the whole."""
    key = jax.random.PRNGKey(seed)
    want = _np(jax.random.truncated_normal(key, lower, upper, (192, 2048),
                                           jnp.float32))
    got = R.truncated_normal(R.prng_key(seed), lower, upper, (192, 2048))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4.8e-7)
    assert float(got.min()) > lower and float(got.max()) < upper
    want = _np(jax.random.truncated_normal(key, lower, upper, (192, 2048),
                                           jnp.bfloat16))
    got = R.truncated_normal(R.prng_key(seed), lower, upper, (192, 2048),
                             torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)
    part = R.truncated_normal(R.prng_key(seed), lower, upper, (2, 2048),
                              start=5 * 2048)
    torch.testing.assert_close(part, R.truncated_normal(
        R.prng_key(seed), lower, upper, (7, 2048))[5:], rtol=0, atol=0)


def test_large_draws_run_in_blocks():
    """A draw of more than one plain-version block equals the draw of
    its pieces, each from its own start."""
    n = 3 * R._BLOCK + 11
    whole = R.normal(R.prng_key(5), (n,))
    assert torch.equal(whole[R._BLOCK - 3:R._BLOCK + 5],
                       R.normal(R.prng_key(5), (8,), start=R._BLOCK - 3))
    assert torch.equal(R.random_bits(R.prng_key(5), 8, (n,))[-4:],
                       R.random_bits(R.prng_key(5), 8, (4,), start=n - 4))
