"""The port's 17-metric suite and Umeyama alignment against the JAX
package (rtol 1e-4, atol 1e-6: the tolerance of test_golden.py:81)."""

import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from globalegomocap_tpu.evaluation import metrics as jm
from globalegomocap_tpu.ops import skeleton as jskel
from globalegomocap_tpu_torch.evaluation import metrics as tm
from globalegomocap_tpu_torch.ops import umeyama as tu

# the JAX package's ops/__init__ re-exports a function of this name
ju = importlib.import_module("globalegomocap_tpu.ops.umeyama")
TOL = dict(rtol=1e-4, atol=1e-6)


def _seqs(c, n, seed):
    rng = np.random.default_rng(seed)
    base = (jskel.MEAN3D_MM.T / 1000.0).astype(np.float32)
    gt = base + rng.normal(scale=0.05, size=(c, n, 15, 3))
    gt = gt + np.cumsum(rng.normal(scale=0.01, size=(c, n, 1, 3)), axis=1)
    out = [gt + rng.normal(scale=s, size=gt.shape) for s in (0.03, 0.02,
                                                             0.01)]
    return [x.astype(np.float32) for x in out + [gt]]


def test_metric_keys():
    assert tm.METRIC_KEYS == jm.METRIC_KEYS


def test_calculate_errors_matches_jax_batched_over_chunks():
    est, mid, opt, gt = _seqs(3, 26, seed=0)
    got = tm.calculate_errors(*(torch.from_numpy(x)
                                for x in (est, mid, opt, gt)))
    assert set(got) == set(jm.METRIC_KEYS)
    for c in range(3):
        ref = jm.calculate_errors(*(jnp.asarray(x[c])
                                    for x in (est, mid, opt, gt)))
        for key in jm.METRIC_KEYS:
            np.testing.assert_allclose(got[key][c].numpy(),
                                       np.asarray(ref[key]), **TOL,
                                       err_msg=key)


@pytest.mark.parametrize("reflect", [False, True])
def test_umeyama_matches_jax(reflect):
    """Including a reflected target, where the sign rule flips the last
    singular direction to keep R a rotation."""
    rng = np.random.default_rng(3)
    p = rng.normal(size=(4, 15, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if reflect:
        q[:, 0] *= -1.0
    target = (1.3 * p @ q + rng.normal(size=3)).astype(np.float32)
    c_t, r_t, t_t = tu.umeyama(torch.from_numpy(p),
                               torch.from_numpy(target))
    c_j, r_j, t_j = ju.umeyama(jnp.asarray(p), jnp.asarray(target))
    for a, b in ((c_t, c_j), (r_t, r_j), (t_t, t_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    assert np.allclose(np.linalg.det(r_t.numpy()), 1.0, atol=1e-4)
    np.testing.assert_allclose(
        tu.umeyama_align(torch.from_numpy(p),
                         torch.from_numpy(target)).numpy(),
        np.asarray(ju.umeyama_align(jnp.asarray(p), jnp.asarray(target))),
        rtol=1e-4, atol=1e-5)
