"""The port's GMM pose prior (`ops/gmm.py`) against the JAX package's and
sklearn's: GaussianMixture fits with 'full' and 'diag' covariances on
flattened 4-frame pose windows (D = 180), pickled and loaded through both
packages; `log_prob_components` and `score_samples` against JAX (1e-5) and
sklearn's float64 score (1e-4), with and without the mixture weights;
`from_sklearn` on a plain object with sklearn's attributes; and
`score_samples` as `gmm_score_fn` in `total_energy_from_pose`, whose
value (1e-5) and dE/dpose (1e-4 of the largest entry) are held against
JAX scoring each window as one (1, T*45) row.

The tolerances are relative to the size of the terms a log density
sums, not to the density: a density of about 200 is the difference of
log|L| and 0.5 * Mahalanobis terms of several hundred, and for 'diag'
the Mahalanobis term is JAX's (and sklearn's) expansion
mu^2 prec - 2 x (mu prec) + x^2 prec, whose terms reach 1e6 on poses a
metre from the origin with precisions of 1e4 and cancel to a few
hundred.  Both packages keep that expansion, so float32 rounding of the
terms, not of the result, sets what they can agree to."""

import functools
import pickle
import types
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.energy import terms as jterms
from globalegomocap_tpu.ops import fisheye as jfish
from globalegomocap_tpu.ops import gmm as jgmm
from globalegomocap_tpu_torch.data.synthetic import synthetic_motion
from globalegomocap_tpu_torch.energy import terms as tterms
from globalegomocap_tpu_torch.ops import fisheye as tfish
from globalegomocap_tpu_torch.ops import gmm as tgmm
from globalegomocap_tpu_torch.ops.skeleton import mean_bone_lengths

sklearn_mixture = pytest.importorskip("sklearn.mixture")

T = 4
D = T * 45


def _term_scale(gm, x):
    """(N, K) magnitude of the terms each component's log density sums,
    in float64: |log det| + 0.5 D log(2 pi) + 0.5 times the Mahalanobis
    term's largest partial sum (for 'diag' its three expanded terms)."""
    x = np.asarray(x, np.float64)
    chol = gm.precisions_cholesky_
    if gm.covariance_type == "full":
        log_det = np.log(np.diagonal(chol, axis1=1, axis2=2)).sum(-1)
        y = np.einsum("nd,kde->nke", x, chol) - np.einsum(
            "kd,kde->ke", gm.means_, chol)[None]
        maha = (y ** 2).sum(-1)
    else:
        log_det = np.log(chol).sum(-1)
        prec = chol ** 2
        maha = ((gm.means_ ** 2 * prec).sum(1)[None]
                + 2 * np.abs(x @ (gm.means_ * prec).T) + x ** 2 @ prec.T)
    return np.abs(log_det)[None] + 0.5 * D * np.log(2 * np.pi) + 0.5 * maha


def _close(got, want, scale, rtol, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= rtol * scale).all(), (what, float((err / scale).max()))


def _windows(n, seed):
    motion = synthetic_motion(n + T, seed, motion_scale=0.08)
    rng = np.random.default_rng(seed)
    w = np.stack([motion[i:i + T] for i in range(n)])
    return (w + rng.normal(scale=0.01, size=w.shape)).astype(np.float32)


@pytest.fixture(scope="module", params=["full", "diag"])
def fitted(request, tmp_path_factory):
    """A 3-component fit, its pickle, and the pickle loaded through both
    packages."""
    data = _windows(600, 0).reshape(600, D).astype(np.float64)
    gm = sklearn_mixture.GaussianMixture(
        n_components=3, covariance_type=request.param, max_iter=20,
        reg_covar=1e-4, random_state=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gm.fit(data)
    path = tmp_path_factory.mktemp("gmm") / f"{request.param}.pkl"
    with open(path, "wb") as f:
        pickle.dump(gm, f)
    return (gm, tgmm.load_sklearn_pickle(str(path)),
            jgmm.load_sklearn_pickle(str(path)))


def test_params_are_tensors_on_one_device(fitted):
    gm, tp, _ = fitted
    assert tp.covariance_type == gm.covariance_type
    assert tp.means.dtype == torch.float32 and tp.means.shape == (3, D)
    moved = tp.to("cpu")
    assert moved.log_weights.device.type == "cpu"
    np.testing.assert_array_equal(moved.log_weights.numpy(),
                                  np.log(gm.weights_).astype(np.float32))


@pytest.mark.parametrize("include_weights", [True, False])
def test_scores_match_jax_and_sklearn(fitted, include_weights):
    gm, tp, jp = fitted
    x = _windows(50, 7).reshape(50, D)
    scale = _term_scale(gm, x)                         # (N, K)
    got_c = tgmm.log_prob_components(tp, torch.from_numpy(x)).numpy()
    want_c = np.asarray(jgmm.log_prob_components(jp, jnp.asarray(x)))
    _close(got_c, want_c, scale, 1e-5, "components")
    got = tgmm.score_samples(tp, torch.from_numpy(x),
                             include_weights).numpy()
    want = np.asarray(jgmm.score_samples(jp, jnp.asarray(x),
                                         include_weights))
    _close(got, want, scale.max(1), 1e-5, "score")
    if include_weights:
        _close(got, gm.score_samples(x.astype(np.float64)), scale.max(1),
               1e-4, "sklearn")


def test_from_sklearn_needs_only_the_attributes(fitted):
    gm, tp, _ = fitted
    plain = types.SimpleNamespace(
        means_=gm.means_, precisions_cholesky_=gm.precisions_cholesky_,
        weights_=gm.weights_, covariance_type=gm.covariance_type)
    x = torch.from_numpy(_windows(5, 9).reshape(5, D))
    np.testing.assert_array_equal(
        tgmm.score_samples(tgmm.from_sklearn(plain), x).numpy(),
        tgmm.score_samples(tp, x).numpy())
    with pytest.raises(ValueError, match="covariance_type"):
        tgmm.from_sklearn(types.SimpleNamespace(
            **dict(vars(plain), covariance_type="tied")))


def test_as_the_energy_prior_term(fitted):
    """The GMM term inside total_energy_from_pose (weight 0.05, no
    reprojection): the port's (B,) energies of B windows scored as (B,
    T*45) rows against JAX's per-window energies, which score each window
    as a (1, T*45) row; gradients by autograd and jax.grad."""
    gm, tp, jp = fitted
    pose = _windows(6, 11)
    scale = 0.05 * _term_scale(gm, pose.reshape(6, D)).max(1)
    init = pose + np.float32(0.01)
    bl = mean_bone_lengths(torch.from_numpy(init)).numpy()
    heat = np.zeros((T, 15, 8, 8), np.float32)
    tw = tterms.EnergyWeights.create(gmm=0.05)
    jw = jterms.EnergyWeights.create(gmm=0.05)
    x = torch.from_numpy(pose).requires_grad_(True)
    e_t = tterms.total_energy_from_pose(
        x, torch.from_numpy(init), torch.from_numpy(bl), None,
        tfish.default_camera("egosyn"), tw, False,
        gmm_score_fn=functools.partial(tgmm.score_samples, tp))
    e_t.sum().backward()
    e_t = e_t.detach()
    jcam = jfish.default_camera("egosyn")
    score = functools.partial(jgmm.score_samples, jp)
    one = jax.value_and_grad(lambda p, i, b: jterms.total_energy_from_pose(
        p, i, b, jnp.asarray(heat), jcam, jw, False, gmm_score_fn=score))
    e_j, g_j = (np.asarray(a) for a in jax.jit(jax.vmap(one))(
        jnp.asarray(pose), jnp.asarray(init), jnp.asarray(bl)))
    for i in range(pose.shape[0]):
        _close(float(e_t[i]), float(e_j[i]), abs(float(e_j[i])) + scale[i],
               1e-5, "energy")
        np.testing.assert_allclose(x.grad[i].numpy(), g_j[i], rtol=0,
                                   atol=1e-4 * np.abs(g_j[i]).max())
