"""Gaussian-mixture pose prior: the log-likelihood of flattened windows.

Counterpart of `globalegomocap_tpu/ops/gmm.py`: a pickled sklearn
`GaussianMixture` ('full' or 'diag' covariances) as tensors on one
device, scored in sklearn's formulation (`_estimate_log_gaussian_prob`
through the Cholesky factors of the precisions).  `score_samples` plugs
into `energy/terms.py::total_energy_from_pose(gmm_score_fn=...)` as
`functools.partial(score_samples, params)`.

`include_weights=True` (the default) adds the mixture's log-weights, as
sklearn does; the reference's scorer leaves them out, which agrees with
sklearn only for one component (`include_weights=False` reproduces it).
The JAX package lowers these through XLA, so they are plain torch here.
"""

from __future__ import annotations

import importlib
import math
import pickle
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class GMMParams:
    """Mixture parameters as float32 tensors on one device."""
    means: torch.Tensor                # (K, D)
    precisions_cholesky: torch.Tensor  # full: (K, D, D); diag: (K, D)
    log_weights: torch.Tensor          # (K,)
    covariance_type: str = "full"

    def to(self, device) -> "GMMParams":
        return GMMParams(self.means.to(device),
                         self.precisions_cholesky.to(device),
                         self.log_weights.to(device), self.covariance_type)


def from_sklearn(gmm, device=None) -> GMMParams:
    """From a fitted or unpickled sklearn GaussianMixture, or any object
    with its attributes `means_`, `precisions_cholesky_`, `weights_` and
    `covariance_type` ('full' or 'diag'), on `device` (the host when None,
    as the camera's parameters: move them with `.to`)."""
    if gmm.covariance_type not in ("full", "diag"):
        raise ValueError(f"covariance_type={gmm.covariance_type!r}: 'full' "
                         "or 'diag'")
    f32 = lambda v: torch.as_tensor(  # noqa: E731
        np.asarray(v, dtype=np.float32), device=device)
    return GMMParams(means=f32(gmm.means_),
                     precisions_cholesky=f32(gmm.precisions_cholesky_),
                     log_weights=f32(np.log(gmm.weights_)),
                     covariance_type=gmm.covariance_type)


class _GaussianMixtureState:
    """An unpickled sklearn GaussianMixture: its attributes, no sklearn."""


_GAUSSIAN_MIXTURE = {("sklearn.mixture._gaussian_mixture", "GaussianMixture"),
                     ("sklearn.mixture.gaussian_mixture", "GaussianMixture")}


class _RandomStateRecord:
    """numpy's random state in a GMM pickle (a mixture fitted with
    `random_state=np.random.RandomState(...)` keeps it), and the bit
    generator and seed sequence inside it: the constructor's arguments
    and the state, as read.  numpy's own constructors never run; scoring
    never draws."""

    def __init__(self, *args):
        self.args = args

    def __setstate__(self, state):
        self.state = state


# the names numpy's random states pickle under: numpy >= 1.17's
# constructors, bit generators and seed sequence, numpy < 1.17's one
_NUMPY_RANDOM = {
    ("numpy.random._pickle", "__randomstate_ctor"),
    ("numpy.random._pickle", "__generator_ctor"),
    ("numpy.random._pickle", "__bit_generator_ctor"),
    ("numpy.random._mt19937", "MT19937"),
    ("numpy.random._pcg64", "PCG64"),
    ("numpy.random._pcg64", "PCG64DXSM"),
    ("numpy.random._philox", "Philox"),
    ("numpy.random._sfc64", "SFC64"),
    ("numpy.random.bit_generator", "SeedSequence"),
    ("numpy.random.bit_generator", "__pyx_unpickle_SeedSequence"),
    ("numpy.random", "__RandomState_ctor"),
}


class _MixtureUnpickler(pickle.Unpickler):
    """Reads a pickled GaussianMixture without importing sklearn: its class
    becomes an attribute holder, numpy's random state a record; numpy's
    array reconstructors load from `numpy._core` or `numpy.core`,
    whichever this numpy has (numpy 2 pickles name the first, numpy 1 the
    second); any other name raises, naming it."""

    def find_class(self, module, name):
        if (module, name) in _GAUSSIAN_MIXTURE:
            return _GaussianMixtureState
        if (module, name) in _NUMPY_RANDOM:
            return _RandomStateRecord
        if module == "numpy" and name in ("ndarray", "dtype"):
            return getattr(np, name)
        parts = module.split(".")
        if parts[:2] in (["numpy", "_core"], ["numpy", "core"]):
            for base in ("numpy._core", "numpy.core"):
                try:
                    mod = importlib.import_module(".".join([base] + parts[2:]))
                except ImportError:
                    continue
                return getattr(mod, name)
        raise pickle.UnpicklingError(
            f"{module}.{name}: a GMM pickle holds only an sklearn "
            "GaussianMixture, numpy arrays and numpy's random state")


def load_sklearn_pickle(path: str, device=None) -> GMMParams:
    """A pickled sklearn GaussianMixture ('full' or 'diag'), read without
    sklearn.  Unpickle only files this program or its users wrote: the
    reader admits no class but the mixture, numpy's arrays and numpy's
    random state (kept as a record, never rebuilt)."""
    with open(path, "rb") as f:
        return from_sklearn(_MixtureUnpickler(f).load(), device)


def _log_det_cholesky(params: GMMParams) -> torch.Tensor:
    chol = params.precisions_cholesky
    if params.covariance_type == "full":
        chol = torch.diagonal(chol, dim1=-2, dim2=-1)
    return torch.log(chol).sum(-1)


def log_prob_components(params: GMMParams, X: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N, K) log densities of each component."""
    d = X.shape[-1]
    log_det = _log_det_cholesky(params)
    if params.covariance_type == "full":
        # y_k = X L_k - mu_k L_k, in the JAX package's order
        chol = params.precisions_cholesky
        y = torch.einsum("nd,kde->nke", X, chol) - \
            torch.einsum("kd,kde->ke", params.means, chol)[None]
        maha = y.square().sum(-1)
    else:
        # the expanded square, as the JAX package (and sklearn) forms it:
        # it cancels at large |X|, and is kept so that both agree
        prec = params.precisions_cholesky.square()           # (K, D)
        maha = ((params.means.square() * prec).sum(1)[None]
                - 2.0 * X @ (params.means * prec).T
                + X.square() @ prec.T)
    return -0.5 * (d * math.log(2 * math.pi) + maha) + log_det


def score_samples(params: GMMParams, X: torch.Tensor,
                  include_weights: bool = True) -> torch.Tensor:
    """(N, D) -> (N,) log p(x) under the mixture."""
    lp = log_prob_components(params, X)
    if include_weights:
        lp = lp + params.log_weights[None]
    return torch.logsumexp(lp, dim=1)
