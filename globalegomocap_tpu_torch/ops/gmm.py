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

import math
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


def load_sklearn_pickle(path: str, device=None) -> GMMParams:
    """A pickled sklearn GaussianMixture (unpickling needs sklearn)."""
    import pickle
    with open(path, "rb") as f:
        return from_sklearn(pickle.load(f), device)


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
