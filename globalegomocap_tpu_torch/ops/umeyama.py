"""Umeyama similarity alignment (scale + rotation + translation), batched.

Counterpart of `globalegomocap_tpu/ops/umeyama.py`: returns (c, R, t)
with the reference's convention Q ~ P @ R * c + t and its SVD sign-flip
rule, over arbitrary leading axes as one batched SVD; and the
reference's variants: the scale alone, the fit about the origin, and
RANSAC.
"""

from __future__ import annotations

import torch

from globalegomocap_tpu_torch.ops.random import choice, prng_key, split


def _proper_svd(C: torch.Tensor):
    """(V, S, W) of C = V diag(S) W, the last singular direction flipped
    where det(V) det(W) < 0, so that V W is a proper rotation."""
    V, S, W = torch.linalg.svd(C)
    flip = (torch.linalg.det(V) * torch.linalg.det(W)) < 0.0
    sign = torch.where(flip, -1.0, 1.0).to(C.dtype)
    S = torch.cat([S[..., :-1], S[..., -1:] * sign[..., None]], dim=-1)
    V = torch.cat([V[..., :, :-1], V[..., :, -1:] * sign[..., None, None]],
                  dim=-1)
    return V, S, W


def umeyama(P: torch.Tensor, Q: torch.Tensor):
    """Least-squares similarity transform aligning P onto Q.
    P, Q: (..., n, d).  Returns (c (...,), R (..., d, d), t (..., d))."""
    n = P.shape[-2]
    muP = P.mean(-2, keepdim=True)
    muQ = Q.mean(-2, keepdim=True)
    V, S, W = _proper_svd(
        torch.matmul((P - muP).transpose(-1, -2), Q - muQ) / n)
    R = torch.matmul(V, W)
    varP = P.var(-2, correction=0).sum(-1)
    c = S.sum(-1) / varP
    t = muQ[..., 0, :] - torch.matmul(
        muP, c[..., None, None] * R)[..., 0, :]
    return c, R, t


def umeyama_align(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Align P onto Q and return the transformed points (..., n, d)."""
    c, R, t = umeyama(P, Q)
    return torch.matmul(P, R) * c[..., None, None] + t[..., None, :]


def umeyama_scale_only(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """P scaled by the Umeyama scale alone, no rotation or translation
    (the reference's `align_skeleton_size`)."""
    c, _, _ = umeyama(P, Q)
    return P * c[..., None, None]


def umeyama_no_centering(P: torch.Tensor, Q: torch.Tensor):
    """The reference's `umeyama_dim_2`: the rotation fit about the origin
    (an uncentred covariance) while the scale divides by the centred
    variance, so the scale is exact only for zero-mean clouds.
    Returns (c, R, t) as `umeyama`."""
    n = P.shape[-2]
    V, S, W = _proper_svd(torch.matmul(P.transpose(-1, -2), Q) / n)
    R = torch.matmul(V, W)
    varP = P.var(-2, correction=0).sum(-1)
    c = S.sum(-1) / varP
    t = Q.mean(-2) - torch.matmul(
        P.mean(-2)[..., None, :], c[..., None, None] * R)[..., 0, :]
    return c, R, t


def _ransac_fit(P: torch.Tensor, Q: torch.Tensor, idx: torch.Tensor,
                epsilon: float):
    """RANSAC from given hypotheses: P, Q (n, d), idx (n_iters, s) the
    correspondences of each minimal fit.  All fits run as one batched
    SVD; the hypothesis with the most inliers (residual < epsilon; the
    first on a tie) is refit on its inlier set by a masked Umeyama.
    Returns (c, R, t)."""
    Ps, Qs = P[idx], Q[idx]                          # (n_iters, s, d)
    c, R, t = umeyama(Ps, Qs)
    proj = torch.matmul(P.expand(len(idx), *P.shape), R) \
        * c[:, None, None] + t[:, None, :]
    inliers = torch.linalg.vector_norm(proj - Q[None], dim=-1) < epsilon
    best = torch.argmax(inliers.sum(-1))
    mask = inliers[best].to(P.dtype)[:, None]        # (n, 1)
    wsum = torch.clamp(mask.sum(), min=1.0)
    muP = (P * mask).sum(0) / wsum
    muQ = (Q * mask).sum(0) / wsum
    cP = (P - muP) * mask
    cQ = (Q - muQ) * mask
    V, S, W = _proper_svd(torch.matmul(cP.T, cQ) / wsum)
    Rb = torch.matmul(V, W)
    cb = S.sum() / ((cP * cP).sum() / wsum)
    return cb, Rb, muQ - torch.matmul(muP, cb * Rb)


def umeyama_ransac(P: torch.Tensor, Q: torch.Tensor, epsilon: float = 0.2,
                   n_iters: int = 80, sample_size: int = 4, seed: int = 0):
    """RANSAC-robust Umeyama of P onto Q, (n, d) each (the reference's
    rigid_transform_with_scale.py:72-93): `n_iters` fits on random
    minimal sets of `sample_size` distinct correspondences, the largest
    inlier set refit.  The sets are JAX's (`ransac_hypotheses`), drawn on
    P's device.  Returns (c, R, t)."""
    idx = ransac_hypotheses(P.shape[-2], n_iters, sample_size, seed,
                            P.device)
    return _ransac_fit(P, Q, idx, epsilon)


def ransac_hypotheses(n: int, n_iters: int, sample_size: int, seed: int,
                      device=None) -> torch.Tensor:
    """RANSAC's (n_iters, sample_size) index sets, JAX's
    `umeyama_ransac`'s: `choice(k, n, (sample_size,), replace=False)` of
    each key of `split(PRNGKey(seed), n_iters)` (`ops/random.py`)."""
    return torch.stack([choice(k, n, sample_size, device=device)
                        for k in split(prng_key(seed), n_iters)])
