"""Umeyama similarity alignment (scale + rotation + translation), batched.

Counterpart of `globalegomocap_tpu/ops/umeyama.py`: returns (c, R, t)
with the reference's convention Q ~ P @ R * c + t and its SVD sign-flip
rule, over arbitrary leading axes as one batched SVD.
"""

from __future__ import annotations

import torch


def umeyama(P: torch.Tensor, Q: torch.Tensor):
    """Least-squares similarity transform aligning P onto Q.
    P, Q: (..., n, d).  Returns (c (...,), R (..., d, d), t (..., d))."""
    n = P.shape[-2]
    muP = P.mean(-2, keepdim=True)
    muQ = Q.mean(-2, keepdim=True)
    C = torch.matmul((P - muP).transpose(-1, -2), Q - muQ) / n
    V, S, W = torch.linalg.svd(C)
    # keep R a proper rotation: flip the last singular direction when the
    # determinant product is negative
    flip = (torch.linalg.det(V) * torch.linalg.det(W)) < 0.0
    sign = torch.where(flip, -1.0, 1.0).to(P.dtype)
    S = torch.cat([S[..., :-1], S[..., -1:] * sign[..., None]], dim=-1)
    V = torch.cat([V[..., :, :-1], V[..., :, -1:] * sign[..., None, None]],
                  dim=-1)
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
