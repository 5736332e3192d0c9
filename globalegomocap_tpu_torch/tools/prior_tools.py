"""Prior introspection: sampling, latent interpolation, latent statistics.

Counterpart of `globalegomocap_tpu/tools/prior_tools.py` (the reference's
networks/sample.py, networks/interpolant.py:94-138 and
networks/get_latent.py) on the port's `models/conv_vae.py::ConvVAE`,
used in eval mode (BatchNorm on its running statistics) on the device of
its weights.  Sampling draws its N(0, I) latents as JAX's does,
`normal(PRNGKey(seed), (n, latent_dim))` (`ops/random.py`), on that
device: the same motions as JAX's `sample_motions` from the same seed
and weights; `conv_vae.sample_prior(model, n, z=...)` decodes given
latents.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from globalegomocap_tpu_torch.models.conv_vae import ConvVAE, sample_prior
from globalegomocap_tpu_torch.tools.ply import save_skeleton_sequence


def _device(model: ConvVAE) -> torch.device:
    return model.fc_mu.weight.device


def _windows(model: ConvVAE, windows) -> torch.Tensor:
    return torch.as_tensor(np.asarray(windows, dtype=np.float32),
                           device=_device(model))


@torch.no_grad()
def sample_motions(model: ConvVAE, num_samples: int,
                   seed: int = 0) -> np.ndarray:
    """Decode JAX's N(0, I) latents of `seed` -> (num_samples, T, 15, 3)
    motion windows."""
    return sample_prior(model, num_samples, seed).cpu().numpy()


def export_sample_meshes(model: ConvVAE, out_dir: str, num_samples: int = 10,
                         seed: int = 0) -> np.ndarray:
    """Sample, and write each window as a directory `sample_<i>` of PLY
    skeleton meshes, one a frame (the reference's sample.py output)."""
    motions = sample_motions(model, num_samples, seed)
    for i, motion in enumerate(motions):
        save_skeleton_sequence(motion, os.path.join(out_dir, f"sample_{i}"))
    return motions


@torch.no_grad()
def interpolate_latents(model: ConvVAE, window_a, window_b,
                        steps: int = 4) -> np.ndarray:
    """Encode two (T, 45) windows, interpolate their latent means
    linearly at `steps` interior points, decode all: (steps + 2, T, 15,
    3), the endpoints' reconstructions first and last."""
    mu, _ = model.encode(_windows(model, np.stack([window_a, window_b])))
    za, zb = mu[0], mu[1]
    alphas = torch.linspace(0.0, 1.0, steps + 2, device=mu.device)
    zs = za[None] + alphas[:, None] * (zb - za)[None]
    return model.decode(zs).reshape(steps + 2, model.seq_len, 15, 3) \
        .cpu().numpy()


@torch.no_grad()
def latent_statistics(model: ConvVAE, windows) -> dict:
    """||mu||^2 and ||std - 1||^2 over (W, T, 45) windows, per window and
    their means: how far the data sits from the prior's N(0, I)."""
    mu, log_var = model.encode(_windows(model, windows))
    mu_sq = torch.square(mu).sum(1)
    std_dist = torch.square(torch.exp(0.5 * log_var) - 1.0).sum(1)
    return {
        "mu_sq_norm": mu_sq.cpu().numpy(),
        "std_dist": std_dist.cpu().numpy(),
        "mean_mu_sq_norm": float(mu_sq.mean()),
        "mean_std_dist": float(std_dist.mean()),
    }
