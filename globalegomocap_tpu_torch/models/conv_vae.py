"""Convolutional sequence motion-VAE, the motion prior of both stages.

Counterpart of `globalegomocap_tpu/models/conv_vae.py::ConvVAE`, built
with the reference's own torch module layout (encoder.{i}.{0,1},
fc_mu, fc_var, decoder_input, decoder.{i}.{0,1}, final_layer.{0,1,3}),
so a released reference state_dict loads unchanged and JAX variables
cross through `models/convert.py::params_from_flax`.

  encoder: 5 x [Conv1d(k=3, SAME) -> BatchNorm -> LeakyReLU(0.01)],
           channel-major flatten, Linear heads fc_mu / fc_var.
  decoder: Linear latent -> C*T, 4 x [ConvTranspose1d(k=3, s=1, p=1) ->
           BN -> LeakyReLU], a final [ConvT -> BN -> LeakyReLU] and a
           Conv1d projection to 45 channels.

Public functions keep the JAX package's channels-last layout: poses are
(B, T, 45) and decoded joints (B, T, 15, 3).  `use_bn=False` builds the
model with the BatchNorms structurally absent, to pair with
`models/fold_bn.fold_batchnorm` state dicts.

Compute dtypes follow Flax's `dtype` / `head_dtype`: the loaded
parameters stay float32, activations and products run in `dtype`
(inputs cast on entry, each weight used as `w.to(dtype)`), `head_dtype`
sets fc_mu alone (fc_var stays at `dtype`), and BatchNorm normalises in
float32 and returns `dtype`, as Flax's does.  `clone(dtype=...,
head_dtype=...)` is the counterpart of Flax's `model.clone`: a model of
the same weights at other compute dtypes, whose parameters are stored in
those dtypes, so the per-call casts become no-ops.  A float32 clone of
float32 weights shares their tensors; a bf16 clone casts each weight
once.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _block(conv: nn.Module, channels: int, use_bn: bool) -> nn.Sequential:
    return nn.Sequential(
        conv, nn.BatchNorm1d(channels) if use_bn else nn.Identity(),
        nn.LeakyReLU(0.01))


class ConvVAE(nn.Module):
    def __init__(self, in_channels: int = 45, out_channels: int = 45,
                 latent_dim: int = 2048, seq_len: int = 10,
                 hidden_dims: Sequence[int] = (64, 64, 128, 256, 512),
                 use_bn: bool = True, dtype: torch.dtype = torch.float32,
                 head_dtype: torch.dtype | None = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.latent_dim = latent_dim
        self.seq_len = seq_len
        self.hidden_dims = tuple(hidden_dims)
        self.use_bn = use_bn
        self.dtype = dtype
        self.head_dtype = head_dtype

        enc, c = [], in_channels
        for h in self.hidden_dims:
            enc.append(_block(nn.Conv1d(c, h, 3, 1, 1), h, use_bn))
            c = h
        self.encoder = nn.Sequential(*enc)
        flat = self.hidden_dims[-1] * seq_len
        self.fc_mu = nn.Linear(flat, latent_dim)
        self.fc_var = nn.Linear(flat, latent_dim)

        rev = tuple(reversed(self.hidden_dims))
        self.decoder_input = nn.Linear(latent_dim, flat)
        self.decoder = nn.Sequential(*[
            _block(nn.ConvTranspose1d(rev[i], rev[i + 1], 3, 1, 1),
                   rev[i + 1], use_bn)
            for i in range(len(rev) - 1)])
        self.final_layer = nn.Sequential(
            nn.ConvTranspose1d(rev[-1], rev[-1], 3, 1, 1),
            nn.BatchNorm1d(rev[-1]) if use_bn else nn.Identity(),
            nn.LeakyReLU(0.01),
            nn.Conv1d(rev[-1], out_channels, 3, 1, 1))

    def clone(self, **changes) -> "ConvVAE":
        """The same weights at other compute dtypes (`dtype`,
        `head_dtype`), stored in those dtypes: Flax's `model.clone`.
        Parameters are cast with `.to`, so a dtype they already have
        shares the storage; BatchNorm affine and statistics stay float32.
        A deep copy whose memo maps every parameter to its cast and every
        buffer to itself: no constructor runs and no weight is copied."""
        if not set(changes) <= {"dtype", "head_dtype"}:
            raise TypeError(f"clone takes dtype and head_dtype, got "
                            f"{sorted(changes)}")
        dtype = changes.get("dtype", self.dtype)
        head_dtype = changes.get("head_dtype", self.head_dtype)
        memo = {id(b): b for b in self.buffers()}
        for name, mod in self.named_modules():
            for p in mod.parameters(recurse=False):
                if isinstance(mod, nn.BatchNorm1d):
                    memo[id(p)] = p
                else:
                    dt = (head_dtype or dtype) if name == "fc_mu" else dtype
                    memo[id(p)] = nn.Parameter(p.detach().to(dt),
                                               p.requires_grad)
        m = copy.deepcopy(self, memo)
        m.dtype, m.head_dtype = dtype, head_dtype
        return m

    def _conv_block(self, block: nn.Sequential, x: torch.Tensor,
                    transposed: bool) -> torch.Tensor:
        """conv -> BN (float32, result in dtype) -> LeakyReLU in dtype."""
        conv, bn = block[0], block[1]
        fn = F.conv_transpose1d if transposed else F.conv1d
        dt = self.dtype
        x = fn(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
        if isinstance(bn, nn.BatchNorm1d):
            x = bn(x.to(torch.float32)).to(dt)
        return F.leaky_relu(x, 0.01)

    def encode(self, pose: torch.Tensor):
        """pose (B, T, C) -> (mu, log_var), each (B, latent); mu in the
        head dtype, log_var in dtype."""
        h = pose.to(self.dtype).transpose(1, 2)
        for block in self.encoder:
            h = self._conv_block(block, h, transposed=False)
        h = h.flatten(1)                   # channel-major (C, T) flatten
        head = self.head_dtype or self.dtype
        mu = F.linear(h.to(head), self.fc_mu.weight.to(head),
                      self.fc_mu.bias.to(head))
        log_var = F.linear(h, self.fc_var.weight.to(self.dtype),
                           self.fc_var.bias.to(self.dtype))
        return mu, log_var

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent) -> (B, T, out_channels) in dtype."""
        dt = self.dtype
        h = F.linear(z.to(dt), self.decoder_input.weight.to(dt),
                     self.decoder_input.bias.to(dt))
        h = h.view(-1, self.hidden_dims[-1], self.seq_len)
        for block in self.decoder:
            h = self._conv_block(block, h, transposed=True)
        h = self._conv_block(self.final_layer, h, transposed=True)
        out = self.final_layer[3]
        h = F.conv1d(h, out.weight.to(dt), out.bias.to(dt), padding=1)
        return h.transpose(1, 2)

    def decode_to_bodypose(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent) -> (B, T, 15, 3) joint sequences."""
        return self.decode(z).reshape(-1, self.seq_len, 15, 3)

    def forward(self, pose: torch.Tensor):
        """Deterministic autoencode (z = mu): (reconstruction, mu, log_var)."""
        mu, log_var = self.encode(pose)
        return self.decode(mu), mu, log_var


def init_random(model: ConvVAE, generator: torch.Generator) -> ConvVAE:
    """Fill every parameter from `generator` (uniform +-1/sqrt(fan_in),
    PyTorch's default scale) and give the BatchNorms non-trivial running
    statistics, so a seeded random prior exercises BN folding."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear)):
                w = mod.weight
                fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
                if isinstance(mod, nn.ConvTranspose1d):
                    fan_in = w.shape[0] * w.shape[2]
                bound = fan_in ** -0.5
                w.uniform_(-bound, bound, generator=generator)
                mod.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, nn.BatchNorm1d):
                mod.weight.uniform_(0.8, 1.2, generator=generator)
                mod.bias.uniform_(-0.1, 0.1, generator=generator)
                mod.running_mean.uniform_(-0.1, 0.1, generator=generator)
                mod.running_var.uniform_(0.8, 1.2, generator=generator)
    return model
