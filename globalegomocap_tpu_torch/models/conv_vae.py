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

`with_bone_length=True` adds the reference's bone-length encoder branch
(SeqConvVAE.py:47-57; off in every released configuration): the
(T, 15) bone lengths of the input through `bone_dense` (Linear T*15 ->
512), `bone_bn` and LeakyReLU, concatenated after the encoder's
flattened features and fused by `fusion_dense` (Linear C*T + 512 ->
C*T), `fusion_bn` and LeakyReLU before fc_mu / fc_var.  These
BatchNorms stay when `use_bn=False` (folding reaches only the conv
blocks), as in the JAX model.

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

Training (`train/train_vae.py`) runs `encode` / `decode` with
`train=True`: BatchNorm then normalises with the batch statistics and
moves the running ones as Flax's does (biased variance, momentum 0.9).
With a `mesh` of several ranks (data parallelism, `parallel/mesh.py`)
the batch statistics are those of the global batch, every rank's rows,
as JAX's jit over a sharded batch computes them.
`reparameterize` takes its noise from the caller, `vae_loss` is the
reference's ELBO, and `init_flax_like` draws a fresh prior from Flax's
default distributions (`init_random`, PyTorch-like, makes the seeded
random priors of the solve paths).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from globalegomocap_tpu_torch.ops.random import normal, prng_key
from globalegomocap_tpu_torch.ops.skeleton import bone_lengths
from globalegomocap_tpu_torch.parallel.mesh import all_reduce


class VAEOutput(NamedTuple):
    reconstruction: torch.Tensor  # (B, T, C)
    mu: torch.Tensor              # (B, latent)
    log_var: torch.Tensor         # (B, latent)
    z: torch.Tensor               # (B, latent)


def _block(conv: nn.Module, channels: int, use_bn: bool) -> nn.Sequential:
    return nn.Sequential(
        conv, nn.BatchNorm1d(channels) if use_bn else nn.Identity(),
        nn.LeakyReLU(0.01))


class ConvVAE(nn.Module):
    def __init__(self, in_channels: int = 45, out_channels: int = 45,
                 latent_dim: int = 2048, seq_len: int = 10,
                 hidden_dims: Sequence[int] = (64, 64, 128, 256, 512),
                 use_bn: bool = True, dtype: torch.dtype = torch.float32,
                 head_dtype: torch.dtype | None = None,
                 logvar_bias_init: float = 0.0,
                 with_bone_length: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.latent_dim = latent_dim
        self.seq_len = seq_len
        self.hidden_dims = tuple(hidden_dims)
        self.use_bn = use_bn
        self.dtype = dtype
        self.head_dtype = head_dtype
        self.logvar_bias_init = logvar_bias_init
        self.with_bone_length = with_bone_length

        enc, c = [], in_channels
        for h in self.hidden_dims:
            enc.append(_block(nn.Conv1d(c, h, 3, 1, 1), h, use_bn))
            c = h
        self.encoder = nn.Sequential(*enc)
        flat = self.hidden_dims[-1] * seq_len
        self.fc_mu = nn.Linear(flat, latent_dim)
        self.fc_var = nn.Linear(flat, latent_dim)
        nn.init.constant_(self.fc_var.bias, logvar_bias_init)
        if with_bone_length:
            self.bone_dense = nn.Linear(seq_len * 15, 512)
            self.bone_bn = nn.BatchNorm1d(512)
            self.fusion_dense = nn.Linear(flat + 512, flat)
            self.fusion_bn = nn.BatchNorm1d(flat)

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
                    transposed: bool, train: bool = False,
                    mesh=None) -> torch.Tensor:
        """conv -> BN (float32, result in dtype) -> LeakyReLU in dtype.
        BN uses the running statistics, or with `train` the batch's (over
        `mesh`'s ranks) and updates the running ones
        (`_batch_norm_train`)."""
        conv, bn = block[0], block[1]
        fn = F.conv_transpose1d if transposed else F.conv1d
        dt = self.dtype
        x = fn(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
        if isinstance(bn, nn.BatchNorm1d):
            x = self._norm(bn, x, train, mesh)
        return F.leaky_relu(x, 0.01)

    def _norm(self, bn: nn.BatchNorm1d, x: torch.Tensor, train: bool,
              mesh=None) -> torch.Tensor:
        """BatchNorm of (B, C, T) or (B, F) in float32, returned in dtype:
        the running statistics, or with `train` the batch's over B (and T)
        (`_batch_norm_train`)."""
        x32 = x.to(torch.float32)
        if not train:
            x32 = F.batch_norm(x32, bn.running_mean, bn.running_var,
                               bn.weight, bn.bias, False, 0.0, bn.eps)
        elif x32.dim() == 2:
            x32 = _batch_norm_train(bn, x32[..., None], mesh)[..., 0]
        else:
            x32 = _batch_norm_train(bn, x32, mesh)
        return x32.to(self.dtype)

    def _dense_bn_act(self, dense: nn.Linear, bn: nn.BatchNorm1d,
                      x: torch.Tensor, train: bool, mesh=None):
        dt = self.dtype
        x = F.linear(x.to(dt), dense.weight.to(dt), dense.bias.to(dt))
        return F.leaky_relu(self._norm(bn, x, train, mesh), 0.01)

    def encode(self, pose: torch.Tensor, train: bool = False, mesh=None):
        """pose (B, T, C) -> (mu, log_var), each (B, latent); mu in the
        head dtype, log_var in dtype."""
        h = pose.to(self.dtype).transpose(1, 2)
        for block in self.encoder:
            h = self._conv_block(block, h, False, train, mesh)
        h = h.flatten(1)                   # channel-major (C, T) flatten
        if self.with_bone_length:
            lengths = bone_lengths(pose.reshape(pose.shape[0], self.seq_len,
                                                15, 3)).flatten(1)
            bl = self._dense_bn_act(self.bone_dense, self.bone_bn, lengths,
                                    train, mesh)
            h = self._dense_bn_act(self.fusion_dense, self.fusion_bn,
                                   torch.cat([h, bl], dim=-1), train, mesh)
        head = self.head_dtype or self.dtype
        mu = F.linear(h.to(head), self.fc_mu.weight.to(head),
                      self.fc_mu.bias.to(head))
        log_var = F.linear(h, self.fc_var.weight.to(self.dtype),
                           self.fc_var.bias.to(self.dtype))
        return mu, log_var

    def decode(self, z: torch.Tensor, train: bool = False,
               mesh=None) -> torch.Tensor:
        """z (B, latent) -> (B, T, out_channels) in dtype."""
        dt = self.dtype
        h = F.linear(z.to(dt), self.decoder_input.weight.to(dt),
                     self.decoder_input.bias.to(dt))
        h = h.view(-1, self.hidden_dims[-1], self.seq_len)
        for block in self.decoder:
            h = self._conv_block(block, h, True, train, mesh)
        h = self._conv_block(self.final_layer, h, True, train, mesh)
        out = self.final_layer[3]
        h = F.conv1d(h, out.weight.to(dt), out.bias.to(dt), padding=1)
        return h.transpose(1, 2)

    def decode_to_bodypose(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent) -> (B, T, 15, 3) joint sequences."""
        return self.decode(z).reshape(-1, self.seq_len, 15, 3)

    def forward(self, pose: torch.Tensor, train: bool = False,
                noise: torch.Tensor | None = None, mesh=None):
        """Encode, reparameterise with `noise` (z = mu without it) and
        decode: VAEOutput(reconstruction, mu, log_var, z).  `train` runs
        BN on the batch statistics (over `mesh`'s ranks) and updates the
        running ones, as the JAX model's `train=True` with
        `mutable=['batch_stats']`."""
        mu, log_var = self.encode(pose, train, mesh)
        z = reparameterize(mu, log_var, noise)
        return VAEOutput(self.decode(z, train, mesh), mu, log_var, z)


def _batch_norm_train(bn: nn.BatchNorm1d, x: torch.Tensor,
                      mesh=None) -> torch.Tensor:
    """Flax's train-mode BatchNorm on float32 (B, C, T): normalise with
    the batch mean and the biased variance E[x^2] - E[x]^2 (clamped at 0),
    and move the running statistics by momentum 0.9 towards them.  Not
    `F.batch_norm(training=True)`, whose running variance takes the
    unbiased estimate, n/(n-1) times Flax's.

    Over a `mesh` of several ranks the statistics are the global batch's:
    the per-channel sums of x and x^2 and the row count go through the
    differentiable all_reduce (so the backward carries the other ranks'
    terms), and the running statistics come out equal on every rank.
    Per-rank statistics (plain DDP) would train another model than the
    JAX package's."""
    if mesh is None or mesh.size == 1:
        mean = x.mean(dim=(0, 2))
        var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
    else:
        c = x.shape[1]
        sums = all_reduce(mesh, torch.cat([
            x.sum(dim=(0, 2)), (x * x).sum(dim=(0, 2)),
            x.new_full((1,), float(x.shape[0] * x.shape[2]))]))
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(0.9).add_(mean.detach(), alpha=0.1)
        bn.running_var.mul_(0.9).add_(var.detach(), alpha=0.1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None]) * mul[:, None] + bn.bias[:, None]


def reparameterize(mu: torch.Tensor, log_var: torch.Tensor,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """z = mu + noise * exp(0.5 log_var), or mu without noise.  The JAX
    model draws the noise itself, in mu's dtype; here the caller passes
    it (the trainer's `noise_fn`)."""
    if noise is None:
        return mu
    return mu + noise * torch.exp(0.5 * log_var)


def sample_init(mu: torch.Tensor, log_var: torch.Tensor, seed: int,
                row: int = 0) -> torch.Tensor:
    """The solver's sample init, the JAX stage's `reparameterize(mu,
    log_var, PRNGKey(seed))`: mu plus JAX's own normal draw of mu's shape
    and dtype (`ops/random.py`; bf16 at bfloat16_pure, else float32)
    times exp(0.5 log_var).  `row` > 0 takes rows row.. of a larger draw
    (one rank's slice of a draw over every rank's windows)."""
    noise = normal(prng_key(int(seed)), tuple(mu.shape), mu.dtype,
                   start=row * mu.shape[-1], device=mu.device)
    return reparameterize(mu, log_var, noise)


def vae_loss(reconstruction: torch.Tensor, target: torch.Tensor,
             mu: torch.Tensor, log_var: torch.Tensor, kld_weight: float,
             reduction: str = "mean"):
    """The reference's ELBO (SeqConvVAE.py:191-219): (loss, recon, kld).
    reduction='mean': recon is the mean squared error and `kld_weight`
    the reference's M_N; 'sum': the summed squared error."""
    diff = reconstruction - target
    recon = torch.square(diff).mean() if reduction == "mean" \
        else torch.square(diff).sum()
    kld = torch.mean(-0.5 * torch.sum(
        1 + log_var - torch.square(mu) - torch.exp(log_var), dim=1))
    return recon + kld_weight * kld, recon, kld


def sample_prior(model: ConvVAE, num_samples: int,
                 generator: torch.Generator | None = None,
                 z: torch.Tensor | None = None) -> torch.Tensor:
    """Decode N(0, I) latents into (N, T, 15, 3) motions (reference:
    SeqConvVAE.py:221-235).  `z` gives the latents; otherwise they are
    drawn from `generator` on the model's device."""
    if z is None:
        w = model.fc_mu.weight
        z = torch.randn(num_samples, model.latent_dim, generator=generator,
                        device=w.device, dtype=torch.float32)
    return model.decode(z).reshape(num_samples, model.seq_len, 15, 3)


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


def init_flax_like(model: ConvVAE, generator: torch.Generator,
                   logvar_bias_init: float | None = None) -> ConvVAE:
    """Fill the parameters from `generator` with Flax's default
    distributions, as the JAX model's `init`: every conv and dense kernel
    lecun_normal (a normal truncated at +-2 std, scaled to std
    1/sqrt(fan_in)), every bias 0, BN scale 1 and bias 0, running mean 0
    and variance 1, and fc_var's bias `logvar_bias_init` (default the
    model's).  The draws are not JAX's: the distributions are."""
    if logvar_bias_init is None:
        logvar_bias_init = model.logvar_bias_init
    # the standard deviation of a unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear)):
                w = mod.weight
                if isinstance(mod, nn.Linear):
                    fan_in = w.shape[1]
                elif isinstance(mod, nn.ConvTranspose1d):
                    fan_in = w.shape[0] * w.shape[2]
                else:
                    fan_in = w.shape[1] * w.shape[2]
                std = fan_in ** -0.5 / trunc_std
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                mod.bias.fill_(logvar_bias_init if name == "fc_var" else 0.0)
            elif isinstance(mod, nn.BatchNorm1d):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    return model
