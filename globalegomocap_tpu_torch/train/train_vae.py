"""Motion-VAE training on one card or data-parallel over several.

Counterpart of `globalegomocap_tpu/train/train_vae.py`, the reference's
training loop (networks/train.py:35-134): Adam (lr 1e-4), batch 64, the
ELBO with M_N = kl_weight * batch / len(dataset), a reconstruction-MPJPE
eval every epoch and an epoch checkpoint after it.  The local prior's
trainer (train_local.py) is the same loop over local-pose windows
(`TrainConfig.local_pose`).

What the JAX trainer does in one jitted program, the port does in eager
PyTorch on each rank of a mesh (`parallel/mesh.py`; one rank without a
process group):

- the optimizer is `torch.optim.Adam`, or `AdamW` with weight decay,
  with optax's betas and eps, and the learning rate of optax's
  warmup-cosine schedule set before each update from the step count
  (optax evaluates its schedule at the count before the update);
- BatchNorm runs in train mode with Flax's semantics
  (`models/conv_vae.py::_batch_norm_train`);
- the initial weights are Flax's `init` from cfg.seed, leaf for leaf
  (`models/conv_vae.py::init_flax_like`, drawn on the trainer's device),
  and the reparameterisation noise of step `step` is JAX's own,
  `normal(fold_in(PRNGKey(cfg.seed + 1), step), mu.shape, mu.dtype)`
  (`step_noise`; JAX's threefry stream, `ops/random.py`, through the
  draw kernel on the card), so a run from a seed follows the JAX
  trainer's run from that seed;
- the metrics stay on the device: nothing is read back inside an epoch
  except at `log_step` boundaries;
- `epoch_scan` keeps JAX's block structure (blocks of `scan_block` steps,
  a trailing block of two or more, a single leftover step alone, one log
  line an epoch); a block is one host-to-device copy and a loop of steps
  with no readback;
- checkpoints are the JAX trainer's msgpack files or Orbax directories
  ({'params', 'batch_stats', 'opt_state', 'step'} in the Flax layout,
  read by its `load_checkpoint`) with the same `.json` sidecar.

Data parallelism (`num_devices`, the mesh of `make_mesh`) computes what
one rank computes, as JAX's jit over a batch sharded on its 'dp' axis
does: every rank starts from rank 0's state (`replicate`); the global
batch (`cfg.batch_size`, which the mesh size must divide) is split by
rows; each rank draws only its rows of the global batch's noise; the
train-mode BatchNorm normalises with the global batch's statistics; each
rank's loss is its share (the shares sum to the one-rank loss), and the
gradients and the metrics are summed over the ranks by one all_reduce
before Adam, which runs replicated.  Rank 0 logs, keeps `history` and
writes the checkpoints; the eval edge-pads each batch to a multiple of
the mesh size and masks the padding out (JAX's eval), and sums over the
ranks.  A mesh of one rank makes no collective call.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from globalegomocap_tpu_torch.config import TrainConfig
from globalegomocap_tpu_torch.models.checkpoint import (
    load_train_state, save_train_state)
from globalegomocap_tpu_torch.models.conv_vae import (
    ConvVAE, init_flax_like, reparameterize, vae_loss)
from globalegomocap_tpu_torch.models.convert import (
    opt_state_from_flax, opt_state_to_flax, params_from_flax,
    params_to_flax)
from globalegomocap_tpu_torch.ops.random import fold_in, normal, prng_key
from globalegomocap_tpu_torch.optimize.prior_bank import windows_accel_stat
from globalegomocap_tpu_torch.parallel.mesh import (
    Mesh, all_reduce, make_mesh, pad_to_multiple, replicate, shard_batch)
from globalegomocap_tpu_torch.utils.profiling import RECORDER


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine down to end_value at
    decay_steps, and end_value after it.  Returns count -> lr."""
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps, "
                         f"got {decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclass(frozen=True)
class OptimizerSpec:
    """The optimizer of a TrainConfig: Adam, or AdamW when weight_decay
    is set, at a constant learning rate or a schedule of the step
    count."""
    learning_rate: float
    weight_decay: float = 0.0
    schedule: Callable[[int], float] | None = None

    def lr_at(self, count: int) -> float:
        """The learning rate of the update that follows `count` updates."""
        return self.schedule(count) if self.schedule else self.learning_rate

    def build(self, params) -> torch.optim.Optimizer:
        if self.weight_decay:
            return torch.optim.AdamW(params, lr=self.lr_at(0),
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=self.weight_decay)
        return torch.optim.Adam(params, lr=self.lr_at(0), betas=(0.9, 0.999),
                                eps=1e-8)


def make_optimizer(cfg: TrainConfig, total_steps: int = 0) -> OptimizerSpec:
    """Adam / AdamW with an optional warmup-cosine schedule over
    `total_steps`, as the JAX `make_optimizer` (the reference trains at a
    constant lr, networks/train.py:96)."""
    schedule = None
    if cfg.lr_schedule == "cosine" and total_steps > 0:
        warm = min(cfg.lr_warmup_steps, max(total_steps - 1, 0))
        schedule = warmup_cosine_decay_schedule(
            0.0 if warm else cfg.learning_rate, cfg.learning_rate, warm,
            total_steps, cfg.lr_final)
    return OptimizerSpec(cfg.learning_rate, cfg.weight_decay, schedule)


def train_mesh(cfg: TrainConfig, device=None, mesh: Mesh | None = None
               ) -> Mesh:
    """The trainer's mesh: `mesh`, or `make_mesh(cfg.num_devices or
    None)` on `device` (num_devices 0 is every rank).  A mesh size that
    does not divide cfg.batch_size raises ValueError."""
    mesh = mesh or make_mesh(cfg.num_devices or None, device=device)
    if cfg.batch_size % mesh.size:
        raise ValueError(f"batch_size {cfg.batch_size} does not split "
                         f"into {mesh.size} equal shards")
    return mesh


def all_reduce_grads(mesh: Mesh, params, extra: torch.Tensor
                     ) -> torch.Tensor:
    """Sum every parameter's gradient and the vector `extra` over the
    ranks, in one all_reduce of one flat buffer; returns the summed
    `extra`."""
    params = list(params)
    flat = all_reduce(mesh, torch.cat(
        [p.grad.reshape(-1) for p in params]
        + [extra.to(params[0].grad.dtype)]))
    at = 0
    for p in params:
        p.grad.copy_(flat[at:at + p.numel()].view_as(p.grad))
        at += p.numel()
    return flat[at:]


def step_noise(key: tuple[int, int], step: int, shape, dtype: torch.dtype,
               device, row: int = 0) -> torch.Tensor:
    """The reparameterisation noise of update `step` under the trainer's
    key (JAX's `PRNGKey(seed + 1)`): `normal(fold_in(key, step), shape,
    dtype)` on `device`, rows row.. of the draw of a larger batch (one
    rank's rows of the global batch's noise).  A resumed run draws what
    an unbroken one would."""
    return normal(fold_in(key, step), tuple(shape), dtype,
                  start=row * math.prod(shape[1:]), device=device)


def make_train_step(model: ConvVAE, optimizer: torch.optim.Optimizer,
                    spec: OptimizerSpec, kld_weight: float, seed: int,
                    mesh: Mesh | None = None):
    """step(batch (B, T, 45) on the device, count) -> metrics: one
    update, with the learning rate of update `count` and its noise under
    `PRNGKey(seed)` (`step_noise`; the trainer passes cfg.seed + 1, as
    the JAX trainer does).  The metrics ('loss', 'recon_loss',
    'kld_loss') are 0-d device tensors; the step reads nothing back.
    Over a `mesh` of several ranks `batch` is this rank's rows of the
    global batch, its noise those rows of the global batch's, and the
    metrics are the global batch's.  Spans: `train.step` (request id
    `count`) around `train.forward`, `train.backward` (the all-reduce
    included) and `train.optimizer`."""
    size = 1 if mesh is None else mesh.size
    key = prng_key(seed)

    def step(batch: torch.Tensor, count: int) -> dict:
        with RECORDER.span("train.step", request=count, cpu=True):
            with RECORDER.span("train.forward"):
                for group in optimizer.param_groups:
                    group["lr"] = spec.lr_at(count)
                mu, log_var = model.encode(batch, train=True, mesh=mesh)
                noise = step_noise(
                    key, count, mu.shape, mu.dtype, mu.device,
                    row=0 if size == 1 else mesh.rank * mu.shape[0])
                z = reparameterize(mu, log_var, noise)
                recon = model.decode(z, train=True, mesh=mesh)
                loss, recon_loss, kld = vae_loss(recon, batch, mu, log_var,
                                                 kld_weight)
            with RECORDER.span("train.backward"):
                optimizer.zero_grad(set_to_none=True)
                if size == 1:
                    loss.backward()
                    metrics = {"loss": loss.detach(),
                               "recon_loss": recon_loss.detach(),
                               "kld_loss": kld.detach()}
                else:
                    (loss / size).backward()
                    total = all_reduce_grads(
                        mesh, model.parameters(),
                        torch.stack([loss, recon_loss, kld]).detach() / size)
                    metrics = dict(zip(("loss", "recon_loss", "kld_loss"),
                                       total.unbind()))
            with RECORDER.span("train.optimizer"):
                optimizer.step()
            return metrics

    return step


def make_eval_step(model: ConvVAE):
    """step(batch, mask (B,)) -> (sum over the rows of mask times each
    window's MPJPE, sum of mask), at z = mu with the running BN
    statistics (reference: networks/train.py:110-129)."""

    def step(batch: torch.Tensor, mask: torch.Tensor):
        with torch.no_grad():
            mu, _ = model.encode(batch)
            recon = model.decode(mu)
            pred = recon.reshape(batch.shape[0], -1, 15, 3)
            gt = batch.reshape(batch.shape[0], -1, 15, 3)
            per_window = torch.linalg.vector_norm(pred - gt,
                                                  dim=-1).mean(dim=(1, 2))
            return (per_window * mask).sum(), mask.sum()

    return step


class Trainer:
    """End-to-end trainer over window datasets (anything with `__len__`
    and `epoch_batches(rng, batch_size, drop_last=..., shuffle=...)`, such
    as `data/amass.py::AmassWindows`).

    Beyond the JAX trainer's arguments: `device` (the card unless the
    caller asks for the CPU), `variables` (a port state dict to start
    from, in place of Flax's initialisation from cfg.seed) and `mesh`
    (default `make_mesh(cfg.num_devices or None)` on `device`; its device
    is the trainer's).  Every rank reads the same batches and trains on its rows
    (the module docstring)."""

    def __init__(self, cfg: TrainConfig, train_ds, test_ds,
                 model: ConvVAE | None = None, device="cuda",
                 variables: dict | None = None,
                 mesh: Mesh | None = None):
        self.cfg = cfg
        self.train_ds = train_ds
        self.test_ds = test_ds
        self.mesh = train_mesh(cfg, device, mesh)
        self.device = self.mesh.device
        dt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
              else torch.float32)
        self.model = model or ConvVAE(latent_dim=cfg.latent_dim,
                                      seq_len=cfg.seq_length, dtype=dt,
                                      logvar_bias_init=cfg.logvar_init_bias)
        self.model.to(self.device)
        if variables is None:
            init_flax_like(self.model, cfg.seed)
        else:
            self.model.load_state_dict(variables)
        replicate(self.mesh, self.model)
        steps_per_epoch = max(1, len(train_ds) // max(1, cfg.batch_size))
        self.opt_spec = make_optimizer(cfg, steps_per_epoch * cfg.epochs)
        self.optimizer = self.opt_spec.build(self.model.parameters())
        self.step = 0
        # M_N of the reference: kl_weight * batch / dataset_len
        kld_weight = cfg.kl_weight * cfg.batch_size / max(1, len(train_ds))
        self._train_step = make_train_step(self.model, self.optimizer,
                                           self.opt_spec, kld_weight,
                                           cfg.seed + 1, self.mesh)
        self._eval_step = make_eval_step(self.model)
        self.history: list[dict] = []
        # the training windows' motion regime, written into each
        # checkpoint's sidecar (JAX optimize/prior_bank.py); None for
        # datasets without materialised windows
        self.motion_stats = None
        if hasattr(train_ds, "windows"):
            stat = windows_accel_stat(train_ds.windows)
            if math.isfinite(stat):
                self.motion_stats = {"accel_mean": stat}

    @property
    def variables(self) -> dict:
        """The prior's state dict (parameters and BN running statistics)."""
        return self.model.state_dict()

    def _device_batch(self, batch: np.ndarray, axis: int = 0
                      ) -> torch.Tensor:
        """This rank's rows (along `axis`) of a host batch, on the
        device: the span `train.batch`, under the id of the next step."""
        with RECORDER.span("train.batch", request=self.step):
            batch = shard_batch(self.mesh, batch, axis)
            t = torch.from_numpy(np.ascontiguousarray(batch,
                                                      dtype=np.float32))
            if self.device.type == "cuda":
                # from pinned memory the copy is asynchronous
                return t.pin_memory().to(self.device, non_blocking=True)
            return t

    def _run(self, batches, running: dict) -> int:
        """Train on each batch of a (S, B, T, 45) device tensor (or a list
        of (B, T, 45) ones), adding the metrics into `running` on the
        device.  Returns the number of steps."""
        for batch in batches:
            metrics = self._train_step(batch, self.step)
            self.step += 1
            for k in running:
                running[k] = running[k] + metrics[k]
        return len(batches)

    def train(self, log_fn=print, checkpoint_dir: str | None = None,
              checkpoint_format: str = "msgpack") -> int:
        """cfg.epochs epochs; returns the step count."""
        cfg = self.cfg
        np_rng = np.random.default_rng(cfg.seed + 2)
        count = 0
        zero = torch.zeros((), device=self.device)
        running = {"loss": zero, "recon_loss": zero}

        lead = self.mesh.rank == 0     # logs, keeps history, writes

        def log():
            nonlocal running
            vals = {k: float(v) for k, v in running.items()}
            if lead:
                log_fn(f"step {count}: running loss {vals['loss']:.5f} "
                       f"recon {vals['recon_loss']:.5f}")
                self.history.append({"step": count, **vals})
            running = {"loss": zero, "recon_loss": zero}

        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            epoch_steps = 0
            batches = self.train_ds.epoch_batches(np_rng, cfg.batch_size)
            if cfg.epoch_scan:
                # blocks of scan_block steps, each one copy to the device
                # and no readback; a trailing block of two or more steps
                # runs as a block, a single leftover step on its own
                block = max(1, cfg.scan_block)
                pending: list = []
                for batch in batches:
                    pending.append(batch)
                    if len(pending) == block:
                        epoch_steps += self._run(self._device_batch(
                            np.stack(pending), axis=1), running)
                        pending.clear()
                if len(pending) >= 2:
                    epoch_steps += self._run(self._device_batch(
                        np.stack(pending), axis=1), running)
                    pending.clear()
                if pending:     # a single leftover step
                    epoch_steps += self._run(
                        [self._device_batch(pending[0])], running)
                count += epoch_steps
                if cfg.log_step and epoch_steps \
                        and count % cfg.log_step < epoch_steps:
                    log()
            else:
                for batch in batches:
                    epoch_steps += self._run([self._device_batch(batch)],
                                             running)
                    count += 1
                    if cfg.log_step and count % cfg.log_step == 0:
                        log()
            if epoch_steps == 0 and lead:
                log_fn(f"WARNING: epoch {epoch} ran 0 steps — batch_size "
                       f"({cfg.batch_size}) exceeds the dataset "
                       f"({len(self.train_ds)} windows) with drop_last")
            dt = time.perf_counter() - t0
            every = max(1, cfg.eval_every)
            if every == 1 or (epoch + 1) % every == 0 \
                    or epoch == cfg.epochs - 1:
                eval_mpjpe = self.evaluate()
                if not lead:
                    continue
                log_fn(f"epoch {epoch}: eval reconstruction MPJPE "
                       f"{eval_mpjpe:.5f}  ({dt:.1f}s)")
                self.history.append({"epoch": epoch,
                                     "eval_mpjpe": eval_mpjpe})
                if checkpoint_dir:
                    self.save_checkpoint(checkpoint_dir, epoch, eval_mpjpe,
                                         fmt=checkpoint_format)
        return self.step

    def evaluate(self) -> float:
        """The mean reconstruction MPJPE over the test windows.  Over a
        mesh of several ranks each batch is edge-padded to a multiple of
        the mesh size with the padded rows masked out, and the sums are
        summed over the ranks."""
        size = self.mesh.size
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        count = torch.zeros((), dtype=torch.float64, device=self.device)
        for batch in self.test_ds.epoch_batches(
                np.random.default_rng(0), self.cfg.batch_size,
                drop_last=False, shuffle=False):
            if size == 1:
                mask = torch.ones(len(batch), device=self.device)
            else:
                n = len(batch)
                batch, _ = pad_to_multiple(batch, size)
                mask = np.zeros(len(batch), dtype=np.float32)
                mask[:n] = 1.0
                mask = self._device_batch(mask)
            s, c = self._eval_step(self._device_batch(batch), mask)
            total += s.double()
            count += c.double()
        if size > 1:
            total, count = all_reduce(self.mesh,
                                      torch.stack([total, count])).unbind()
        total, count = float(total), float(count)
        return total / count if count else float("nan")

    def opt_state(self) -> dict:
        """The optimizer's state as the JAX trainer's optax tree."""
        return opt_state_to_flax(self.optimizer, self.model.named_parameters(),
                                 bool(self.cfg.weight_decay),
                                 self.opt_spec.schedule is not None)

    def save_checkpoint(self, directory: str, epoch: int,
                        eval_result: float, fmt: str = "msgpack") -> str:
        """`<epoch>.msgpack`, or `<epoch>.orbax` at `fmt` 'orbax' (an
        Orbax directory under the absolute path, as the JAX trainer
        writes), of {'params', 'batch_stats', 'opt_state', 'step'}, and
        its `<epoch>.json` sidecar ({'epoch', 'eval_result', 'args',
        'motion_stats'})."""
        os.makedirs(directory, exist_ok=True)
        if fmt == "orbax":
            path = os.path.join(os.path.abspath(directory), f"{epoch}.orbax")
        else:
            path = os.path.join(directory, f"{epoch}.msgpack")
        save_train_state(path, params_to_flax(self.model.state_dict()),
                         self.opt_state(), self.step, fmt=fmt)
        meta = {"epoch": epoch + 1, "eval_result": eval_result,
                "args": {k: getattr(self.cfg, k)
                         for k in self.cfg.__dataclass_fields__
                         if isinstance(getattr(self.cfg, k),
                                       (int, float, str, bool))}}
        if self.motion_stats:
            meta["motion_stats"] = self.motion_stats
        with open(os.path.join(directory, f"{epoch}.json"), "w") as f:
            json.dump(meta, f)
        return path

    def load_checkpoint(self, path: str) -> int:
        """Resume from an epoch checkpoint (this trainer's or the JAX
        trainer's msgpack file or Orbax directory under the same
        TrainConfig): the prior, the Adam moments and count, and the step
        (every rank reads it and ends with rank 0's state).  Returns the
        step."""
        blob = load_train_state(path)
        self.model.load_state_dict(params_from_flax(
            {"params": blob["params"], "batch_stats": blob["batch_stats"]}))
        opt_state_from_flax(blob["opt_state"], self.optimizer,
                            self.model.named_parameters(),
                            bool(self.cfg.weight_decay),
                            self.opt_spec.schedule is not None)
        replicate(self.mesh, self.model, self.optimizer)
        self.step = int(blob["step"])
        return self.step
