"""Joint local+global prior training on one card or data-parallel.

Counterpart of `globalegomocap_tpu/train/train_joint.py`: one loop trains
both priors of `models/joint_vae.py` with the geometric consistency tie,
and `branch_variables` hands the two branches' state dicts straight to
`SequenceOptimizer`.  The JAX trainer's behaviour is kept as it is:

- `kld_weight = kl_weight * batch_size / len(poses)`;
- the optimizer is `make_optimizer(cfg)` with no step count, so the
  learning rate is constant even at `lr_schedule="cosine"`;
- each epoch's order is `np.random.default_rng(seed + 2).permutation`,
  the last partial batch dropped;
- each epoch's history entry holds the metrics of its last step, not
  the epoch's mean;
- the model computes in float32 whatever `cfg.compute_dtype` says.

The initial weights are Flax's `init` from cfg.seed, leaf for leaf,
each branch under its Flax scope 'local' or 'global' (`init_flax_like`),
and the reparameterisation noise of step `step` is JAX's own: the two
keys of `split(fold_in(PRNGKey(seed + 1), step))`, one a branch
(`joint_step_noise`, through the draw kernel on the card).  A run from a
seed follows the JAX trainer's run from that seed.

Data parallelism (`num_devices`, a mesh of several ranks) follows
`train/train_vae.py`: every rank starts from rank 0's state, takes its
rows of each global batch and draws only those rows of the global
batch's noise pair, both branches' BatchNorms normalise with the global
batch's statistics, each rank's loss is its share, and one all_reduce
sums the gradients and the metrics before Adam.  Rank 0 logs and keeps
the history.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from globalegomocap_tpu_torch.config import TrainConfig
from globalegomocap_tpu_torch.models.conv_vae import init_flax_like
from globalegomocap_tpu_torch.models.joint_vae import (
    JointLocalGlobalVAE, joint_loss, split_branches)
from globalegomocap_tpu_torch.ops.random import (
    fold_in, normal, prng_key, split)
from globalegomocap_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from globalegomocap_tpu_torch.train.train_vae import (
    OptimizerSpec, all_reduce_grads, make_optimizer, train_mesh)


def joint_step_noise(key: tuple[int, int], step: int, shape,
                     dtype: torch.dtype, device, row: int = 0) -> tuple:
    """The (local, global) reparameterisation noise of update `step`
    under the trainer's key (JAX's `PRNGKey(seed + 1)`): `normal(k,
    shape, dtype)` of each key of `split(fold_in(key, step))` on
    `device`, rows row.. of the draws of a larger batch (one rank's
    rows of the global batch's noise pair)."""
    start = row * math.prod(shape[1:])
    return tuple(normal(k, tuple(shape), dtype, start=start, device=device)
                 for k in split(fold_in(key, step)))


def make_joint_train_step(model: JointLocalGlobalVAE,
                          optimizer: torch.optim.Optimizer,
                          spec: OptimizerSpec, kld_weight: float, seed: int,
                          consistency_weight: float = 1.0,
                          mesh: Mesh | None = None):
    """step(poses (B, T, 45), cameras (B, T, 4, 4) on the device, count)
    -> metrics: one update of both branches with the noise of update
    `count` under `PRNGKey(seed)` (`joint_step_noise`; the trainer passes
    cfg.seed + 1, as the JAX trainer does).  The metrics ('consistency',
    'global_kld', 'global_recon', 'local_kld', 'local_recon', 'loss', in
    that order) are 0-d device tensors; the step reads nothing back.
    Over a `mesh` of several ranks the inputs are this rank's rows of the
    global batch, its noise those rows of the global batch's, and the
    metrics are the global batch's."""
    latent = model.latent_dim
    size = 1 if mesh is None else mesh.size
    key = prng_key(seed)

    def step(poses: torch.Tensor, cameras: torch.Tensor, count: int) -> dict:
        for group in optimizer.param_groups:
            group["lr"] = spec.lr_at(count)
        b = poses.shape[0]
        noise = joint_step_noise(key, count, (b, latent), model.dtype,
                                 poses.device,
                                 row=0 if size == 1 else mesh.rank * b)
        out = model(poses, cameras, train=True, noise=noise, mesh=mesh)
        total, metrics = joint_loss(out, poses, cameras, kld_weight,
                                    consistency_weight)
        optimizer.zero_grad(set_to_none=True)
        metrics = dict(metrics, loss=total)
        keys = sorted(metrics)  # JAX's jitted step returns its dict sorted
        if size == 1:
            total.backward()
            optimizer.step()
            return {k: metrics[k].detach() for k in keys}
        (total / size).backward()
        summed = all_reduce_grads(mesh, model.parameters(), torch.stack(
            [metrics[k] for k in keys]).detach() / size)
        optimizer.step()
        return dict(zip(keys, summed.unbind()))

    return step


class JointTrainer:
    """Trainer of both priors over (window, camera) pairs.

    poses: (W, T, 45) local windows; cameras: (W, T, 4, 4).  Beyond the
    JAX trainer's arguments: `device` (the card unless the caller asks for
    the CPU), `variables` (a joint state dict to start from, in place of
    Flax's initialisation from cfg.seed) and `mesh` (default `make_mesh(
    cfg.num_devices or None)` on `device`)."""

    def __init__(self, cfg: TrainConfig, poses: np.ndarray,
                 cameras: np.ndarray,
                 model: JointLocalGlobalVAE | None = None,
                 consistency_weight: float = 1.0, device="cuda",
                 variables: dict | None = None,
                 mesh: Mesh | None = None):
        if len(poses) != len(cameras):
            raise ValueError(f"{len(poses)} pose windows but "
                             f"{len(cameras)} camera windows")
        self.cfg = cfg
        self.mesh = train_mesh(cfg, device, mesh)
        self.device = self.mesh.device
        self.poses = poses
        self.cameras = cameras
        self.model = model or JointLocalGlobalVAE(
            latent_dim=cfg.latent_dim, seq_len=cfg.seq_length)
        self.model.to(self.device)
        if variables is None:
            init_flax_like(self.model.local_vae, cfg.seed, scope=("local",))
            init_flax_like(self.model.global_vae, cfg.seed,
                           scope=("global",))
        else:
            self.model.load_state_dict(variables)
        replicate(self.mesh, self.model)
        self.opt_spec = make_optimizer(cfg)
        self.optimizer = self.opt_spec.build(self.model.parameters())
        self.step = 0
        kld_weight = cfg.kl_weight * cfg.batch_size / max(1, len(poses))
        self._step = make_joint_train_step(self.model, self.optimizer,
                                           self.opt_spec, kld_weight,
                                           cfg.seed + 1, consistency_weight,
                                           self.mesh)

    def _device_batch(self, x: np.ndarray) -> torch.Tensor:
        """This rank's rows of a host batch, on the device."""
        x = shard_batch(self.mesh, x)
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def train_step(self, poses: torch.Tensor, cameras: torch.Tensor) -> dict:
        """One update on a device batch; the step count moves on."""
        metrics = self._step(poses, cameras, self.step)
        self.step += 1
        return metrics

    def train(self, log_fn=print) -> list[dict]:
        """cfg.epochs epochs; returns the history, one entry an epoch with
        its last step's metrics (as floats), on rank 0 (other ranks keep
        none)."""
        cfg = self.cfg
        np_rng = np.random.default_rng(cfg.seed + 2)
        n = len(self.poses)
        history = []
        for epoch in range(cfg.epochs):
            order = np_rng.permutation(n)
            end = n - n % cfg.batch_size
            metrics = None
            for i in range(0, end, cfg.batch_size):
                sel = order[i:i + cfg.batch_size]
                metrics = self.train_step(self._device_batch(self.poses[sel]),
                                          self._device_batch(
                                              self.cameras[sel]))
            if metrics is None:
                raise ValueError(
                    f"epoch {epoch} ran no step: batch_size "
                    f"({cfg.batch_size}) exceeds the {n} windows")
            row = {k: float(v) for k, v in metrics.items()}
            if self.mesh.rank == 0:
                history.append(row)
                log_fn(f"epoch {epoch}: " + " ".join(
                    f"{k}={v:.5f}" for k, v in row.items()))
        return history

    def branch_variables(self) -> tuple:
        """(local state dict, global state dict) for the optimizer."""
        return split_branches(self.model, self.model.state_dict())
