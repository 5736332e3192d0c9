"""The rank functions of the data-parallel tests (test_torch_parallel.py,
test_torch_window_shard.py, test_torch_dp_train.py,
test_torch_sample_init.py, test_torch_serve_ranks.py).

`globalegomocap_tpu_torch.parallel.mesh.spawn` starts each rank as a
fresh process that imports its function by this module's path, so this
module imports only the port, numpy and torch: a rank must not import
JAX or tests/conftest.py.  Each function takes the rank's mesh first and
returns host values (numpy arrays, floats, dicts), which `spawn` hands
back to the test in rank order; the test holds them against JAX."""

from __future__ import annotations

import os

import numpy as np
import torch

from globalegomocap_tpu_torch.config import TrainConfig
from globalegomocap_tpu_torch.data.amass import AmassWindows
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
from globalegomocap_tpu_torch.models.joint_vae import JointLocalGlobalVAE
from globalegomocap_tpu_torch.optimize import driver
from globalegomocap_tpu_torch.optimize.prior_bank import PriorBank
from globalegomocap_tpu_torch.parallel import mesh as pm
from globalegomocap_tpu_torch.parallel.window_shard import (
    optimize_chunk_window_sharded)
from globalegomocap_tpu_torch.train.train_joint import JointTrainer
from globalegomocap_tpu_torch.train.train_vae import Trainer


def fields(res) -> dict:
    """A ChunkResult as numpy arrays by field name."""
    return {k: getattr(res, k).float().cpu().numpy() for k in res._fields}


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def collectives(mesh) -> dict:
    """all_reduce with its backward, all_gather, all_gather_fields of a
    float32 and a bf16 field, and replicate of a module and an Adam state
    made different on each rank."""
    dev = mesh.device
    x = torch.arange(3, dtype=torch.float32, device=dev).mul(mesh.rank + 1)
    x.requires_grad_(True)
    s = pm.all_reduce(mesh, x)
    (s * torch.tensor([1.0, 2.0, 3.0], device=dev)).sum().backward()
    g = pm.all_gather(mesh, torch.full((2, 2), float(mesh.rank),
                                       device=dev), axis=1)
    a = torch.full((1, 2, 3), float(mesh.rank), device=dev)
    b = torch.full((1, 4), 0.5 + mesh.rank, dtype=torch.bfloat16, device=dev)
    fa, fb = pm.all_gather_fields(mesh, (a, b))
    torch.manual_seed(mesh.rank)
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(lin.parameters())
    lin(torch.randn(4, 3)).sum().backward()
    opt.step()
    lin.to(dev)
    pm.replicate(mesh, lin, opt)
    host = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    return {"sum": host(s), "grad": host(x.grad), "gather": host(g),
            "fa": host(fa), "fb": host(fb), "fb_dtype": str(fb.dtype),
            "on": str(s.device) + str(g.device) + str(fa.device),
            "weight": host(lin.weight),
            "moment": opt.state[lin.weight]["exp_avg"].cpu().numpy(),
            "rank": mesh.rank, "size": mesh.size,
            "backend": mesh.backend, "device": str(mesh.device)}


def fails_on(mesh, rank: int):
    """Raise ValueError on `rank`; the others return."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} failed on purpose")
    return mesh.rank


# ---------------------------------------------------------------------------
# the solves
# ---------------------------------------------------------------------------

def window_sharded(mesh, cases) -> dict:
    """Per case (name, cfg, local state, global state, chunk): the
    window-sharded solve through `optimize_chunk_window_sharded` and
    through `SequenceOptimizer.optimize_chunk_sharded` (the case's config
    passed, so the guard is not measured)."""
    out = {}
    for name, cfg, local, glob, chunk in cases:
        opt = driver.SequenceOptimizer(driver.build_model(cfg), local, glob,
                                       cfg, mesh=mesh)
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, dtype=np.float32))
        res = optimize_chunk_window_sharded(
            opt.local_model, opt.global_model, f32(chunk.estimated_local),
            f32(chunk.camera_poses), f32(chunk.heatmaps),
            f32(chunk.gt_global), opt._camera_dev, cfg, mesh=mesh)
        out[name] = fields(res)
        out[name + "/driver"] = fields(opt.optimize_chunk_sharded(chunk,
                                                                  cfg=cfg))
    return out


def chunk_sharded(mesh, cfg, state, chunks, bank=None, bank_chunk=None
                  ) -> dict:
    """The chunk-sharded batched solve of `chunks` in both modes on both
    stagings, each staging's shape on this rank, its coverage and
    statistic; with `bank` ((name, state, statistic) entries) the
    window-sharded solve of `bank_chunk` with the bank and the name it
    chose."""
    opt = driver.SequenceOptimizer(driver.build_model(cfg), state, state,
                                   cfg, mesh=mesh)
    out = {}
    for on_host in (True, False):
        staged = opt.stage(chunks, on_host=on_host)
        where = "host" if on_host else "device"
        out[where] = {"rows": staged.est.shape[0],
                      "n_chunks": staged.n_chunks,
                      "coverage": staged.crop_coverage}
        for mode in ("flat", "vmap"):
            out[f"{where}-{mode}"] = fields(
                opt.optimize_chunks_batched(staged, mode=mode))
    if bank is not None:
        pb = PriorBank()
        for name, sd, stat in bank:
            pb.add(name, sd, sd, stat)
        bopt = driver.SequenceOptimizer(driver.build_model(cfg), state,
                                        state, cfg, mesh=mesh, prior_bank=pb)
        out["bank"] = fields(bopt.optimize_chunk_sharded(bank_chunk))
        out["bank_name"] = bopt.last_prior_name
        staged = bopt.stage(chunks, on_host=True)
        out["bank_stat"] = staged.accel_mean
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _moments(opt, model) -> dict:
    return {name: {k: v.numpy().copy() for k, v in opt.state[p].items()
                   if k in ("exp_avg", "exp_avg_sq")}
            for name, p in model.named_parameters()}


def dp_train(mesh, cfg: TrainConfig, hidden, windows, batch,
             test_len: int) -> dict:
    """`Trainer(num_devices=mesh.size)` at its own initialisation and noise
    (both from cfg.seed): one step on `batch` (the gradients, the
    metrics, the state and Adam's moments after it); then a fresh trainer
    through `cfg.epochs` epochs on `windows` (history, steps, state), and
    the eval on the first `test_len` windows before and after it (an odd
    length leaves a padded, masked last batch)."""
    def trainer():
        model = ConvVAE(latent_dim=cfg.latent_dim, seq_len=cfg.seq_length,
                        hidden_dims=hidden)
        return Trainer(cfg, AmassWindows(windows),
                       AmassWindows(windows[:test_len]), model,
                       device="cpu")

    tt = trainer()
    assert tt.mesh.size == mesh.size == max(1, cfg.num_devices)
    metrics = tt._train_step(tt._device_batch(batch), 0)
    step = {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.numpy().copy()
                      for n, p in tt.model.named_parameters()},
            "state": {k: v.numpy().copy()
                      for k, v in tt.model.state_dict().items()},
            "moments": _moments(tt.optimizer, tt.model)}
    run = trainer()
    eval0 = run.evaluate()
    logs = []
    run.train(log_fn=logs.append)
    return {"step": step, "history": run.history, "logs": logs,
            "steps": run.step, "eval0": eval0, "eval": run.evaluate(),
            "state": {k: v.numpy().copy()
                      for k, v in run.model.state_dict().items()}}


def dp_joint(mesh, cfg: TrainConfig, hidden, poses, cams, batch) -> dict:
    """`JointTrainer(num_devices=mesh.size)` at its own initialisation and
    noise (both from cfg.seed): one step on the rows `batch` of (poses,
    cams)."""
    model = JointLocalGlobalVAE(latent_dim=cfg.latent_dim,
                                seq_len=cfg.seq_length, hidden_dims=hidden)
    tt = JointTrainer(cfg, poses, cams, model, device="cpu")
    metrics = tt.train_step(tt._device_batch(poses[batch]),
                            tt._device_batch(cams[batch]))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.numpy().copy()
                      for n, p in tt.model.named_parameters()},
            "state": {k: v.numpy().copy()
                      for k, v in tt.model.state_dict().items()},
            "moments": _moments(tt.optimizer, tt.model)}


def several(mesh, calls) -> list:
    """Each (function name, args) of `calls` on this rank, in order: one
    group for a test module's checks."""
    return [globals()[name](mesh, *args) for name, args in calls]


def two_and_all(mesh, calls_all, calls_two) -> dict:
    """`calls_all` (as `several`) over every rank of `mesh`, then
    `calls_two` over ranks 0 and 1 alone, as a mesh of their own (a
    subgroup of the same processes: one spawn serves two mesh sizes).
    Returns {'all': [...], 'two': [...] or None}."""
    import torch.distributed as dist
    sub = dist.new_group([0, 1])      # every rank takes part in making it
    out = {"all": several(mesh, calls_all), "two": None}
    if mesh.rank < 2:
        two = pm.Mesh(sub, mesh.backend, mesh.rank, 2, mesh.device)
        out["two"] = several(two, calls_two)
    return out


# ---------------------------------------------------------------------------
# the sample init over ranks
# ---------------------------------------------------------------------------

def sample_sharded(mesh, cases) -> dict:
    """Per case (name, cfg, state, chunks, mode): the chunk-sharded
    batched solve of `chunks` in `mode` ('flat' or 'vmap'), or with mode
    'window' the window-sharded solve of chunks[0]."""
    out = {}
    for name, cfg, state, chunks, mode in cases:
        opt = driver.SequenceOptimizer(driver.build_model(cfg), state, state,
                                       cfg, mesh=mesh)
        if mode == "window":
            out[name] = fields(opt.optimize_chunk_sharded(chunks[0], cfg=cfg))
        else:
            out[name] = fields(opt.optimize_chunks_batched(
                opt.stage(chunks, on_host=True), mode=mode))
    return out


# ---------------------------------------------------------------------------
# serve and evaluate_all over ranks
# ---------------------------------------------------------------------------

def _captured(fn, *args):
    """(fn(*args), what it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn(*args)
    return value, buf.getvalue()


def arrive_on_sleep(root: str, name: str, src: str, write: bool):
    """A stand-in for serve's time.sleep: at the first idle pass the
    sequence directory `src` is copied to `root/name` (by the caller's
    rank 0 alone, `write`), as a capture arriving mid-run."""
    import shutil

    def sleep(_):
        if write and not os.path.exists(os.path.join(root, name)):
            shutil.copytree(src, os.path.join(root, name))
    return sleep


def cli_ranks(mesh, serve_argv, eval_argv, watch=None) -> dict:
    """serve's and evaluate_all's `main` on this rank of the group (they
    take the default group, as under torchrun): their values and what
    each printed; with `watch` = (argv, root, name, src) also serve in
    watch mode with a sequence arriving at its first idle pass."""
    from globalegomocap_tpu_torch.cli import evaluate_all, serve
    out = {"serve": _captured(serve.main, serve_argv),
           "eval": _captured(evaluate_all.main, eval_argv),
           "rank": mesh.rank}
    if watch is not None:
        argv, root, name, src = watch
        real = serve.time.sleep
        serve.time.sleep = arrive_on_sleep(root, name, src, mesh.rank == 0)
        try:
            out["watch"] = _captured(serve.main, argv)
        finally:
            serve.time.sleep = real
    return out


def prefetch_under_gathers(mesh, cfg, state, batches, lag: float) -> list:
    """Stage `batches` on a StagePrefetcher (depth 2, the guard measured
    on every batch, so every staging all-reduces the coverage) while the
    main thread solves and gathers each batch.  Rank 0's source hands
    its batches out at once, the other ranks' each `lag` seconds late:
    rank 0's worker then issues its next all_reduce before its main
    thread's all_gather, the other ranks after it.  Returns each batch's
    gathered fields."""
    import time

    from globalegomocap_tpu_torch.optimize.streaming import StagePrefetcher
    opt = driver.SequenceOptimizer(driver.build_model(cfg), state, state,
                                   cfg, mesh=mesh)

    def source():
        for i, b in enumerate(batches):
            if i and mesh.rank:
                time.sleep(lag)
            yield b

    return [fields(opt.optimize_chunks_batched(staged, mode="flat"))
            for staged in StagePrefetcher(opt, source(), depth=2,
                                          on_host=True, guard="every")]
