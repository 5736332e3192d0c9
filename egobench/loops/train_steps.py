"""A train cell (mix kind `train_steps`): the prior's train step back to back over a corpus of
windows, as the port's `Trainer` feeds it.

Set-up builds one `Trainer` (the model on the device from the weights
drawn from the seed, Adam), and drives it through its first
`check_steps` steps with the window's own call and feed
(`AmassWindows.epoch_batches` under the trainer's numpy generator, a
pinned copy a batch, `Trainer._run`); those steps are also the warm-up.
The same object then trains through the window, across epochs, with a
`synchronize()` closing it.  A step whose loss is not finite counts as
failed; the losses are read once the window has closed.

Host span, the benchmark's own: `step` around each call of the
trainer's step (the enqueue).

After the window the reference (`egobench/reference/train.py`) follows
the first steps from the same weights, batches and seed: each step's
loss, the first gradient (as Adam holds it after one step) and every
parameter's change over the steps are compared.
"""

from __future__ import annotations

import time

import numpy as np

from egobench.counts import flops
from egobench.harness import common, traffic
from egobench.harness.common import Run
from egobench.harness.weights import draw_state, prior_seeds
from egobench.reference import train as ref


# the program's own path below the configuration's float32: the step in
# bfloat16 (the step one below, TF32, the program pins off; the reference
# takes it in `controls`)
PROGRAM_CONTROLS = {"bfloat16": {"compute_dtype": "bfloat16"}}


def trainer_config(cfg: dict, mix: dict, seed: int, program=None):
    """The program's TrainConfig; `program` overrides the configuration's
    options (a control)."""
    from globalegomocap_tpu_torch.config import TrainConfig
    t = dict(cfg["train"], **(program or {}))
    return TrainConfig(latent_dim=t["latent_dim"], seq_length=t["seq_length"],
                       fps=t["fps"], kl_weight=t["kl_weight"],
                       batch_size=int(mix["batch"]),
                       learning_rate=t["learning_rate"],
                       compute_dtype=t["compute_dtype"],
                       local_pose=t["local_pose"], seed=int(seed) % (1 << 31),
                       epochs=1, log_step=0)


def run(torch, ctx) -> tuple:
    """One run of a train cell: (run record, result parts, checks);
    `ctx` is `common.context(...)`."""
    from globalegomocap_tpu_torch.data.amass import AmassWindows
    from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
    from globalegomocap_tpu_torch.train.train_vae import Trainer
    from egobench.harness.trace import Tracer

    cfg, mix, seed, device = ctx.cfg, ctx.mix, ctx.seed, ctx.device
    rec = Run()
    prior = cfg["prior"]
    tcfg = trainer_config(cfg, mix, seed, ctx.program)
    state = draw_state(torch, prior, prior_seeds(seed)[1], device)
    start = {k: v.detach().clone() for k, v in state.items()}
    common.mark(ctx, "weights")
    windows = traffic.training_corpus(mix, seed)
    common.mark(ctx, "corpus")
    model = ConvVAE(prior["in_channels"], prior["in_channels"],
                    prior["latent_dim"], prior["seq_len"],
                    tuple(prior["hidden_dims"]),
                    dtype=(torch.bfloat16 if tcfg.compute_dtype == "bfloat16"
                           else torch.float32),
                    logvar_bias_init=tcfg.logvar_init_bias)
    trainer = Trainer(tcfg, AmassWindows(windows),
                      AmassWindows(windows[:tcfg.batch_size]), model=model,
                      device=device, variables=state)
    del state
    common.mark(ctx, "program")
    losses: list = []
    trainer._train_step = rec.spans.wrap(
        "step", trainer._train_step,
        after=lambda out, _a, _b: losses.append(out["loss"]))
    np_rng = np.random.default_rng(tcfg.seed + 2)
    zero = torch.zeros((), device=device)
    running = {"loss": zero, "recon_loss": zero}

    def batches():
        while True:
            yield from trainer.train_ds.epoch_batches(np_rng,
                                                      tcfg.batch_size)

    feed = batches()
    order = []

    note = torch.profiler.record_function

    def step():
        with note("egobench.next_batch"):
            batch = next(feed)
            if len(order) < n_check:
                order.append(batch)
            dev_batch = trainer._device_batch(batch)
        with note("egobench.step"):
            trainer._run([dev_batch], running)

    # the first steps: the checked ones, and the warm-up
    n_check = int(mix["check_steps"])
    opt = trainer.optimizer
    got = {"losses": []}
    for i in range(n_check):
        step()
        got["losses"].append(float(losses[-1]))
        if i == 0:
            # the gradient as Adam holds it: exp_avg = (1 - beta1) g
            got["grad"] = {
                n: (opt.state[p]["exp_avg"] / (1 - ref.BETAS[0])).detach()
                .clone() if "exp_avg" in opt.state.get(p, {})
                else torch.zeros_like(p)
                for n, p in trainer.model.named_parameters()}
    got["delta"] = {n: (p.detach() - start[n]).clone()
                    for n, p in trainer.model.named_parameters()}
    for _ in range(int(mix["warmup_steps"])):
        step()
    losses.clear()
    tracer = (Tracer(torch, float(mix["trace_seconds"]),
                     float(mix["trace_lead_seconds"]))
              if ctx.trace and device.type == "cuda" else None)
    if device.type == "cuda":
        torch.cuda.synchronize()

    # the host's per-layer readings end where the profiler starts, at a
    # synchronize, so that they count finished steps only
    t_start = time.perf_counter()
    t_end = t_start + ctx.seconds
    common.mark(ctx, "warm-up")
    host_end, host_steps = None, None
    while True:
        step()
        now = time.perf_counter()
        if tracer is not None:
            if not tracer.started and host_end is None \
                    and now >= t_end - tracer.seconds - tracer.lead:
                torch.cuda.synchronize()
                host_end, host_steps = time.perf_counter(), len(losses)
            tracer.due(now, t_end)
        if now >= t_end:
            break
    if tracer is not None and tracer.started:
        tracer.end()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    if tracer is not None and tracer.started:
        rec.trace = tracer.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    vals = torch.stack(losses).cpu().numpy()
    failed = int((~np.isfinite(vals)).sum())
    steps = len(vals)
    span = t_end - t_start
    host_end = host_end or t_end
    rec.window = (t_start, host_end)
    rec.facts = {"step_s": (host_end - t_start) / (host_steps or steps),
                 "flops_per_step": flops.train_step_flops(
                     prior, tcfg.batch_size)}
    print(f"egobench: {steps} steps of {tcfg.batch_size} in {span:.3f} s, "
          f"{failed} with a loss that is not finite", flush=True)
    kld_weight = tcfg.kl_weight * tcfg.batch_size / len(windows)
    del trainer, opt, running, losses
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = ref.first_steps(start, order, tcfg.seed, prior, kld_weight,
                           tcfg.learning_rate, device)
    checks = {k: {"value": v, "limit": ctx.limits[k]}
              for k, v in compare(got, want).items()}
    metrics = {"train_windows_per_s": steps * tcfg.batch_size / span,
               "setup_s": t_start - ctx.t0}
    return rec, {"attempted": steps, "failed": failed, "metrics": metrics,
                 "peak": peak}, checks


def controls(torch, ctx) -> dict:
    """The reference's control and fault over the first steps of a run
    of `ctx.seed`: the reference with its products in TF32 (the step
    below float32 with TF32 off), and half of each batch left out, each
    against the reference; {"tf32": numbers, "half_batch": numbers}."""
    cfg, mix, seed, device = ctx.cfg, ctx.mix, ctx.seed, ctx.device
    windows = traffic.training_corpus(mix, seed)
    tcfg = trainer_config(cfg, mix, seed)
    state = draw_state(torch, cfg["prior"], prior_seeds(seed)[1], device)
    rng = np.random.default_rng(tcfg.seed + 2)
    order = rng.permutation(len(windows))
    b = tcfg.batch_size
    batches = [windows[order[i * b:(i + 1) * b]]
               for i in range(int(mix["check_steps"]))]
    kw = dict(seed=tcfg.seed, prior=cfg["prior"],
              kld_weight=tcfg.kl_weight * b / len(windows),
              lr=tcfg.learning_rate, device=device)
    want = ref.first_steps(state, batches, **kw)
    tf32 = ref.first_steps(state, batches, tf32_on=True, **kw)
    half = ref.first_steps(state, [x[:b // 2] for x in batches], **kw)
    return {"tf32": compare(tf32, want), "half_batch": compare(half, want)}


def leaf_norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def compare(got: dict, want: dict) -> dict:
    """The gaps of the program's first steps to the reference's: the
    worst step's relative loss gap; over the leaves, the worst gap of the
    first gradient's norm and of the change's norm, each against the
    reference's norm of the leaf or of the median leaf, whichever is
    larger.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the
    change."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(got["losses"], want["losses"]))
    gp, gr = leaf_norms(got["grad"]), leaf_norms(want["grad"])
    g_med = float(np.median(list(gr.values())))
    grad = max(abs(gp[k] - gr[k]) / max(gr[k], g_med) for k in gr)
    dp, dr = leaf_norms(got["delta"]), leaf_norms(want["delta"])
    moving = [k for k in dr if gr[k] >= 1e-3 * g_med]
    d_med = float(np.median([dr[k] for k in moving]))
    step = max(abs(dp[k] - dr[k]) / max(dr[k], d_med) for k in moving)
    return {"loss_gap": loss, "grad_gap": grad, "step_gap": step}
