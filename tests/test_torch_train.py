"""The port's prior training (`train/train_vae.py`, the training surface
of `models/conv_vae.py`, the optimizer-state converter and the epoch
checkpoints) against the JAX package's trainer, on the JAX train test's
tiny model (latent 32, hidden (16, 16, 32, 32, 64)), its corpus
(`synthetic_amass(3, 80, seed=1)`, local windows) and batch 32.

The JAX trainer runs on the 8 virtual CPU devices of tests/conftest.py;
its jit is global, so its batch statistics are those of one device.
The port's trainer runs at its defaults: Flax's initial weights from
cfg.seed (held against the JAX trainer's, leaf for leaf, within 1e-6 of
each leaf's largest magnitude) and JAX's own reparameterisation noise,
`normal(fold_in(PRNGKey(seed + 1), step))`, so the port follows the JAX
trainer's whole trajectory from the same seed.

Tolerances: a train-mode forward 1e-5 relative (1e-6 absolute), one
step's losses 1e-5 relative and gradients 1e-4 relative (1e-6 absolute);
parameters after an update within 2.5 lr, the bound JAX's own test puts
on two compilations of one step (Adam's normalised first update turns
rounding on near-zero gradients into +-lr flips); a 2-epoch run's logged
losses and evals within 5 %; bf16 compute 2e-2."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tests.torch_port_helpers import hold, hold_init, jax_variables
import torch
from globalegomocap_tpu.config import TrainConfig as JCfg
from globalegomocap_tpu.data.amass import AmassWindows as JWindows
from globalegomocap_tpu.data.synthetic import synthetic_amass
from globalegomocap_tpu.models import conv_vae as jvae
from globalegomocap_tpu.train.train_vae import Trainer as JTrainer
from globalegomocap_tpu_torch.config import TrainConfig as TCfg
from globalegomocap_tpu_torch.data.amass import AmassWindows as TWindows
from globalegomocap_tpu_torch.models import conv_vae as tvae
from globalegomocap_tpu_torch.models.convert import params_from_flax
from globalegomocap_tpu_torch.train import train_vae as ttrain

HIDDEN = (16, 16, 32, 32, 64)
LR = 2e-3
BASE = dict(latent_dim=32, seq_length=10, epochs=2, batch_size=32,
            kl_weight=0.5, log_step=0, learning_rate=LR)
OPTIMIZERS = {
    "adam": {},
    "cosine": dict(lr_schedule="cosine", lr_warmup_steps=3, lr_final=1e-5),
    "adamw": dict(weight_decay=1e-4),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def jax_noise(seed: int):
    """The JAX trainer's noise of step `step`: fn(step, shape, dtype)."""
    key = jax.random.PRNGKey(seed)

    def noise(step, shape, dtype):
        jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        z = jax.random.normal(jax.random.fold_in(key, step), tuple(shape),
                              jd)
        return torch.from_numpy(np.asarray(z.astype(jnp.float32))).to(dtype)

    return noise


@pytest.fixture(scope="module")
def data():
    seqs = synthetic_amass(n_sequences=3, frames_per_seq=80, seed=1)
    return JWindows.from_sequences(seqs, frame_num=10, local_pose=True)


def jax_trainer(data, dtype=jnp.float32, **kw):
    cfg = JCfg(**dict(BASE, **kw))
    model = jvae.ConvVAE(latent_dim=32, seq_len=10, hidden_dims=HIDDEN,
                         dtype=dtype)
    return JTrainer(cfg, data, JWindows(data.windows[:64]), model)


def port_trainer(data, jt, dtype=torch.float32, **kw):
    """The port's trainer of `jt`'s configuration at its defaults (Flax's
    initialisation from cfg.seed, JAX's noise); where `jt` has taken no
    step, its initial weights are held against `jt`'s (`hold_init`)."""
    cfg = TCfg(**dict(BASE, **kw))
    model = tvae.ConvVAE(latent_dim=32, seq_len=10, hidden_dims=HIDDEN,
                         dtype=dtype)
    windows = TWindows(np.array(data.windows))
    tt = ttrain.Trainer(cfg, windows, TWindows(windows.windows[:64]), model,
                        device="cpu")
    if int(jt.state.step) == 0:
        hold_init(tt.model.state_dict(), params_from_flax(_np(jt.variables)))
    return tt


# ---------------------------------------------------------------------------
# the model in train mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def forward_case(data):
    """One batch through JAX's train-mode forward with the mutated
    batch_stats, in float32 and (the exact function) float64, from
    variables with random running statistics, with the same noise."""
    model = jvae.ConvVAE(latent_dim=32, seq_len=10, hidden_dims=HIDDEN)
    v = _np(jax_variables(model, seed=3))
    batch = data.windows[:32]
    noise = jax_noise(1)(0, (32, 32), torch.float32)
    out = {}
    for dt in (jnp.float32, jnp.float64):
        with jax.enable_x64(dt == jnp.float64):
            m = jvae.ConvVAE(latent_dim=32, seq_len=10, hidden_dims=HIDDEN,
                             dtype=dt)
            w = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), v)
            (mu, lv), upd = m.apply(w, jnp.asarray(batch, dt), True,
                                    mutable=["batch_stats"],
                                    method=jvae.ConvVAE.encode)
            z = mu + jnp.asarray(noise.numpy(), dt) * jnp.exp(0.5 * lv)
            recon, upd2 = m.apply({"params": w["params"],
                                   "batch_stats": upd["batch_stats"]}, z,
                                  True, mutable=["batch_stats"],
                                  method=jvae.ConvVAE.decode)
            stats = dict(upd["batch_stats"], **{
                k: s for k, s in upd2["batch_stats"].items()
                if not k.startswith("enc_")})
            out[np.dtype(dt).name] = (_np((recon, mu, lv)), _np(stats))
    return v, batch, noise, out


def _torch_unbiased_bn(bn, x, mesh=None):
    """What torch.nn.BatchNorm1d's train mode would do (on one rank)."""
    return torch.nn.functional.batch_norm(
        x, bn.running_mean, bn.running_var, bn.weight, bn.bias, True, 0.1,
        bn.eps)


@pytest.mark.parametrize("bn", ["flax", "torch_unbiased"])
def test_train_mode_forward_matches_jax(forward_case, monkeypatch, bn):
    """reconstruction, mu and log_var of a train-mode forward with the
    same noise, and the updated running statistics, against the JAX
    model's float32 run and its exact (float64) function.

    JAX's own float32 train-mode forward is up to 1.4e-4 from its float64
    one here (its batch-statistic reductions in float32; in eval mode the
    two agree to 3e-7).  So the port is held to be no further from the
    exact function than JAX's float32 run is, and (what follows from it)
    within rtol 1e-5 of JAX's float32 outputs plus twice the float32
    error of JAX's own run.
    Flax moves the running variance towards the biased batch variance;
    the running statistics agree within 1e-5 relative.  With torch's
    unbiased update in its place the running variances miss by n/(n-1)
    (n = B*T = 320) diluted by the momentum, beyond the 1e-5."""
    v, batch, noise, out = forward_case
    (r32, s32), (r64, s64) = out["float32"], out["float64"]
    if bn == "torch_unbiased":
        monkeypatch.setattr(tvae, "_batch_norm_train", _torch_unbiased_bn)
    m = tvae.ConvVAE(latent_dim=32, seq_len=10, hidden_dims=HIDDEN)
    m.load_state_dict(params_from_flax(v))
    got = [x.detach().numpy() for x in m(torch.from_numpy(batch),
                                         train=True, noise=noise)]
    for name, g, w32, w64 in zip(("recon", "mu", "log_var"), got, r32, r64):
        hold(g, w32, w64, 1e-5, 1e-6, name)
    state = m.state_dict()
    new32, new64 = (params_from_flax({"params": v["params"],
                                      "batch_stats": s}) for s in (s32, s64))
    worst = max(float(np.max(np.abs(state[k].numpy() / new32[k].numpy()
                                    - 1)))
                for k in new32 if k.endswith("running_var"))
    if bn == "flax":
        assert worst <= 1e-5, worst
        for k in new32:
            if "running" in k:
                hold(state[k], new32[k], new64[k], 1e-5, 1e-7, k)
    else:
        assert worst > 1e-4, worst


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_vae_loss_matches_jax(reduction):
    rng = np.random.default_rng(0)
    recon, target = (rng.normal(size=(8, 10, 45)).astype(np.float32)
                     for _ in range(2))
    mu, log_var = (rng.normal(size=(8, 32)).astype(np.float32) * 0.3
                   for _ in range(2))
    j = jvae.vae_loss(*(jnp.asarray(x) for x in (recon, target, mu,
                                                 log_var)), 0.07,
                      reduction=reduction)
    t = tvae.vae_loss(*(torch.from_numpy(x) for x in (recon, target, mu,
                                                      log_var)), 0.07,
                      reduction=reduction)
    for a, b in zip(t, j):
        assert float(a) == pytest.approx(float(b), rel=1e-5)


def test_sample_prior_decodes_given_latents():
    model = jvae.ConvVAE(latent_dim=32, seq_len=10, hidden_dims=HIDDEN)
    v = jax_variables(model, seed=4)
    z = np.random.default_rng(1).normal(size=(5, 32)).astype(np.float32)
    j = model.apply(v, jnp.asarray(z), False, method=jvae.ConvVAE.decode)
    m = tvae.ConvVAE(latent_dim=32, seq_len=10, hidden_dims=HIDDEN)
    m.load_state_dict(params_from_flax(_np(v)))
    t = tvae.sample_prior(m, 5, z=torch.from_numpy(z))
    assert t.shape == (5, 10, 15, 3)
    np.testing.assert_allclose(t.detach().numpy(),
                               np.asarray(j).reshape(5, 10, 15, 3),
                               rtol=1e-5, atol=1e-6)
    g = tvae.sample_prior(m, 3, seed=2)
    want = jvae.sample_prior(model, v, 3, jax.random.PRNGKey(2))
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def _jax_grads(jt, batch, dt):
    """JAX's step 0 on `batch` from `jt`'s state, computed at dtype `dt`:
    (loss, recon, kld), the gradients and the mutated batch_stats."""
    rng = jax.random.fold_in(jax.random.PRNGKey(jt.cfg.seed + 1), 0)
    kld_w = jt.cfg.kl_weight * jt.cfg.batch_size / len(jt.train_ds)
    state = _np(jt.state)
    with jax.enable_x64(dt == jnp.float64):
        model = jt.model.clone(dtype=dt)
        params, stats, x = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dt),
            (state.params, state.batch_stats, batch))

        def loss_fn(params):
            out, upd = model.apply({"params": params, "batch_stats": stats},
                                   x, True, rng, mutable=["batch_stats"])
            if dt == jnp.float64:   # JAX's float32 noise, as the port's
                z32 = jax.random.normal(rng, out.mu.shape, jnp.float32)
                z = out.mu + z32.astype(dt) * jnp.exp(0.5 * out.log_var)
                recon, upd2 = model.apply(
                    {"params": params, "batch_stats": stats}, z, True,
                    mutable=["batch_stats"], method=jvae.ConvVAE.decode)
                out = out._replace(reconstruction=recon)
                upd = {"batch_stats": dict(upd["batch_stats"], **{
                    k: s for k, s in upd2["batch_stats"].items()
                    if not k.startswith("enc_")})}
            loss, recon, kld = jvae.vae_loss(out.reconstruction, x, out.mu,
                                             out.log_var, kld_w)
            return loss, (recon, kld, upd["batch_stats"])

        (loss, (recon, kld, new)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return (float(loss), float(recon), float(kld)), _np(grads), _np(new)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_one_train_step_matches_jax(data, opt):
    """From the same state and noise: the losses (1e-5), every gradient
    (1e-4, against JAX's float32 and float64 steps as `hold` says), the
    parameters after the update (2.5 lr), the running statistics (1e-5)
    and Adam's moments and count."""
    jt = jax_trainer(data, **OPTIMIZERS[opt])
    tt = port_trainer(data, jt, **OPTIMIZERS[opt])
    batch = data.windows[32:64]
    (jl, g32, n32), (_, g64, n64) = (_jax_grads(jt, batch, dt)
                                     for dt in (jnp.float32, jnp.float64))
    metrics = tt._train_step(torch.from_numpy(batch), 0)
    for k, want in zip(("loss", "recon_loss", "kld_loss"), jl):
        assert float(metrics[k]) == pytest.approx(want, rel=1e-5), k
    grad32, grad64 = (params_from_flax({"params": g, "batch_stats": n})
                      for g, n in ((g32, n32), (g64, n64)))
    for name, p in tt.model.named_parameters():
        hold(p.grad.numpy(), grad32[name], grad64[name], 1e-4, 1e-6, name)
    got = tt.model.state_dict()
    for name in grad32:
        if "running" in name:
            hold(got[name], grad32[name], grad64[name], 1e-5, 1e-7, name)
    jt.state, _ = jt._train_step(jt.state, jt._device_batch(batch),
                                 jax.random.PRNGKey(jt.cfg.seed + 1))
    want = params_from_flax(_np(jt.variables))
    for name, _ in tt.model.named_parameters():
        gap = float(np.max(np.abs(got[name].numpy() - want[name].numpy())))
        assert gap <= 2.5 * LR, (name, gap)
    jo, to = _np(jt.state.opt_state), tt.opt_state()
    assert set(to) == {str(i) for i in range(len(jo))}
    assert int(to["0"]["count"]) == int(jo[0].count) == 1
    if opt == "cosine":
        assert int(to[str(len(jo) - 1)]["count"]) == 1
    exact = {"mu": jax.tree_util.tree_map(lambda g: 0.1 * g, g64),
             "nu": jax.tree_util.tree_map(lambda g: 0.001 * g * g, g64)}
    for leaf in ("mu", "nu"):
        for a, b, c in zip(jax.tree_util.tree_leaves(to["0"][leaf]),
                           jax.tree_util.tree_leaves(getattr(jo[0], leaf)),
                           jax.tree_util.tree_leaves(exact[leaf])):
            # the gradients are held above; here JAX's moments, within
            # what its float32 gradients' own error allows
            jax_err = float(np.max(np.abs(b - c)))
            np.testing.assert_allclose(
                a, b, rtol=1e-4, err_msg=leaf,
                atol=(1e-7 if leaf == "mu" else 1e-12) + 2 * jax_err)


SCHEDULES = [(3, 20), (0, 20), (50, 20), (3, 1), (0, 0), (5, 6)]


@pytest.mark.parametrize("warmup,total", SCHEDULES)
def test_schedule_matches_optax(warmup, total):
    """make_optimizer's learning rate at every step 0..total (and past
    it) against optax.warmup_cosine_decay_schedule as the JAX
    make_optimizer builds it; total 0 is the constant rate."""
    cfg = TCfg(**dict(BASE, lr_schedule="cosine", lr_warmup_steps=warmup,
                      lr_final=1e-5))
    spec = ttrain.make_optimizer(cfg, total_steps=total)
    if total == 0:
        assert spec.schedule is None
        assert spec.lr_at(0) == spec.lr_at(7) == LR
        return
    warm = min(warmup, max(total - 1, 0))
    ref = optax.warmup_cosine_decay_schedule(0.0 if warm else LR, LR, warm,
                                             total, 1e-5)
    for step in range(total + 3):
        want = float(ref(step))
        assert spec.lr_at(step) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_warmup_runs_step_one_at_lr_zero_and_moves_the_moments(data):
    """With warmup, optax's first update runs at lr 0: the parameters stay
    while Adam's moments and count move."""
    jt = jax_trainer(data, **OPTIMIZERS["cosine"])
    tt = port_trainer(data, jt, **OPTIMIZERS["cosine"])
    before = {k: v.clone() for k, v in tt.model.named_parameters()}
    tt._train_step(torch.from_numpy(data.windows[:32]), 0)
    for k, p in tt.model.named_parameters():
        torch.testing.assert_close(p.detach(), before[k], rtol=0, atol=0)
    to = tt.opt_state()
    assert int(to["0"]["count"]) == 1
    assert max(float(np.abs(x).max()) for x in
               jax.tree_util.tree_leaves(to["0"]["mu"])) > 0


def test_bfloat16_step_matches_jax(data):
    """compute_dtype bfloat16: one step with bf16 noise gives JAX's bf16
    step's loss within 2e-2; the parameters stay float32."""
    jt = jax_trainer(data, dtype=jnp.bfloat16, compute_dtype="bfloat16")
    tt = port_trainer(data, jt, dtype=torch.bfloat16,
                      compute_dtype="bfloat16")
    batch = data.windows[:32]
    jt.state, jm = jt._train_step(jt.state, jt._device_batch(batch),
                                  jax.random.PRNGKey(1))
    tm = tt._train_step(torch.from_numpy(batch), 0)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-2)
    assert float(tm["recon_loss"]) == pytest.approx(
        float(jm["recon_loss"]), rel=2e-2)
    assert all(p.dtype == torch.float32 for p in tt.model.parameters())
    assert all(v.dtype == torch.float32 for st in tt.optimizer.state.values()
               for k, v in st.items() if k != "step")


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(data):
    """2 epochs at log_step 2 of both trainers from the same weights, per
    loop kind: the eager loop and epoch_scan at scan_block 2."""
    out = {}
    for kind, kw in (("eager", {}), ("scan", dict(epoch_scan=True,
                                                  scan_block=2))):
        jt = jax_trainer(data, log_step=2, **kw)
        tt = port_trainer(data, jt, log_step=2, **kw)
        jlogs, tlogs = [], []
        jt.train(log_fn=jlogs.append)
        tt.train(log_fn=tlogs.append)
        out[kind] = (jt, tt, jlogs, tlogs)
    return out


def _worst_gap(jh, th):
    gaps = []
    for a, b in zip(th, jh):
        for k in ("loss", "recon_loss", "eval_mpjpe"):
            if k in b:
                gaps.append(abs(a[k] - b[k]) / abs(b[k]))
    return max(gaps)


@pytest.mark.parametrize("kind", ["eager", "scan"])
def test_short_run_follows_jax(runs, kind):
    """History rows in the same number, with the same keys and steps;
    every logged loss and eval within 5 % of JAX's; the same step count
    and the same motion_stats."""
    jt, tt, jlogs, tlogs = runs[kind]
    assert len(tt.history) == len(jt.history) > 2
    for a, b in zip(tt.history, jt.history):
        assert set(a) == set(b)
        assert a.get("step") == b.get("step")
        assert a.get("epoch") == b.get("epoch")
    gap = _worst_gap(jt.history, tt.history)
    print(f"{kind}: worst relative gap {gap:.3e}")
    assert gap <= 0.05, gap
    assert len(tlogs) == len(jlogs)
    assert tt.step == int(jt.state.step) == 2 * (len(jt.train_ds) // 32)
    assert tt.motion_stats["accel_mean"] == pytest.approx(
        jt.motion_stats["accel_mean"], rel=1e-6)


@pytest.mark.parametrize("block,runs", [(4, [4, 2]), (5, [5, 1])])
def test_scan_block_keeps_jax_block_structure(data, block, runs):
    """epoch_scan over 6 steps an epoch: full blocks, then a trailing
    block of two or more steps as a block, a single leftover step on its
    own; one log line an epoch at log_step 4, at JAX's steps."""
    jt = jax_trainer(data, log_step=4, epoch_scan=True, scan_block=block)
    tt = port_trainer(data, jt, log_step=4, epoch_scan=True,
                      scan_block=block)
    blocks = []
    run = tt._run
    tt._run = lambda b, r: blocks.append(len(b)) or run(b, r)
    jt.train(log_fn=lambda *_: None)
    tt.train(log_fn=lambda *_: None)
    assert blocks == runs * 2
    assert tt.step == int(jt.state.step) == 12
    assert [h.get("step") for h in tt.history] == \
        [h.get("step") for h in jt.history]


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------

def _moments_equal(a, b):
    for leaf in ("mu", "nu"):
        la = jax.tree_util.tree_leaves(a["0"][leaf] if isinstance(a, dict)
                                       else getattr(a[0], leaf))
        lb = jax.tree_util.tree_leaves(b["0"][leaf] if isinstance(b, dict)
                                       else getattr(b[0], leaf))
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_jax_checkpoint_resumes_in_the_port(data, tmp_path):
    """JAX Trainer.save_checkpoint -> the port's load_checkpoint: the same
    eval, moments, count and step."""
    jt = jax_trainer(data, epochs=1, log_step=0)
    tt = port_trainer(data, jt, epochs=1)
    jt.train(log_fn=lambda *_: None)
    path = jt.save_checkpoint(str(tmp_path), 0, jt.evaluate())
    assert tt.load_checkpoint(path) == int(jt.state.step) == 6
    assert tt.evaluate() == pytest.approx(jt.evaluate(), rel=1e-5)
    to, jo = tt.opt_state(), _np(jt.state.opt_state)
    assert int(to["0"]["count"]) == int(jo[0].count) == 6
    _moments_equal(to, jo)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_port_checkpoint_resumes_in_jax(data, tmp_path, opt):
    """The port's save_checkpoint -> JAX Trainer.load_checkpoint (flax's
    from_bytes into the trainer's target, which refuses any other tree):
    the same eval, moments, count and step, for each optimizer."""
    jt = jax_trainer(data, epochs=1, **OPTIMIZERS[opt])
    tt = port_trainer(data, jt, epochs=1, **OPTIMIZERS[opt])
    tt.train(log_fn=lambda *_: None, checkpoint_dir=str(tmp_path))
    jt.load_checkpoint(str(tmp_path / "0.msgpack"))
    assert int(jt.state.step) == tt.step == 6
    assert jt.evaluate() == pytest.approx(tt.evaluate(), rel=1e-5)
    jo = _np(jt.state.opt_state)
    assert int(jo[0].count) == 6
    if opt == "cosine":
        assert int(jo[-1].count) == 6
    _moments_equal(tt.opt_state(), jo)


def test_port_checkpoint_of_another_optimizer_is_refused(data, tmp_path):
    """An Adam checkpoint, msgpack file or Orbax directory, resumed by an
    AdamW trainer: ValueError naming opt_state."""
    jt = jax_trainer(data, epochs=1)
    tt = port_trainer(data, jt, epochs=1)
    path = tt.save_checkpoint(str(tmp_path), 0, 1.0)
    orbax_dir = tt.save_checkpoint(str(tmp_path), 0, 1.0, fmt="orbax")
    other = port_trainer(data, jt, epochs=1, **OPTIMIZERS["adamw"])
    with pytest.raises(ValueError, match="opt_state"):
        other.load_checkpoint(path)
    with pytest.raises(ValueError, match="opt_state"):
        other.load_checkpoint(orbax_dir)


def test_epoch_checkpoint_loads_as_a_prior_in_both_clis(data, tmp_path):
    """A port-written epoch checkpoint is a prior for both packages'
    cli/optimize_sequence.py::load_variables and load_prior_variables:
    they decode the same poses; the .json sidecars of both trainers have
    the same keys."""
    from globalegomocap_tpu.cli.optimize_sequence import (
        load_variables as jload)
    from globalegomocap_tpu.models.checkpoint import (
        load_prior_variables as jprior)
    from globalegomocap_tpu_torch.cli.optimize_sequence import (
        load_variables as tload)
    from globalegomocap_tpu_torch.models.checkpoint import (
        load_prior_variables as tprior)
    jt = jax_trainer(data, epochs=1)
    tt = port_trainer(data, jt, epochs=1)
    tt.train(log_fn=lambda *_: None, checkpoint_dir=str(tmp_path / "t"))
    jt.train(log_fn=lambda *_: None, checkpoint_dir=str(tmp_path / "j"))
    path = str(tmp_path / "t" / "0.msgpack")
    z = np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)
    jv = jload(path, 10, HIDDEN)
    jp = jt.model.apply(jv, jnp.asarray(z), False,
                        method=jvae.ConvVAE.decode)
    m = tvae.ConvVAE(latent_dim=32, seq_len=10, hidden_dims=HIDDEN).eval()
    m.load_state_dict(tload(path, m))
    tp = m.decode(torch.from_numpy(z)).detach().numpy()
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(tprior(path, 10, HIDDEN)),
                    jax.tree_util.tree_leaves(_np(jprior(path, 10,
                                                         HIDDEN)))):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="hidden dims"):
        tprior(path, 10, (8, 8, 16, 16, 32))
    with open(tmp_path / "t" / "0.json") as f:
        tmeta = json.load(f)
    with open(tmp_path / "j" / "0.json") as f:
        jmeta = json.load(f)
    assert set(tmeta) == set(jmeta) == {"epoch", "eval_result", "args",
                                        "motion_stats"}
    assert set(tmeta["args"]) == set(jmeta["args"])
    assert tmeta["args"] == jmeta["args"]
    assert tmeta["epoch"] == jmeta["epoch"] == 1
    assert os.path.exists(tmp_path / "t" / "0.msgpack")


# ---------------------------------------------------------------------------
# the Flax-like initialiser
# ---------------------------------------------------------------------------

def test_flax_like_init_matches_flax_at_full_width():
    """At the prior's full width, `init_flax_like(model, 0)` is Flax's
    `init(PRNGKey(0))` leaf for leaf (within 1e-6 of each leaf's largest
    magnitude): the kernels' truncated normals, the biases 0, fc_var's
    bias logvar_bias_init, BN scale 1, bias 0, mean 0, var 1."""
    jm = jvae.ConvVAE(logvar_bias_init=-2.0)
    jv = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 10, 45)), False))
    want = params_from_flax(jv)
    m = tvae.ConvVAE(logvar_bias_init=-2.0)
    tvae.init_flax_like(m, 0)
    got = m.state_dict()
    hold_init(got, want)
    bns = {n for n, mod in m.named_modules()
           if isinstance(mod, torch.nn.BatchNorm1d)}
    for k, v in got.items():
        if not (k.endswith("weight") and k.rsplit(".", 1)[0] not in bns):
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(),
                                          err_msg=k)
    assert float(m.fc_var.bias.min()) == float(m.fc_var.bias.max()) == -2.0
