"""The port's joint local+global prior (`models/joint_vae.py`,
`train/train_joint.py`, the joint converters of `models/convert.py`)
against the JAX package's, on the tiny prior (latent 32, hidden (8, 8,
16, 16, 32)) and the windows of JAX's tests/test_joint_vae.py
(`synthetic_amass(2, 70, seed=3)`, local windows with their cameras).

The port's trainer runs at its defaults: Flax's initial weights from
cfg.seed (held against the JAX trainer's within 1e-6 of each leaf's
largest magnitude) and JAX's own noise (the two halves of
`split(fold_in(PRNGKey(seed + 1), step))`), so the port follows the JAX
trainer from the same seed.  Tolerances, from tests/test_torch_train.py: an eval-mode
forward 1e-5 relative (1e-6 absolute), its losses 1e-5; one train
step's losses 1e-5, every gradient 1e-4 against JAX's float32 and
float64 gradients of joint_loss (torch_port_helpers.py::hold), Adam's
moments as there, the running statistics 1e-5 of each tensor's
largest magnitude (the floor of torch_port_helpers.py::hold: a running
mean near 0 is a small batch mean of O(1) activations, and JAX's float32
reductions round it at that scale), the parameters after
the update within 2.5 lr (Adam's normalised first update turns rounding
on near-zero gradients into +-lr flips); a 2-epoch history within 5 %.
A KLD also within 1e-6 absolute: near an untrained prior's mu = 0 and
log_var = 0 it is a sum over the 32 latents of differences of O(1) terms
(1 + log_var against exp(log_var)), so float32 leaves it an absolute
error up to about latent * eps / 2 = 2e-6 whatever its size.
The JAX trainer runs on the 8 virtual CPU devices of tests/conftest.py,
as in test_torch_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    hold, hold_init, port_chunk, slice_config, tcfg)
from globalegomocap_tpu.config import TrainConfig as JCfg
from globalegomocap_tpu.data.hdf5 import sequence_windows_with_cameras
from globalegomocap_tpu.data.synthetic import synthetic_amass, synthetic_chunk
from globalegomocap_tpu.models import joint_vae as jjoint
from globalegomocap_tpu.ops.transforms import relative_global_pose
from globalegomocap_tpu.train import train_joint as jtrain
from globalegomocap_tpu_torch.config import TrainConfig as TCfg
from globalegomocap_tpu_torch.models import joint_vae as tjoint
from globalegomocap_tpu_torch.models.convert import (
    joint_params_from_flax, joint_params_to_flax, params_from_flax)
from globalegomocap_tpu_torch.ops import random as R
from globalegomocap_tpu_torch.optimize import driver as tdriver
from globalegomocap_tpu_torch.parallel.mesh import Mesh
from globalegomocap_tpu_torch.train import train_joint as ttrain

HIDDEN = (8, 8, 16, 16, 32)
LATENT = 32
LR = 2e-3
KLD_ABS = 1e-6
BASE = dict(latent_dim=LATENT, seq_length=10, epochs=2, batch_size=32,
            kl_weight=0.05, learning_rate=LR)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def windows():
    seqs = synthetic_amass(n_sequences=2, frames_per_seq=70, seed=3)
    _, local, cams = zip(*[sequence_windows_with_cameras(
        s, frame_num=10, fps=25, slide_window=True) for s in seqs])
    return np.concatenate(local).reshape(-1, 10, 45), np.concatenate(cams)


def jax_noise(seed: int):
    """The JAX joint step's noise of step `step`, fn(step, shape, dtype):
    split(fold_in(PRNGKey(seed), step)) gives the local and the global
    branch's key."""
    key = jax.random.PRNGKey(seed)

    def noise(step, shape, dtype):
        keys = jax.random.split(jax.random.fold_in(key, step))
        return tuple(torch.from_numpy(np.array(
            jax.random.normal(k, tuple(shape), jnp.float32))) for k in keys)

    return noise


def _models():
    j = jjoint.JointLocalGlobalVAE(latent_dim=LATENT, seq_len=10,
                                   hidden_dims=HIDDEN)
    t = tjoint.JointLocalGlobalVAE(latent_dim=LATENT, seq_len=10,
                                   hidden_dims=HIDDEN)
    return j, t


@pytest.fixture(scope="module")
def joint_weights(windows):
    """JAX joint variables with random BatchNorm running statistics (so
    the eval-mode forward uses them), and the port's model on them."""
    poses, cams = windows
    jm, tm = _models()
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(poses[:2]),
                    jnp.asarray(cams[:2]), False))
    rng = np.random.default_rng(0)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.8, 1.2, a.shape).astype(np.float32),
        v["batch_stats"])
    tm.load_state_dict(joint_params_from_flax(v))
    return jm, tm, v


def test_joint_variables_cross_both_ways(joint_weights):
    """joint_params_to_flax(joint_params_from_flax(v)) is v, leaf for
    leaf; each branch is params_from_flax of JAX's branch_variables."""
    jm, tm, v = joint_weights
    back = joint_params_to_flax(joint_params_from_flax(v))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(tm.branch_variables(),
                         jjoint.split_branches(jm, v)):
        want = params_from_flax(want)
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert set(tm.state_dict()) == {f"{b}.{k}" for b in ("local", "global")
                                    for k in want}


def test_eval_forward_and_joint_loss_match_jax(joint_weights, windows):
    """All seven outputs of the eval-mode forward (z = mu) and the six
    losses of joint_loss, 1e-5; frame 0 of the lifted local
    reconstruction is the local reconstruction (JAX's test)."""
    jm, tm, v = joint_weights
    poses, cams = (x[:16] for x in windows)
    jout = jm.apply(v, jnp.asarray(poses), jnp.asarray(cams), False)
    with torch.no_grad():
        tout = tm(torch.from_numpy(poses), torch.from_numpy(cams))
    for name in jout._fields:
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tout.lifted_local[:, 0].numpy(),
                               tout.local_recon[:, 0].numpy(), atol=1e-5)
    jt, jm_ = jjoint.joint_loss(jout, jnp.asarray(poses), jnp.asarray(cams),
                                0.07, consistency_weight=0.5)
    tt, tm_ = tjoint.joint_loss(tout, torch.from_numpy(poses),
                                torch.from_numpy(cams), 0.07,
                                consistency_weight=0.5)
    assert float(tt) == pytest.approx(float(jt), rel=1e-5)
    assert list(tm_) == list(jm_)
    for k in jm_:
        assert float(tm_[k]) == pytest.approx(float(jm_[k]), rel=1e-5,
                                              abs=KLD_ABS), k


def _trainers(windows, **kw):
    """JAX's JointTrainer and the port's at its defaults from the same
    seed, their initial weights held leaf for leaf (`hold_init`)."""
    poses, cams = windows
    jm, tm = _models()
    jt = jtrain.JointTrainer(JCfg(**dict(BASE, **kw)), poses, cams, jm)
    tt = ttrain.JointTrainer(TCfg(**dict(BASE, **kw)), poses, cams, tm,
                             device="cpu")
    hold_init(tt.model.state_dict(), joint_params_from_flax(_np(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats})))
    return jt, tt


def _jax_grads(jt, poses, cams, dt):
    """JAX's step-0 loss, gradients of joint_loss and new batch
    statistics, at JAX's kld weight (kl_weight * batch / windows) and
    noise, in float32 or float64.  The forward is JointLocalGlobalVAE's
    with the noise drawn outside it, so that float64 reuses the float32
    draws (test_torch_train.py's `_jax_grads` does the same); float32
    gives JAX's own step's loss, which the caller checks."""
    kld_w = jt.cfg.kl_weight * jt.cfg.batch_size / len(jt.poses)
    keys = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(jt.cfg.seed + 1), 0))
    eps32 = [jax.random.normal(k, (len(poses), LATENT), jnp.float32)
             for k in keys]
    with jax.enable_x64(dt == jnp.float64):
        model = jt.model.clone(dtype=dt)
        params, stats, x, c, eps = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dt),
            (jt.state.params, jt.state.batch_stats, poses, cams, eps32))

        def forward(m, x, c):
            b, t = x.shape[:2]
            lmu, llv = m.local_vae.encode(x, True)
            lrec = m.local_vae.decode(lmu + eps[0] * jnp.exp(0.5 * llv),
                                      True)
            rel = relative_global_pose(x.reshape(b, t, 15, 3),
                                       c).reshape(b, t, 45)
            gmu, glv = m.global_vae.encode(rel, True)
            grec = m.global_vae.decode(gmu + eps[1] * jnp.exp(0.5 * glv),
                                       True)
            lifted = relative_global_pose(lrec.reshape(b, t, 15, 3),
                                          c).reshape(b, t, 45)
            return jjoint.JointVAEOutput(lrec, grec, lmu, llv, gmu, glv,
                                         lifted)

        def loss_fn(params):
            out, upd = model.apply({"params": params, "batch_stats": stats},
                                   x, c, mutable=["batch_stats"],
                                   method=forward)
            total, _ = jjoint.joint_loss(out, x, c, kld_w)
            return total, upd["batch_stats"]

        (loss, new), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        return float(loss), _np(grads), _np(new)


def test_one_train_step_matches_jax(windows):
    """Step 0 on the same batch with the same noise: the six metrics
    (1e-5), every gradient (1e-4, against JAX's float32 and float64
    gradients of joint_loss as `hold` says: the consistency term reaches
    both branches through the lift), Adam's moments and count, every
    running statistic (1e-5) and every parameter after the update
    (2.5 lr)."""
    jt, tt = _trainers(windows)
    poses, cams = (x[32:64] for x in windows)
    (jl, g32, n32), (_, g64, n64) = (_jax_grads(jt, poses, cams, dt)
                                     for dt in (jnp.float32, jnp.float64))
    jt.state, jm = jt._step(jt.state, jnp.asarray(poses), jnp.asarray(cams),
                            jax.random.PRNGKey(jt.cfg.seed + 1))
    assert jl == pytest.approx(float(jm["loss"]), rel=1e-5)
    tm = tt.train_step(torch.from_numpy(poses), torch.from_numpy(cams))
    assert list(tm) == list(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(
            float(jm[k]), rel=1e-5, abs=KLD_ABS if "kld" in k else 0), k
    grad32, grad64 = (joint_params_from_flax({"params": g, "batch_stats": n})
                      for g, n in ((g32, n32), (g64, n64)))
    named = dict(tt.model.named_parameters())
    assert set(named) <= set(grad32)
    for name, p in named.items():
        hold(p.grad.numpy(), grad32[name], grad64[name], 1e-4, 1e-6, name)
    jo = _np(jt.state.opt_state)
    assert int(jo[0].count) == 1
    moments = {leaf: joint_params_from_flax(
        {"params": getattr(jo[0], leaf), "batch_stats": n32})
        for leaf in ("mu", "nu")}
    for name, p in named.items():
        st = tt.optimizer.state[p]
        assert int(st["step"]) == 1, name
        for leaf, key, exact in (("mu", "exp_avg", 0.1 * grad64[name]),
                                 ("nu", "exp_avg_sq",
                                  0.001 * grad64[name].double() ** 2)):
            # the gradients are held above; here JAX's moments, within
            # what its float32 gradients' own error allows
            b = moments[leaf][name].numpy()
            jax_err = float(np.max(np.abs(b - exact.numpy())))
            np.testing.assert_allclose(
                st[key].numpy(), b, rtol=1e-4, err_msg=f"{name} {leaf}",
                atol=(1e-7 if leaf == "mu" else 1e-12) + 2 * jax_err)
    want = joint_params_from_flax(_np({"params": jt.state.params,
                                       "batch_stats": jt.state.batch_stats}))
    got = tt.model.state_dict()
    for k in want:
        if "running" in k:
            w = want[k].numpy()
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=k)
        elif "num_batches" not in k:
            gap = float(np.max(np.abs(got[k].numpy() - want[k].numpy())))
            assert gap <= 2.5 * LR, (k, gap)
    assert tt.step == int(jt.state.step) == 1


@pytest.mark.parametrize("opt", ["adam", "cosine"])
def test_short_run_follows_jax(windows, opt):
    """2 epochs (3 steps each, the partial batch dropped) from the same
    weights and noise: one history entry an epoch, the last step's six
    metrics, each within 5 % of JAX's.  At lr_schedule 'cosine' the JAX
    trainer builds its optimizer with no step count, so both run at the
    constant rate."""
    kw = {} if opt == "adam" else dict(lr_schedule="cosine",
                                       lr_warmup_steps=2, lr_final=1e-5)
    jt, tt = _trainers(windows, **kw)
    assert tt.opt_spec.schedule is None
    jlog, tlog = [], []
    jh = jt.train(log_fn=jlog.append)
    th = tt.train(log_fn=tlog.append)
    assert len(th) == len(jh) == 2 and len(tlog) == len(jlog) == 2
    for a, b in zip(th, jh):
        assert list(a) == list(b)
        for k in b:
            assert abs(a[k] - b[k]) <= 0.05 * abs(b[k]), (k, a[k], b[k])
    assert tlog[0].split()[:2] == jlog[0].split()[:2] == ["epoch", "0:"]
    n = len(windows[0])
    assert tt.step == int(jt.state.step) == 2 * (n // 32)


def test_branch_variables_drive_the_optimizer(windows):
    """The trained branches go into SequenceOptimizer as they are, and a
    chunk solves to finite metrics (JAX's test)."""
    tm = _models()[1]
    tt = ttrain.JointTrainer(TCfg(**dict(BASE, epochs=1)), *windows, tm,
                             device="cpu")
    tt.train(log_fn=lambda *_: None)
    local, glob = tt.branch_variables()
    cfg = slice_config(tcfg, max_iter=3, global_max_iter=2)
    opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), local, glob,
                                    cfg, device="cpu")
    errors, *_ = opt.run(port_chunk(synthetic_chunk(26, seed=5)))
    assert np.isfinite(errors["optimized_global_mpjpe"])


def test_default_noise_is_a_function_of_the_step():
    """The trainer's noise of a step is JAX's joint step's: the two halves
    of split(fold_in(PRNGKey(seed), step)), float32 within 1e-6 (the
    normal's erf_inv, as tests/test_torch_random.py holds it); rows r..
    of a draw are the rows of the whole (one rank's share); steps and
    branches differ."""
    key = R.prng_key(7)
    for step in (0, 3, 4):
        got = ttrain.joint_step_noise(key, step, (4, 32), torch.float32,
                                      "cpu")
        want = jax_noise(7)(step, (4, 32), torch.float32)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-6)
        rows = ttrain.joint_step_noise(key, step, (2, 32), torch.float32,
                                       "cpu", row=2)
        for g, r in zip(got, rows):
            torch.testing.assert_close(r, g[2:], rtol=0, atol=0)
    a, b = ttrain.joint_step_noise(key, 3, (4, 32), torch.float32, "cpu")
    c, _ = ttrain.joint_step_noise(key, 4, (4, 32), torch.float32, "cpu")
    assert not torch.equal(a, b) and not torch.equal(a, c)


def test_camera_windows_must_match_the_poses(windows):
    with pytest.raises(ValueError, match="camera windows"):
        ttrain.JointTrainer(TCfg(**BASE), windows[0], windows[1][:3],
                            _models()[1], device="cpu")


def test_num_devices_is_the_mesh_size(windows):
    """num_devices=2 asks for a mesh of two ranks: without a process
    group it raises naming both counts (tests/test_torch_dp_train.py
    trains on two ranks); a batch the ranks do not divide raises too."""
    with pytest.raises(ValueError, match=r"make_mesh\(2\).* 1 rank"):
        ttrain.JointTrainer(TCfg(**dict(BASE, num_devices=2)), *windows,
                            _models()[1], device="cpu")
    with pytest.raises(ValueError, match="batch_size 31 does not split"):
        ttrain.JointTrainer(TCfg(**dict(BASE, batch_size=31)), *windows,
                            _models()[1], device="cpu",
                            mesh=Mesh(None, "gloo", 0, 2,
                                      torch.device("cpu")))
