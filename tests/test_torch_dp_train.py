"""Data-parallel training in the port (`Trainer` and `JointTrainer` over a
mesh of two ranks, the train CLI's --num_devices) against the JAX
package's trainer, whose jit shards the batch over the 8 virtual CPU
devices of tests/conftest.py and so computes what one device computes:
the global batch's BatchNorm statistics and gradients.

The ranks are two gloo processes on the CPU, spawned once for the module
(`parallel.mesh.spawn`); they run `tests/torch_parallel_workers.py`,
which imports no JAX, at the trainers' defaults (Flax's initial weights
and JAX's noise from the seed, as the JAX trainer draws them), and hand
numpy results back.  The same workers called here with a mesh of one rank
give the port's one-rank reference, which tests/test_torch_train.py and
tests/test_torch_joint_vae.py hold against JAX gradient by gradient.

Tolerances: one step against JAX's jitted step at
tests/test_torch_train.py's (losses 1e-5, parameters within 2.5 lr, the
running statistics 1e-5 of each tensor's largest magnitude, Adam's first
moment, 0.1 of the gradient, 1e-4 of it plus 3e-7: a conv bias ahead of
a BatchNorm has a gradient of 0 up to float32 rounding, about 1e-6).
Against the one-rank step: the gradients 1e-4 of each tensor's largest
magnitude plus 5e-6 (float32 BatchNorm sums in another order move a
gradient by up to 2e-5 of it, and those zero biases' rounding, up to
2e-6 in either run, by as much again), Adam's moments as follows from
that, the parameters within 2.5 lr, and the running statistics 1e-5 of
each tensor's largest magnitude, test_torch_train.py's bar against JAX
(a batch mean is a float32 sum over 320 values summed in another order:
up to 1.05e-6 of the largest magnitude measured for the prior, 3.7e-6
for the joint prior's second layer); all of them equal on both ranks.
The eval of an odd-length test set against JAX's 1e-5; a 2-epoch run's
history within 1e-2 of the one-rank run's (the eval 1.1e-3 apart after
12 steps at lr 2e-3: Adam's normalised steps grow the ranks' rounding;
test_torch_train.py holds one rank's run to JAX's within 5 %).
"""

import os
import pickle

import jax
import numpy as np
import pytest

from globalegomocap_tpu.cli import train as jcli
from globalegomocap_tpu.config import TrainConfig as JCfg
from globalegomocap_tpu.data.amass import AmassWindows as JWindows
from globalegomocap_tpu.data.hdf5 import sequence_windows_with_cameras
from globalegomocap_tpu.data.synthetic import synthetic_amass
from globalegomocap_tpu.train.train_vae import Trainer as JTrainer
from globalegomocap_tpu_torch.cli import train as tcli
from globalegomocap_tpu_torch.config import TrainConfig as TCfg
from globalegomocap_tpu_torch.models.convert import params_from_flax
from globalegomocap_tpu_torch.parallel import mesh as pm
from tests import test_torch_joint_vae as tj
from tests import test_torch_train as tt
from tests import torch_parallel_workers as workers

TEST_LEN = 37       # batches of 32 and 5: the last is padded to 6
LR = tt.LR
assert tj.LR == LR


@pytest.fixture(scope="module")
def case():
    """The JAX trainer, the two corpora and a batch of each."""
    data = JWindows.from_sequences(
        synthetic_amass(n_sequences=3, frames_per_seq=80, seed=1),
        frame_num=10, local_pose=True)
    jt = tt.jax_trainer(data)
    windows = np.array(data.windows)
    vae = (windows, windows[32:64])
    seqs = synthetic_amass(n_sequences=2, frames_per_seq=70, seed=3)
    _, local, cams = zip(*[sequence_windows_with_cameras(
        s, frame_num=10, fps=25, slide_window=True) for s in seqs])
    joint = (np.concatenate(local).reshape(-1, 10, 45),
             np.concatenate(cams), slice(32, 64))
    return data, jt, vae, joint


def _vae_args(case, n):
    _, _, (windows, batch), _ = case
    cfg = TCfg(**dict(tt.BASE, log_step=2, num_devices=n))
    return (cfg, tt.HIDDEN, windows, batch, TEST_LEN)


def _joint_args(case, n):
    *_, (poses, cams, rows) = case
    cfg = TCfg(**dict(tj.BASE, num_devices=n))
    return (cfg, tj.HIDDEN, poses, cams, rows)


@pytest.fixture(scope="module")
def ranks(case):
    """Both ranks' results, and the one-rank reference of the same
    workers."""
    out = pm.spawn(workers.several, 2, ["cpu"] * 2, timeout_s=300,
                   threads=1, args=([
        ("dp_train", _vae_args(case, 2)),
        ("dp_joint", _joint_args(case, 2))],))
    one = pm.make_mesh(device="cpu")
    return out, (workers.dp_train(one, *_vae_args(case, 1)),
                 workers.dp_joint(one, *_joint_args(case, 1)))


def _close(a, b, rtol=1e-5, atol=1e-7, what=""):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _scaled(a, b, rel, what, floor=0.0):
    """a within `rel` of b's largest magnitude, plus `floor`."""
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * float(np.abs(b).max()) + floor,
                               err_msg=what)


def _against_one_rank(r0, r1, one):
    """The step's gradients within 1e-4 of one rank's largest magnitude
    (5e-6 absolute: a conv bias ahead of a BatchNorm has a gradient of 0
    up to rounding), Adam's moments as follows from that, the parameters
    within 2.5 lr (Adam's normalised first step turns rounding on such
    gradients into +-lr), the running statistics 1e-5 of each tensor's
    largest magnitude; all the same on both ranks."""
    for name, g in one["grads"].items():
        np.testing.assert_array_equal(r1["grads"][name], r0["grads"][name])
        _scaled(r0["grads"][name], g, 1e-4, name, 5e-6)
        for k, m in one["moments"][name].items():
            np.testing.assert_array_equal(r1["moments"][name][k],
                                          r0["moments"][name][k])
            first = k == "exp_avg"
            _scaled(r0["moments"][name][k], m, 1e-4 if first else 2e-4,
                    name + k, 5e-7 if first else 1e-12)
    for k, v in one["state"].items():
        np.testing.assert_array_equal(r1["state"][k], r0["state"][k])
        if "running" in k:
            _scaled(r0["state"][k], v, 1e-5, k)
        elif "num_batches" not in k:
            assert float(np.max(np.abs(r0["state"][k] - v))) <= 2.5 * LR, k


def test_one_data_parallel_step_matches_jax(case, ranks):
    """Trainer(num_devices=2), one step on 16 rows a rank of the batch of
    32, against JAX's jitted step on the same batch and noise: the
    global batch's three losses, the parameters after the update, the
    running statistics and Adam's first moment (0.1 of the gradient);
    and against one rank's step."""
    _, jt, (_, batch), _ = case
    (r0, _), (r1, _) = ranks[0]
    one = ranks[1][0]
    state, metrics = jt._train_step(jt.state, jt._device_batch(batch),
                                    jax.random.PRNGKey(jt.cfg.seed + 1))
    for k in ("loss", "recon_loss", "kld_loss"):
        assert r0["step"]["metrics"][k] == pytest.approx(
            float(metrics[k]), rel=1e-5), k
        assert r1["step"]["metrics"][k] == r0["step"]["metrics"][k]
    after = params_from_flax(tt._np({"params": state.params,
                                     "batch_stats": state.batch_stats}))
    mu = params_from_flax(tt._np({"params": state.opt_state[0].mu,
                                  "batch_stats": state.batch_stats}))
    got = r0["step"]["state"]
    for k, want in after.items():
        want = want.numpy()
        if "running" in k:
            _close(got[k], want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                   what=k)
        elif "num_batches" not in k:
            assert float(np.max(np.abs(got[k] - want))) <= 2.5 * tt.LR, k
            _scaled(r0["step"]["moments"][k]["exp_avg"], mu[k].numpy(),
                    1e-4, k, 3e-7)
    _against_one_rank(r0["step"], r1["step"], one["step"])


def test_odd_test_set_eval_matches_jax(case, ranks):
    """The eval of 37 windows (the last batch of 5 padded to 6 and
    masked) at the initial weights: JAX's padded, masked eval (1e-5) and
    one rank's, on both ranks."""
    data, jt, _, _ = case
    model = tt.jvae.ConvVAE(latent_dim=32, seq_len=10, hidden_dims=tt.HIDDEN)
    jeval = JTrainer(JCfg(**tt.BASE), data, JWindows(data.windows[:TEST_LEN]),
                     model)
    want = jeval.evaluate()
    (r0, _), (r1, _) = ranks[0]
    assert r0["eval0"] == r1["eval0"]
    assert r0["eval0"] == pytest.approx(want, rel=1e-5)
    assert r0["eval0"] == pytest.approx(ranks[1][0]["eval0"], rel=1e-6)


def test_short_data_parallel_run_follows_one_rank(ranks):
    """2 epochs at log_step 2: rank 0 logs and keeps the history, rank 1
    neither; the same steps and rows as one rank's run, every logged
    loss and eval within 1e-2 (1.1e-3 measured); the final state equal on
    both ranks."""
    (r0, _), (r1, _) = ranks[0]
    one = ranks[1][0]
    assert r1["history"] == [] and r1["logs"] == []
    assert r0["steps"] == r1["steps"] == one["steps"] == 12
    assert len(r0["history"]) == len(one["history"]) == len(r0["logs"]) > 2
    for a, b in zip(r0["history"], one["history"]):
        assert set(a) == set(b) and a.get("step") == b.get("step")
        for k in ("loss", "recon_loss", "eval_mpjpe"):
            if k in b:
                assert a[k] == pytest.approx(b[k], rel=1e-2), (k, a, b)
    for k, v in r0["state"].items():
        np.testing.assert_array_equal(r1["state"][k], v)


def test_joint_data_parallel_step_matches_one_rank(ranks):
    """JointTrainer(num_devices=2), one step at its own initialisation and
    noise: the six metrics within 1e-5 of one rank's (whose step
    tests/test_torch_joint_vae.py holds against JAX's), every gradient,
    moment and parameter, and both branches' running statistics, the
    same on both ranks."""
    (_, r0), (_, r1) = ranks[0]
    one = ranks[1][1]
    assert list(r0["metrics"]) == list(one["metrics"])
    for k, v in one["metrics"].items():
        assert r0["metrics"][k] == r1["metrics"][k]
        assert r0["metrics"][k] == pytest.approx(
            v, rel=1e-5, abs=tj.KLD_ABS if "kld" in k else 0), k
    _against_one_rank(r0, r1, one)


@pytest.fixture(scope="module")
def amass_dir(tmp_path_factory):
    """tests/test_torch_train_cli.py's corpus: 12 pkls of 40 frames."""
    d = tmp_path_factory.mktemp("amass")
    for i, s in enumerate(synthetic_amass(n_sequences=12, frames_per_seq=40,
                                          seed=9)):
        with open(d / f"seq_{i:02d}.pkl", "wb") as f:
            pickle.dump(s, f)
    return str(d)


def test_cli_trains_on_two_ranks_and_jax_resumes(amass_dir, tmp_path,
                                                 monkeypatch):
    """--num_devices 2 --device cpu spawns two gloo ranks: rank 0 writes
    the epoch checkpoint and returns its steps and history, whose eval is
    one rank's (the same seed, noise and rows; 1e-4), and JAX's train CLI
    loads it to resume (at --epoch 0, which trains no further step)."""
    monkeypatch.chdir(tmp_path)
    common = ["--train_data_path", amass_dir] + [
        "--latent_dim", "16", "--seq_length", "10", "--kl_weight", "0.1",
        "--epoch", "1", "--batch_size", "16", "--local_pose", "true"]
    two = tcli.main(common + ["--log_dir", "dp", "--device", "cpu",
                              "--num_devices", "2"])
    ckpts = tmp_path / "logs" / "dp" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["0.json", "0.msgpack"]
    one = tcli.main(common + ["--log_dir", "one", "--device", "cpu"])
    assert two["step"] == one.step == 3
    assert two["history"][-1]["eval_mpjpe"] == pytest.approx(
        one.history[-1]["eval_mpjpe"], rel=1e-4)
    jax_run = jcli.main(common + ["--epoch", "0", "--log_dir", "j",
                                  "--resume", str(ckpts / "0.msgpack")])
    assert int(jax_run.state.step) == two["step"]
