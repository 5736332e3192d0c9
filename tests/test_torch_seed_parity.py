"""What the port computes from a seed against what the JAX package
computes from it, on the CPU, with nothing handed in: Flax's initial
weights (`models/conv_vae.py::init_flax_like` against `model.init(
PRNGKey(seed), ...)`) for the ConvVAE, the bone-length ConvVAE and the
joint prior on the tiny prior of tests/test_golden.py; both trainers'
reparameterisation noise against the JAX trainers' keys.  The trainers'
first step and short run from the seed are held in
tests/test_torch_train.py and tests/test_torch_joint_vae.py, `introspect
sample --seed` against JAX's CLI in tests/test_torch_introspect.py,
RANSAC's index sets in tests/test_torch_geometry.py.

Tolerances: initial weights within 1e-6 of each leaf's largest magnitude
(`hold_init`; biases, BatchNorm and fc_var's constant exactly): the
truncated normal's float32 `erf_inv` rounds an ulp apart from XLA's in a
few draws (measured 1.9e-7 of the largest at most); float32 noise within
1e-6 (tests/test_torch_random.py's normal bar), bf16 noise exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from globalegomocap_tpu.models import conv_vae as jvae
from globalegomocap_tpu.models import joint_vae as jjoint
from globalegomocap_tpu_torch.models import conv_vae as tvae
from globalegomocap_tpu_torch.models import joint_vae as tjoint
from globalegomocap_tpu_torch.models.convert import (
    joint_params_from_flax, params_from_flax)
from globalegomocap_tpu_torch.ops import random as R
from globalegomocap_tpu_torch.train import train_joint, train_vae
from tests.torch_port_helpers import TINY_PRIOR, hold_init


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kind", ["conv_vae", "bone_length", "logvar_bias"])
def test_init_flax_like_matches_flax_init(kind, seed):
    """`init_flax_like(model, seed)` is Flax's `init(PRNGKey(seed))` leaf
    for leaf: the ConvVAE, the bone-length ConvVAE (its bone and fusion
    Dense and BatchNorm layers) and a non-zero fc_var bias."""
    kw = dict(TINY_PRIOR, with_bone_length=kind == "bone_length",
              logvar_bias_init=-2.0 if kind == "logvar_bias" else 0.0)
    jm = jvae.ConvVAE(**kw)
    want = params_from_flax(_np(jm.init(jax.random.PRNGKey(seed),
                                        jnp.zeros((2, 10, 45)), False)))
    tm = tvae.init_flax_like(tvae.ConvVAE(**kw), seed)
    got = tm.state_dict()
    hold_init(got, want)
    bns = {n for n, m in tm.named_modules()
           if isinstance(m, torch.nn.BatchNorm1d)}
    for k, v in got.items():
        if not k.endswith("weight") or k.rsplit(".", 1)[0] in bns:
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(), k)


def test_joint_init_matches_flax_init():
    """The joint prior's branches under Flax's scopes 'local' and
    'global', as `JointTrainer` initialises them: Flax's joint `init`
    leaf for leaf, and the two branches differ."""
    hidden = TINY_PRIOR["hidden_dims"]
    jm = jjoint.JointLocalGlobalVAE(latent_dim=32, seq_len=10,
                                    hidden_dims=hidden)
    want = joint_params_from_flax(_np(jm.init(
        jax.random.PRNGKey(4), jnp.zeros((2, 10, 45)),
        jnp.broadcast_to(jnp.eye(4), (2, 10, 4, 4)), False)))
    tm = tjoint.JointLocalGlobalVAE(latent_dim=32, seq_len=10,
                                    hidden_dims=hidden)
    tvae.init_flax_like(tm.local_vae, 4, scope=("local",))
    tvae.init_flax_like(tm.global_vae, 4, scope=("global",))
    got = tm.state_dict()
    hold_init(got, want)
    assert not torch.equal(got["local.fc_mu.weight"],
                           got["global.fc_mu.weight"])


@pytest.mark.parametrize("dtype,jdt", [(torch.float32, jnp.float32),
                                       (torch.bfloat16, jnp.bfloat16)],
                         ids=["float32", "bfloat16"])
def test_trainer_noise_is_the_jax_trainers(dtype, jdt):
    """`step_noise` is the JAX trainer's `normal(fold_in(PRNGKey(seed +
    1), step), mu.shape, mu.dtype)` (float32 within 1e-6, bf16 exactly);
    a rank's rows from `row` are those rows of the global draw; the joint
    trainer's pair is the normals of `split(fold_in(...))`."""
    seed = 3
    key = jax.random.PRNGKey(seed + 1)
    for step in (0, 1, 7):
        want = np.asarray(jax.random.normal(
            jax.random.fold_in(key, step), (8, 32), jdt).astype(jnp.float32))
        got = train_vae.step_noise(R.prng_key(seed + 1), step, (8, 32), dtype,
                                   "cpu")
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=1e-6 if dtype == torch.float32
                                   else 0)
        rows = train_vae.step_noise(R.prng_key(seed + 1), step, (3, 32),
                                    dtype, "cpu", row=4)
        torch.testing.assert_close(rows, got[4:7], rtol=0, atol=0)
        pair = train_joint.joint_step_noise(R.prng_key(seed + 1), step,
                                            (8, 32), dtype, "cpu")
        for k, z in zip(jax.random.split(jax.random.fold_in(key, step)),
                        pair):
            np.testing.assert_allclose(
                z.float().numpy(),
                np.asarray(jax.random.normal(k, (8, 32), jdt)
                           .astype(jnp.float32)), rtol=0,
                atol=1e-6 if dtype == torch.float32 else 0)
