"""The port's ConvVAE with JAX-initialised weights carried across by
`models/convert.py::params_from_flax`, against the Flax ConvVAE on the
same numpy inputs (rtol 1e-5, atol 1e-5), with and without BN folding."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.models.conv_vae import ConvVAE as JVAE
from globalegomocap_tpu.models.fold_bn import fold_batchnorm as j_fold
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE as TVAE
from globalegomocap_tpu_torch.models.convert import params_from_flax
from globalegomocap_tpu_torch.models.fold_bn import fold_batchnorm as t_fold
from tests.torch_port_helpers import TINY_PRIOR, jax_variables

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(variables, use_bn, **prior):
    m = TVAE(latent_dim=prior["latent_dim"], seq_len=prior["seq_len"],
             hidden_dims=prior["hidden_dims"], use_bn=use_bn)
    m.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    return m.eval()


@pytest.fixture(scope="module")
def tiny():
    jm = JVAE(**TINY_PRIOR)
    return jm, jax_variables(jm, seed=3)


def _inputs(b, latent, seed=0):
    rng = np.random.default_rng(seed)
    pose = rng.normal(scale=0.5, size=(b, 10, 45)).astype(np.float32)
    z = rng.normal(size=(b, latent)).astype(np.float32)
    return pose, z


@pytest.mark.parametrize("fold", [False, True], ids=["bn", "folded"])
def test_encode_decode_match_jax(tiny, fold):
    jm, v = tiny
    if fold:
        v = j_fold(v)
        jm = jm.clone(use_bn=False)
    tm = _port(v, use_bn=not fold, **TINY_PRIOR)
    pose, z = _inputs(5, TINY_PRIOR["latent_dim"])
    mu_j, lv_j = jm.apply(v, jnp.asarray(pose), False, method=JVAE.encode)
    with torch.no_grad():
        mu_t, lv_t = tm.encode(torch.from_numpy(pose))
        dec_t = tm.decode_to_bodypose(torch.from_numpy(z))
    dec_j = jm.apply(v, jnp.asarray(z), False, method=JVAE.decode_to_bodypose)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), **TOL)
    assert dec_t.shape == (5, 10, 15, 3)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), **TOL)


def test_port_fold_matches_folded_jax(tiny):
    """Folding in the port (state dict) equals carrying the JAX-folded
    variables across, and both equal the unfolded model."""
    jm, v = tiny
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, v))
    folded_here = TVAE(**TINY_PRIOR, use_bn=False)
    folded_here.load_state_dict(t_fold(sd))
    folded_there = _port(j_fold(v), use_bn=False, **TINY_PRIOR)
    with_bn = _port(v, use_bn=True, **TINY_PRIOR)
    pose, z = _inputs(4, TINY_PRIOR["latent_dim"], seed=1)
    with torch.no_grad():
        outs = [m.decode_to_bodypose(torch.from_numpy(z))
                for m in (folded_here, folded_there, with_bn)]
        mus = [m.encode(torch.from_numpy(pose))[0]
               for m in (folded_here, folded_there, with_bn)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0].numpy(), o.numpy(), **TOL)
    for o in mus[1:]:
        np.testing.assert_allclose(mus[0].numpy(), o.numpy(), **TOL)


def test_full_width_decode_matches_jax():
    """Decode only, at the prior's full width (latent 2048, hidden
    64,64,128,256,512), BN folded as the serve path runs it."""
    prior = dict(latent_dim=2048, seq_len=10,
                 hidden_dims=(64, 64, 128, 256, 512))
    jm = JVAE(**prior)
    v = j_fold(jax_variables(jm, seed=4))
    jm = jm.clone(use_bn=False)
    tm = _port(v, use_bn=False, **prior)
    _, z = _inputs(3, 2048, seed=2)
    dec_j = jm.apply(v, jnp.asarray(z), False, method=JVAE.decode_to_bodypose)
    with torch.no_grad():
        dec_t = tm.decode_to_bodypose(torch.from_numpy(z))
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), **TOL)
