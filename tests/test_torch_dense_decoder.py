"""The port's dense and shift decoders (`models/dense_decoder.py`) against
its conv decoder and against the JAX package's `make_dense_decoder` /
`make_shift_decoder` on the same weights, at the tolerances of
tests/test_dense_decoder.py: values rtol 1e-4 / atol 1e-5, bf16 storage
0.05 / 0.05, gradients 1e-3 / 1e-5, whole chunk solves 1e-2 / 2e-4."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from globalegomocap_tpu.models.conv_vae import ConvVAE as JVAE
from globalegomocap_tpu.models.dense_decoder import (
    make_dense_decoder as j_dense, make_shift_decoder as j_shift)
from globalegomocap_tpu.models.fold_bn import fold_batchnorm as j_fold
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE as TVAE
from globalegomocap_tpu_torch.models.dense_decoder import (
    make_dense_decoder, make_shift_decoder)
from globalegomocap_tpu_torch.optimize import driver as tdriver
from tests.torch_port_helpers import (
    chunks, jax_variables, port_chunk, port_state, slice_config, tcfg)

HIDDEN = (8, 8, 16, 16, 32)
TOL = dict(rtol=1e-4, atol=1e-5)
MAKERS = {"dense": (make_dense_decoder, j_dense),
          "shift": (make_shift_decoder, j_shift)}


@pytest.fixture(scope="module")
def prior():
    """A Flax prior with non-trivial BN statistics and the port's model
    of the same weights, BN in place and folded."""
    jm = JVAE(latent_dim=24, seq_len=10, hidden_dims=HIDDEN)
    v = jax_variables(jm, seed=7)
    tm = TVAE(latent_dim=24, seq_len=10, hidden_dims=HIDDEN)
    tm.load_state_dict(port_state(v))
    folded = TVAE(latent_dim=24, seq_len=10, hidden_dims=HIDDEN,
                  use_bn=False)
    folded.load_state_dict(port_state(j_fold(v)))
    return jm, v, tm.eval(), folded.eval()


def _z(n=5, seed=8):
    return np.random.default_rng(seed).normal(size=(n, 24)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["dense", "shift"])
def test_decoder_matches_conv_and_jax(prior, kind):
    """From raw BN and from pre-folded weights: equal to the port's conv
    decode and to the JAX decoder of the same kind."""
    jm, v, tm, folded = prior
    make, jmake = MAKERS[kind]
    z = _z()
    with torch.no_grad():
        ref = tm.decode_to_bodypose(torch.from_numpy(z)).numpy()
        for model in (tm, folded):
            out = make(model)(torch.from_numpy(z))
            assert out.dtype == torch.float32 and out.shape == (5, 10, 15, 3)
            np.testing.assert_allclose(out.numpy(), ref, **TOL)
    jout = np.asarray(jmake(jm, v)(jnp.asarray(z)))
    np.testing.assert_allclose(out.numpy(), jout, **TOL)


@pytest.mark.parametrize("kind", ["dense", "shift"])
def test_bf16_storage(prior, kind):
    """bf16 matrices: float32 poses within bf16 rounding of the float32
    decode, and of the JAX decoder at bf16 storage."""
    jm, v, tm, _ = prior
    make, jmake = MAKERS[kind]
    z = _z(seed=9)
    with torch.no_grad():
        ref = tm.decode_to_bodypose(torch.from_numpy(z)).numpy()
        out = make(tm, torch.bfloat16)(torch.from_numpy(z))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0.05, atol=0.05)
    jout = np.asarray(jmake(jm, v, jnp.bfloat16)(jnp.asarray(z)))
    np.testing.assert_allclose(out.numpy(), jout, rtol=0.05, atol=0.05)


def test_shift_taps_flip_the_transposed_convolution():
    """A ConvTranspose1d weight (Cin, Cout, 3) is the flipped convolution:
    a weight with only tap k set moves a one-frame impulse by k - 1
    frames, in the shift decoder as in the conv decoder."""
    m = TVAE(latent_dim=4, seq_len=10, hidden_dims=(2, 2, 2, 2, 2),
             use_bn=False).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.zero_()
        # decoder_input puts 1.0 on channel 0 at frame 4 (channel-major)
        m.decoder_input.weight[0 * 10 + 4, 0] = 1.0
        for blk in list(m.decoder) + [m.final_layer]:
            blk[0].weight[0, 0, 1] = 1.0            # identity taps
        m.final_layer[3].weight[0, 0, 1] = 1.0
        z = torch.zeros(1, 4)
        z[0, 0] = 1.0
        for k, shift in ((0, -1), (2, 1)):
            conv = m.decoder[0][0].weight
            conv.zero_()
            conv[0, 0, k] = 1.0
            ref = m.decode_to_bodypose(z).reshape(10, 45)[:, 0]
            got = make_shift_decoder(m)(z).reshape(10, 45)[:, 0]
            assert int(ref.argmax()) == 4 + shift
            torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_dense_gradient_matches_conv(prior):
    _, _, tm, _ = prior
    dense = make_dense_decoder(tm)
    z = torch.from_numpy(_z(n=1, seed=3)[0])

    def grad(decode):
        x = z.clone().requires_grad_(True)
        p = decode(x[None])[0]
        (torch.sin(p) * p).sum().backward()
        return x.grad.numpy()
    np.testing.assert_allclose(grad(dense), grad(tm.decode_to_bodypose),
                               rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def pipeline_prior():
    cfg = slice_config(tcfg, max_iter=3, global_max_iter=2)
    v = jax_variables(JVAE(latent_dim=32, seq_len=10, hidden_dims=HIDDEN),
                      seed=5)
    return cfg, port_state(v)


@pytest.mark.parametrize("kind,tier", [
    ("dense", "float32"), ("shift", "float32"), ("shift", "bfloat16_delta")])
def test_decoder_in_pipeline(pipeline_prior, kind, tier):
    """decoder_impl dense/shift give near-identical chunk results to conv,
    through the per-window path and the flat path.  At the serve tier the
    evals decode in bf16 (bf16 matrices) and the output decode is a
    float32 one; there bf16 rounding picks different line-search steps
    from the conv decode's, so one iteration a stage is held, at the bf16
    storage tolerance."""
    from dataclasses import replace
    cfg0, sd = pipeline_prior
    tol = dict(rtol=1e-2, atol=2e-4)
    if tier != "float32":
        cfg0 = replace(cfg0, solver=replace(cfg0.solver, max_iter=1,
                                            global_max_iter=1))
        tol = dict(rtol=0.05, atol=0.05)
    cfg0 = replace(cfg0, compute_dtype=tier)
    cfg1 = replace(cfg0, decoder_impl=kind)
    opts = [tdriver.SequenceOptimizer(tdriver.build_model(c), sd, sd, c,
                                      device="cpu") for c in (cfg0, cfg1)]
    cs = [port_chunk(c) for c in chunks(26, (0, 1))]
    local = opts[1]._stages[0]
    assert local.impl == (kind, "float32")
    assert (local.decode_out is local.decode_eval) == (tier == "float32")
    if tier == "float32":
        r0, r1 = (o.optimize_chunk(cs[0]) for o in opts)
        for f in ("optimized", "mid"):
            np.testing.assert_allclose(getattr(r1, f).numpy(),
                                       getattr(r0, f).numpy(), **tol)
    r0, r1 = (o.optimize_chunks_batched(o.stage(cs), mode="flat")
              for o in opts)
    assert r1.optimized.dtype == torch.float32
    np.testing.assert_allclose(r1.optimized.numpy(), r0.optimized.numpy(),
                               **tol)
