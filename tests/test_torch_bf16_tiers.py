"""The bf16 solve tiers (`compute_dtype`) of the port against the JAX
package on the flat batched solve (tiny prior, CPU), for each of the six
tiers: the ChunkResult's dtypes match JAX's, the results are finite
and the 17 metrics agree within 5 % (the precedent of
test_fused_energy.py:297-308).  The solves run one iteration per stage:
bf16 rounds at other places in the two frameworks, and with a random
prior the line search branches on that rounding from the second
iteration on (mid_local agrees to 7e-4 m after one iteration and differs
by 0.07-0.24 m after two, when the float32 tier still agrees to 3e-6).
Also: zero solver iterations return the anchor exactly for bfloat16 and
bfloat16_delta (as tests/test_pipeline.py:390-474 holds the JAX tiers),
the float32 head, one bf16 decode against JAX's, the delta tier's bf16
solver state, and kernel 5's branch at the delta tier."""

from dataclasses import replace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from globalegomocap_tpu.evaluation.metrics import (
    METRIC_KEYS, calculate_errors as j_errors)
from globalegomocap_tpu.models.conv_vae import ConvVAE as JVAE
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.evaluation.metrics import (
    calculate_errors as t_errors)
from globalegomocap_tpu_torch.ops.skeleton import mean_bone_lengths
from globalegomocap_tpu_torch.optimize import driver as tdriver
from globalegomocap_tpu_torch.optimize import pipeline as tpipe
from globalegomocap_tpu_torch.optimize.window import slice_windows
from tests.torch_port_helpers import (
    TINY_PRIOR, chunks, jax_variables, jcfg, port_chunk, port_state,
    slice_config, tcfg)

TIERS = ["float32", "bfloat16", "bfloat16_f32enc", "bfloat16_f32head",
         "bfloat16_delta", "bfloat16_pure"]
KNOBS = dict(max_iter=1, global_max_iter=1)


@pytest.fixture(scope="module")
def prior():
    v = jax_variables(jdriver.build_model(slice_config(jcfg)), seed=0)
    return v, port_state(v)


def _xla_energy(cfg):
    """The batched solver over the plain energy: the tier logic of
    `optimize_stage` is the kernels' branch's, and the JAX side skips the
    Pallas interpreter (5 s a solve)."""
    return replace(cfg, solver=replace(cfg.solver, fused_energy=False,
                                       batched_solver=True))


@pytest.mark.parametrize("tier", TIERS)
def test_tier_matches_jax(prior, tier):
    """Each tier on the batched solver; the kernels' branch at the serve
    default tier is held by test_torch_serve.py and by the kernel-5 case
    below."""
    v, sd = prior
    cs = chunks()
    jc = _xla_energy(slice_config(jcfg, compute_dtype=tier, **KNOBS))
    tc = _xla_energy(slice_config(tcfg, compute_dtype=tier, **KNOBS))
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), v, v, jc)
    jres = jopt.optimize_chunks_batched(jopt.stage(cs, on_host=True),
                                        mode="flat")
    topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                     device="cpu")
    tres = topt.optimize_chunks_batched(
        topt.stage([port_chunk(c) for c in cs], on_host=True), mode="flat")
    for name in jres._fields:
        a, b = getattr(tres, name), getattr(jres, name)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), name
        assert tuple(a.shape) == b.shape and torch.isfinite(a).all(), name
    terr = t_errors(tres.estimated, tres.mid, tres.optimized, tres.gt)
    for c in range(len(cs)):
        jerr = j_errors(*(x[c] for x in (jres.estimated, jres.mid,
                                         jres.optimized, jres.gt)))
        for key in METRIC_KEYS[:17]:
            a, b = float(terr[key][c]), float(jerr[key])
            assert abs(a - b) <= 0.05 * abs(b), (tier, c, key, a, b)


@pytest.mark.parametrize("tier", ["bfloat16", "bfloat16_delta"])
def test_residual_stage_exact_at_init(prior, tier):
    """Zero iterations of the residual stage return the anchor to float32
    precision: the offset and the output decode are float32 (and the
    delta state starts at exactly 0)."""
    _, sd = prior
    cfg = slice_config(tcfg, compute_dtype=tier, max_iter=0)
    opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sd, sd, cfg,
                                    device="cpu")
    est = torch.from_numpy(np.asarray(chunks(seeds=(1,))[0].estimated_local,
                                      np.float32))
    win = slice_windows(est, 10, 8)
    bl = mean_bone_lengths(est).expand(win.shape[0], 15)
    _, global_w = tpipe.stage_weights(cfg)
    out = tpipe.optimize_stage(opt.global_model, win, None, bl,
                               tdriver.resolve_camera(cfg), global_w, False,
                               cfg, residual=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), win.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_delta_tier_solver_state_is_bf16(prior, monkeypatch):
    _, sd = prior
    seen = []
    solve = tpipe.lbfgs_minimize_fixed_batched

    def spy(vg, x0, **kw):
        res = solve(vg, x0, **kw)
        seen.append((x0.dtype, res.x.dtype, float(x0.abs().max())))
        return res

    monkeypatch.setattr(tpipe, "lbfgs_minimize_fixed_batched", spy)
    cfg = slice_config(tcfg, compute_dtype="bfloat16_delta", max_iter=2,
                       global_max_iter=1)
    opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sd, sd, cfg,
                                    device="cpu")
    res = opt.optimize_chunks_batched(
        opt.stage([port_chunk(c) for c in chunks()], on_host=True))
    assert seen == [(torch.bfloat16, torch.bfloat16, 0.0)] * 2
    assert res.mid_local.dtype == torch.float32


def test_f32_head_and_bf16_decode(prior):
    """The f32-head clone returns a float32 mu and a bf16 log-var from a
    bf16 model, within bf16 rounding of the bf16 head; one bf16 decode
    agrees with the JAX bf16 decode to 2e-2."""
    v, sd = prior
    cfg = slice_config(tcfg, compute_dtype="bfloat16_f32head")
    model = tdriver.build_model(cfg)
    model.load_state_dict(sd)
    model.eval()
    assert model.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    x = rng.normal(scale=0.3, size=(4, 10, 45)).astype(np.float32)
    z = rng.normal(size=(4, TINY_PRIOR["latent_dim"])).astype(np.float32)
    with torch.no_grad():
        mu16, _ = model.encode(torch.from_numpy(x))
        mu32, lv = model.clone(head_dtype=torch.float32).encode(
            torch.from_numpy(x))
        dec = model.clone().decode_to_bodypose(torch.from_numpy(z))
    assert (mu16.dtype, mu32.dtype, lv.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)
    np.testing.assert_allclose(mu16.float().numpy(), mu32.numpy(),
                               rtol=2e-2, atol=2e-2)
    jm = JVAE(**TINY_PRIOR, dtype=jnp.bfloat16)
    jdec = jm.apply(v, jnp.asarray(z), False, method=JVAE.decode_to_bodypose)
    assert dec.dtype == torch.bfloat16 and jdec.dtype == jnp.bfloat16
    np.testing.assert_allclose(dec.float().numpy(),
                               np.asarray(jdec, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_fused_decode_at_the_delta_tier_matches_jax(prior):
    """Kernel 5's branch under bfloat16_delta (float32 evals of mu + dz,
    the bf16 state) in both packages: float32 results, finite, metrics
    within 5 %."""
    v, sd = prior
    cs = chunks()
    cfgs = [slice_config(pkg, compute_dtype="bfloat16_delta", **KNOBS)
            for pkg in (jcfg, tcfg)]
    jc, tc = (replace(c, solver=replace(c.solver, fused_decode=True))
              for c in cfgs)
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), v, v, jc)
    jres = jopt.optimize_chunks_batched(jopt.stage(cs, on_host=True),
                                        mode="flat")
    topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                     device="cpu")
    tres = topt.optimize_chunks_batched(
        topt.stage([port_chunk(c) for c in cs], on_host=True))
    assert tres.optimized.dtype == torch.float32
    assert torch.isfinite(tres.optimized).all()
    terr = t_errors(tres.estimated, tres.mid, tres.optimized, tres.gt)
    for c in range(len(cs)):
        jerr = j_errors(*(x[c] for x in (jres.estimated, jres.mid,
                                         jres.optimized, jres.gt)))
        for key in METRIC_KEYS[:17]:
            a, b = float(terr[key][c]), float(jerr[key])
            assert abs(a - b) <= 0.05 * abs(b), (c, key, a, b)


@pytest.mark.parametrize("fused_decode", [False, True])
def test_priors_are_cast_once_per_optimizer(prior, monkeypatch,
                                            fused_decode):
    """SequenceOptimizer casts the priors for the tier (and builds kernel
    5's layers) at construction: the delta tier's eval model holds bf16
    weights, its encode and output models float32 ones, and a request
    casts nothing again (no `ConvVAE.clone`, no `decoder_layers`)."""
    from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
    _, sd = prior
    cfg = slice_config(tcfg, compute_dtype="bfloat16_delta", **KNOBS)
    cfg = replace(cfg, solver=replace(cfg.solver, fused_decode=fused_decode))
    opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sd, sd, cfg,
                                    device="cpu")
    local, _ = opt._stages
    assert (local.enc.decoder_input.weight.dtype,
            local.evals.decoder_input.weight.dtype,
            local.out.decoder_input.weight.dtype) == (
        torch.float32, torch.bfloat16, torch.float32)
    assert (local.decoder is not None) == fused_decode
    staged = opt.stage([port_chunk(c) for c in chunks(seeds=(1,))],
                       on_host=True)
    calls = []
    clone, layers = ConvVAE.clone, tpipe.decoder_layers
    monkeypatch.setattr(ConvVAE, "clone", lambda self, **kw: (
        calls.append("clone"), clone(self, **kw))[1])
    monkeypatch.setattr(tpipe, "decoder_layers", lambda m: (
        calls.append("decoder_layers"), layers(m))[1])
    res = opt.optimize_chunks_batched(staged)
    assert torch.isfinite(res.optimized).all()
    assert calls == []


def test_stage_models_of_another_tier_are_refused(prior):
    _, sd = prior
    cfg = slice_config(tcfg, compute_dtype="bfloat16_delta", max_iter=0)
    opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sd, sd, cfg,
                                    device="cpu")
    est = torch.from_numpy(np.asarray(chunks(seeds=(1,))[0].estimated_local,
                                      np.float32))
    win = slice_windows(est, 10, 8)
    bl = mean_bone_lengths(est).expand(win.shape[0], 15)
    _, global_w = tpipe.stage_weights(cfg)
    f32 = tpipe.stage_models(opt.global_model, "float32")
    with pytest.raises(ValueError, match="built for 'float32'"):
        tpipe.optimize_stage(f32, win, None, bl, tdriver.resolve_camera(cfg),
                             global_w, False, cfg)
