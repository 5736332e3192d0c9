"""Kernel 5, the decoder conv chain plus the stage-1 energy
(`ops/fused_decode_energy.py`), on the CPU: its plain version against the
JAX `fused_decode_stage_energy` run in interpret mode, the port's layer
builder against the port's own unfused decode plus `fused_stage_energy`,
and the `fused_decode` solve path against the unfused one and against
JAX.  The tiny prior of tests/test_golden.py, weights through
`params_from_flax`; tolerances are those of
tests/test_fused_energy.py:366-404 (e rtol 2e-5, dE/dz rtol 5e-4,
atol 1e-6)."""

from dataclasses import replace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.models.conv_vae import ConvVAE as JVAE
from globalegomocap_tpu.models.fold_bn import fold_batchnorm as j_fold
from globalegomocap_tpu.ops import fisheye as jfisheye
from globalegomocap_tpu.ops.pallas.fused_decode_energy import (
    fused_decode_stage_energy as j_fdse)
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.data.synthetic import synthetic_chunk
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE as TVAE
from globalegomocap_tpu_torch.models.fold_bn import fold_batchnorm
from globalegomocap_tpu_torch.ops import fused_decode_energy as fde
from globalegomocap_tpu_torch.ops.fused_energy import fused_stage_energy
from globalegomocap_tpu_torch.optimize import driver as tdriver
from tests.torch_port_helpers import (
    TINY_PRIOR, chunks, jax_variables, jcfg, port_chunk, port_state,
    slice_config, tcfg)

T, J = 10, 15
L = T * J
FULL_HW = (64, 64)
LATENT = TINY_PRIOR["latent_dim"]
C0 = TINY_PRIOR["hidden_dims"][-1]
WVEC = [0.01, 0.001, 0.02, 0.003, 0.01]


@pytest.fixture(scope="module")
def prior():
    jm = JVAE(**TINY_PRIOR)
    return jm, jax_variables(jm, seed=4)


def _jax_layers(v):
    prm = j_fold(v)["params"]
    names = [f"dec_{i}" for i in range(4)] + ["final_block", "final_conv"]
    layers = []
    for n in names:
        node = prm[n]["conv"] if "conv" in prm.get(n, {}) else prm[n]
        layers.append((node["kernel"], node["bias"]))
    return (prm["decoder_input"]["kernel"], prm["decoder_input"]["bias"],
            layers)


def _port_model(v, use_bn=True):
    sd = port_state(v)
    if not use_bn:
        sd = fold_batchnorm(sd)
    m = TVAE(**TINY_PRIOR, use_bn=use_bn)
    m.load_state_dict(sd)
    return m.eval()


def _context(b, k, seed):
    """numpy energy context in the kernel layout, bf16-representable
    crops (the port and JAX see the same bf16 values)."""
    rng = np.random.default_rng(seed)
    anchor = rng.normal(scale=0.3, size=(b, 3, L)).astype(np.float32)
    anchor[:, 2] += 1.5
    crops = rng.uniform(size=(b, k * k, L)).astype(np.float32)
    crops = np.array(jnp.asarray(crops, jnp.bfloat16).astype(jnp.float32))
    ox = rng.integers(0, 64 - k, size=(b, L)).astype(np.float32)
    oy = rng.integers(0, 64 - k, size=(b, L)).astype(np.float32)
    bone = np.tile(rng.uniform(0.1, 0.5, size=(b, J)), (1, T)).astype(
        np.float32)
    cam = jfisheye.default_camera("egosyn")
    wvec = np.array([WVEC + [float(cam.center[0]), float(cam.center[1]),
                             0.0]], np.float32)
    poly = np.asarray(cam.poly_w2c, np.float32)[None]
    return anchor, crops, ox, oy, bone, wvec, poly


def _port_ctx(np_ctx):
    anchor, crops, ox, oy, bone, wvec, poly = (torch.tensor(x)
                                               for x in np_ctx)
    return anchor, crops.to(torch.bfloat16), ox, oy, bone, (wvec, poly)


@pytest.mark.parametrize("r,b,k", [(1, 17, 8), (2, 5, 16), (2, 17, 8)])
def test_plain_version_matches_jax(prior, r, b, k):
    """R in {1, 2}, B in {5, 17} (17 pads the JAX kernel's 16-window
    block), k in {8, 16}; bf16 crops."""
    _, v = prior
    first_w, first_b, layers = _jax_layers(v)
    ctx = _context(b, k, seed=10 * r + b + k)
    z = np.random.default_rng(b + k).normal(size=(r, b, LATENT)).astype(
        np.float32)
    anchor, crops, ox, oy, bone, wvec, poly = ctx

    def j_energy(z_):
        h0 = (z_ @ first_w + first_b).reshape(r, b, T, C0)
        return j_fdse(h0, layers, jnp.asarray(anchor),
                      jnp.asarray(crops, jnp.bfloat16), jnp.asarray(ox),
                      jnp.asarray(oy), jnp.asarray(bone),
                      (jnp.asarray(wvec), jnp.asarray(poly)), T, J, k,
                      FULL_HW, 128.0, 512.0)

    e_j, pull = jax.vjp(j_energy, jnp.asarray(z))
    (gz_j,) = pull(jnp.ones_like(e_j))

    fw, fb, dl = fde.decoder_layers(_port_model(v))
    zt = torch.from_numpy(z).requires_grad_(True)
    h0 = torch.nn.functional.linear(zt, fw, fb).reshape(r, b, T, C0)
    a, c, x, y, bl, tctx = _port_ctx(ctx)
    e_t = fde.fused_decode_stage_energy(h0, dl, a, c, x, y, bl, tctx, T, J,
                                        k, FULL_HW, 128.0, 512.0)
    (gz_t,) = torch.autograd.grad(e_t.sum(), zt)
    assert e_t.shape == (r, b) and fde.cuda_build.LAUNCHES[
        "fused_decode_stage_energy"] == 0
    np.testing.assert_allclose(e_t.detach().numpy(), np.asarray(e_j),
                               rtol=2e-5)
    np.testing.assert_allclose(gz_t.numpy(), np.asarray(gz_j), rtol=5e-4,
                               atol=1e-6)


@pytest.mark.parametrize("use_bn", [True, False], ids=["bn", "folded"])
def test_layer_builder_matches_decode_plus_fused_energy(prior, use_bn):
    """`decoder_layers` (BN folded inline, or already folded) against the
    port's own decode_to_bodypose followed by kernel 1's plain version:
    pose and e to 1e-5, dE/dz at the tolerance above."""
    _, v = prior
    model = _port_model(v, use_bn=use_bn)
    r, b, k = 2, 6, 8
    ctx = _context(b, k, seed=3)
    z = torch.from_numpy(np.random.default_rng(1).normal(
        size=(r, b, LATENT)).astype(np.float32))
    a, c, x, y, bl, tctx = _port_ctx(ctx)
    fw, fb, dl = fde.decoder_layers(model)

    z1 = z.clone().requires_grad_(True)
    h0 = torch.nn.functional.linear(z1, fw, fb).reshape(r, b, T, C0)
    pose_k = fde.plain_decode_pose(h0, dl.layers)
    e_k = fde.fused_decode_stage_energy(h0, dl, a, c, x, y, bl, tctx, T, J,
                                        k, FULL_HW, 128.0, 512.0)
    (g_k,) = torch.autograd.grad(e_k.sum(), z1)

    z2 = z.clone().requires_grad_(True)
    pose = model.decode_to_bodypose(z2.reshape(r * b, LATENT))
    pose_rt = pose.reshape(r, b, L, 3).permute(0, 1, 3, 2).contiguous()
    e_u = fused_stage_energy(pose_rt, a, c, x, y, bl, tctx, T, J, k,
                             FULL_HW, 128.0, 512.0)
    (g_u,) = torch.autograd.grad(e_u.sum(), z2)
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pose_k.detach(), pose_rt.detach(), **tol)
    torch.testing.assert_close(e_k.detach(), e_u.detach(), **tol)
    torch.testing.assert_close(g_k, g_u, rtol=5e-4, atol=1e-6)


def test_wrapper_checks_and_packing(prior):
    _, v = prior
    _, _, dl = fde.decoder_layers(_port_model(v))
    assert dl.dims == (32, 16, 16, 8, 8, 8, 45)
    kern, bias = dl.layers[0]
    n = kern.numel()
    torch.testing.assert_close(dl.packed[:n].reshape(kern.shape), kern)
    back = dl.packed[n:2 * n].reshape(3, kern.shape[2], kern.shape[1])
    torch.testing.assert_close(back[0], kern[2].t())
    torch.testing.assert_close(dl.packed[2 * n:2 * n + bias.numel()], bias)
    a, c, x, y, bl, tctx = _port_ctx(_context(3, 8, seed=0))
    with pytest.raises(ValueError, match="channels"):
        fde.decode_energy_and_grad(torch.zeros(1, 3, T, 16), dl, a, c, x, y,
                                   bl, *tctx, T, J, 8, FULL_HW, 128.0, 512.0)
    with pytest.raises(TypeError, match="crops"):
        fde.decode_energy_and_grad(torch.zeros(1, 3, T, C0), dl, a,
                                   c.half(), x, y, bl, *tctx, T, J, 8,
                                   FULL_HW, 128.0, 512.0)
    # one row a block: the production chain needs the opt-in above 48 KB,
    # and four blocks still fit an SM's 228 KB
    smem = fde._smem_bytes((512, 256, 128, 64, 64, 64, 45), T * J)
    assert 48 * 1024 < smem and 4 * smem <= 228 * 1024


def _chunk_cfg(**solver):
    cfg = tcfg.OptimizeConfig(
        prior=tcfg.PriorConfig(**TINY_PRIOR),
        solver=tcfg.SolverConfig(method="lbfgs_fixed", max_iter=6,
                                 history_size=5, fused_probes=True,
                                 step_candidates=(1.0, 0.1)),
        sampling_impl="dense", heatmap_crop=8, fold_bn=True,
        dense_decoder=True, decoder_impl="conv")
    return replace(cfg, solver=replace(cfg.solver, **solver))


def test_fused_decode_end_to_end(prior):
    """The counterpart of test_pipeline_fused_decode_end_to_end: a chunk
    solved with fused_energy + fused_decode lands within 5 % of the
    per-window unfused solve in mid-local error."""
    _, v = prior
    sd = port_state(v)
    base, fused = _chunk_cfg(), _chunk_cfg(fused_energy=True,
                                           fused_decode=True)
    chunk = synthetic_chunk(26, seed=17)
    res = {}
    for name, cfg in (("base", base), ("fused", fused)):
        opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sd, sd,
                                        cfg, device="cpu")
        res[name] = opt.optimize_chunk(chunk)
    assert torch.isfinite(res["fused"].optimized).all()
    true_local = torch.from_numpy(np.asarray(chunk.estimated_local,
                                             np.float32))

    def err(r):
        m = r.mid_local
        return float((m - true_local[:m.shape[0]]).norm(dim=-1).mean())

    assert abs(err(res["base"]) - err(res["fused"])) < 0.05 * max(
        err(res["base"]), 1e-6)


def test_flat_fused_decode_matches_jax(prior):
    """The serve path's flat solve with fused_decode in both packages,
    2 stage-1 and 1 stage-2 iterations, every ChunkResult field at the
    tolerance of tests/test_torch_pipeline.py (rtol 1e-3, atol 2e-4)."""
    _, v = prior
    knobs = dict(max_iter=2, global_max_iter=1)
    jc, tc = slice_config(jcfg, **knobs), slice_config(tcfg, **knobs)
    jc = replace(jc, solver=replace(jc.solver, fused_decode=True))
    tc = replace(tc, solver=replace(tc.solver, fused_decode=True))
    cs = chunks()
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), v, v, jc)
    jres = jax.tree_util.tree_map(np.asarray, jopt.optimize_chunks_batched(
        jopt.stage(cs, on_host=True), mode="flat"))
    sd = port_state(v)
    topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                     device="cpu")
    tres = topt.optimize_chunks_batched(topt.stage(
        [port_chunk(c) for c in cs], on_host=True), mode="flat")
    for name in jres._fields:
        a, b = getattr(tres, name), getattr(jres, name)
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=2e-4,
                                   err_msg=name)
