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


def _float64_energy_and_dz(z, fw, fb, dl, np_ctx, r, b, k):
    """The arbiter: the port's plain chain and energy
    (`plain_decode_energy_and_grad`, which follows its inputs' dtype) in
    float64 on the same inputs and weights.  Returns e, dE/dz = dE/dh0 . W
    and, per element of dE/dz, the share |sum| / sum|products| of that
    dot product that survives cancellation."""
    f64 = torch.float64
    zz = torch.from_numpy(z).to(f64)
    w, bias = fw.to(f64), fb.to(f64)
    h0 = (zz @ w.t() + bias).reshape(r, b, T, C0)
    layers = [(kk.to(f64), bb.to(f64)) for kk, bb in dl.layers]
    anchor, crops, ox, oy, bone, wvec, poly = (torch.tensor(x, dtype=f64)
                                               for x in np_ctx)
    e, gh0, _, _ = fde.plain_decode_energy_and_grad(
        h0, layers, anchor, crops, ox, oy, bone, wvec, poly, T, J, k,
        63.0 / 1024.0, 63.0 / 1024.0, 128.0)
    g = gh0.reshape(r, b, T * C0)
    gz = g @ w
    return e.numpy(), gz.numpy(), (gz.abs() / (g.abs() @ w.abs())).numpy()


@pytest.mark.parametrize("r,b,k", [(1, 17, 8), (2, 5, 16), (2, 17, 8)])
def test_plain_version_matches_jax(prior, r, b, k):
    """R in {1, 2}, B in {5, 17} (17 pads the JAX kernel's 16-window
    block), k in {8, 16}; bf16 crops.  The port's float32 result and
    JAX's interpret-mode result are each held against a float64
    evaluation of the same function (e rtol 2e-5; dE/dz rtol 5e-4, atol
    1e-6), and against each other at those tolerances wherever the
    float64 dE/dz exceeds 1e-3 of its largest element and its dot product
    dE/dh0 . W keeps more than 1e-3 of its summed magnitudes.  Two
    float32 summation orders may part by more than atol on an element
    that cancels: at R=2, B=5, k=16 one element of 320, 5.2e-4 of a
    largest 0.30, keeps 8.8e-4 of its products' magnitudes; the port is
    1.05e-6 from float64 there and JAX 3.1e-7, both inside the
    tolerance, 1.36e-6 apart.  Float64 decides which is right there."""
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
    e64, gz64, kept = _float64_energy_and_dz(z, fw, fb, dl, ctx, r, b, k)
    e_t, gz_t = e_t.detach().numpy(), gz_t.numpy()
    e_j, gz_j = np.asarray(e_j), np.asarray(gz_j)
    for e, gz in ((e_t, gz_t), (e_j, gz_j)):
        np.testing.assert_allclose(e, e64, rtol=2e-5)
        np.testing.assert_allclose(gz, gz64, rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(e_t, e_j, rtol=2e-5)
    big = (np.abs(gz64) > 1e-3 * np.abs(gz64).max()) & (kept > 1e-3)
    assert big.mean() > 0.95
    np.testing.assert_allclose(gz_t[big], gz_j[big], rtol=5e-4, atol=1e-6)


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


def _unpack_pass(flat, mt, kch):
    """A (16 mt, 3 * K channels padded to 8) from one pass's fragments,
    by the lane map of mma.m16n8k8's A operand as the kernel reads it:
    the float4 at [k-step][m-tile][lane] holds (g, t4), (g + 8, t4),
    (g, t4 + 4), (g + 8, t4 + 4), g = lane / 4, t4 = lane % 4."""
    ks = 3 * (-(-kch // 8))
    a = torch.zeros(16 * mt, 8 * ks, dtype=flat.dtype)
    q = flat.reshape(ks, mt, 32, 4)
    for lane in range(32):
        g, t4 = divmod(lane, 4)
        for i, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
            a[g + dm::16, :][:, t4 + dk::8] = q[:, :, lane, i].t()
    return a


def _kernel_chain(dl, h0, g_pose):
    """The kernel's passes over the packed buffer, in float64: per pass
    out[m][n] = sum_k A[m][k] B[k][n], B[(cb, tap, c)][n] the frame slot
    t(n) + tap - 1 of n's own row (slots 0 and T + 1 zero), the forward
    masks set where pre >= 0 and applied to the backward's gradients."""
    from globalegomocap_tpu_torch.ops.fused_decode_energy import (
        passes, passes_floats)
    dims, f64 = dl.dims, torch.float64
    n, rows = len(dims) - 1, h0.shape[0]
    sizes = passes_floats(dims)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    bias = [dl.packed[offs[len(sizes) - n + i]:][:dims[i + 1]].to(f64)
            for i in range(n)]
    outs, x, masks = {}, h0.to(f64), {}
    for q, (i, bwd, t0, mt, m, kch) in enumerate(passes(dims)):
        a = _unpack_pass(dl.packed[offs[q]:offs[q + 1]].to(f64), mt, kch)
        src = x
        pk = -(-kch // 8) * 8
        slots = torch.zeros(rows, T + 2, pk, dtype=f64)
        slots[:, 1:T + 1, :kch] = src
        bm = torch.stack([slots[:, tap:tap + T] for tap in range(3)], 2)
        bm = bm.reshape(rows, T, 3, pk // 8, 8).permute(3, 2, 4, 0, 1)
        out = (a @ bm.reshape(3 * pk, rows * T)).t().reshape(rows, T, -1)
        outs.setdefault((i, bwd), []).append(out)
        if t0 + mt < -(-m // 16):
            continue
        out = torch.cat(outs[(i, bwd)], -1)[..., :m]
        if not bwd:
            out = out + bias[i]
            if i < n - 1:
                masks[i] = out >= 0
                out = torch.where(masks[i], out, 0.01 * out)
            x = out
            if i == n - 1:
                pose, x = out, g_pose.to(f64)
        else:
            if i > 0:
                out = torch.where(masks[i - 1], out, 0.01 * out)
            x = out
    return pose, x


@pytest.mark.parametrize("dims", [(32, 16, 16, 8, 8, 8, 45),
                                  (512, 256, 128, 64, 64, 64, 45)],
                         ids=["tiny", "production"])
def test_packed_weights_read_as_the_kernel_reads_them(dims):
    """`pack_layers`' buffer, read back through the kernel's index map
    (fragment lanes, K order, frame slots with zero ends, the backward's
    reversed taps, passes of at most 256 rows), gives the plain chain's
    pose and its autograd input-transpose in float64 to 1e-12, on rows
    whose neighbours hold large values (a row edge that leaked would
    show)."""
    gen = torch.Generator().manual_seed(5)
    layers = [(torch.randn(3, a, b, generator=gen) * (3 * a) ** -0.5,
               0.1 * torch.randn(b, generator=gen))
              for a, b in zip(dims[:-1], dims[1:])]
    dl = fde.pack_layers(layers)
    assert dl.dims == dims and dl.packed.dtype == torch.float32
    h0 = torch.randn(3, T, dims[0], generator=gen)
    h0[0] *= 1e3                                 # the neighbours are large
    h0[2] *= 1e3
    g_pose = torch.randn(3, T, dims[-1], generator=gen)
    pose, gh0 = _kernel_chain(dl, h0, g_pose)
    f64 = torch.float64
    with torch.enable_grad():
        h = h0.to(f64).requires_grad_(True)
        ref = h
        for i, (kern, bias) in enumerate(layers):
            ref = fde.conv3(ref, kern.to(f64), bias.to(f64))
            if i < len(layers) - 1:
                ref = torch.where(ref >= 0.0, ref, 0.01 * ref)
        (g_ref,) = torch.autograd.grad(ref, h, grad_outputs=g_pose.to(f64))
    torch.testing.assert_close(pose, ref.detach(), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gh0, g_ref, rtol=1e-12, atol=1e-12)


def test_wrapper_checks_and_packing(prior):
    """The packed buffer's parts (`passes_floats`: each pass's fragments,
    then the biases padded to 16) and the wrapper's argument checks."""
    _, v = prior
    _, _, dl = fde.decoder_layers(_port_model(v))
    assert dl.dims == (32, 16, 16, 8, 8, 8, 45)
    assert dl.packed.numel() == sum(fde.passes_floats(dl.dims))
    kern, bias = dl.layers[-1]
    torch.testing.assert_close(dl.packed[-48:-3], bias)
    assert (dl.packed[-3:] == 0).all()
    # the first pass's first fragment: lane 0 holds A[0][0], A[8][0],
    # A[0][4], A[8][4] of layer 0 forward (A[co][(cb, tap, c)] =
    # kern[tap][cb*8 + c][co])
    k0 = dl.layers[0][0]
    torch.testing.assert_close(dl.packed[:4], torch.stack(
        [k0[0, 0, 0], k0[0, 0, 8], k0[0, 4, 0], k0[0, 4, 8]]))
    assert [p[:2] for p in fde.passes((512, 256, 128, 64, 64, 64, 45))] == [
        (0, False), (1, False), (2, False), (3, False), (4, False),
        (5, False), (5, True), (4, True), (3, True), (2, True), (1, True),
        (0, True), (0, True)]              # 512 backward rows: two passes
    a, c, x, y, bl, tctx = _port_ctx(_context(3, 8, seed=0))
    with pytest.raises(ValueError, match="channels"):
        fde.decode_energy_and_grad(torch.zeros(1, 3, T, 16), dl, a, c, x, y,
                                   bl, *tctx, T, J, 8, FULL_HW, 128.0, 512.0)
    with pytest.raises(TypeError, match="crops"):
        fde.decode_energy_and_grad(torch.zeros(1, 3, T, C0), dl, a,
                                   c.half(), x, y, bl, *tctx, T, J, 8,
                                   FULL_HW, 128.0, 512.0)


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


# ---------------------------------------------------------------------------
# 3xTF32: the numerics of kernel 5's tensor-core chain, emulated on the CPU
# ---------------------------------------------------------------------------

DEC_DIMS = (512, 256, 128, 64, 64, 64, 45)


def _tf32(x):
    """cvt.rna.tf32.f32: float32 rounded to TF32's 10 stored significand
    bits, to nearest with ties away from zero (the low 13 bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, passes):
    """a @ b as the tensor cores take it: each operand split into big =
    tf32(x) and small = tf32(x - big); 3xTF32 sums small.big + big.small +
    big.big, one pass only big.big; float32 sums."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    return (_tf32(a - ab) @ bb + ab @ _tf32(b - bb)) + ab @ bb


def _chain(h0, layers, g_pose, passes):
    """The conv chain forward (pose (N, T, 45)) and its input-transpose
    backward of g_pose (N, T, 45) down to dE/dh0, every product through
    `_mm`, each LeakyReLU mask set where its pre-activation >= 0."""
    pad = torch.nn.functional.pad
    masks, h = [], h0
    for i, (kern, bias) in enumerate(layers):
        hp = pad(h, (0, 0, 1, 1))
        h = sum(_mm(hp[:, tap:tap + T], kern[tap], passes)
                for tap in range(3)) + bias
        if i < len(layers) - 1:
            masks.append(h >= 0.0)
            h = torch.where(masks[-1], h, 0.01 * h)
    pose, g = h, g_pose
    for i in range(len(layers) - 1, -1, -1):
        if i < len(layers) - 1:
            g = torch.where(masks[i], g, 0.01 * g)
        gp = pad(g, (0, 0, 1, 1))
        kern = layers[i][0]
        g = sum(_mm(gp[:, 2 - tap:2 - tap + T], kern[tap].t(), passes)
                for tap in range(3))
    return pose, g


@pytest.mark.parametrize("passes", [3, 1], ids=["3xTF32", "1xTF32"])
def test_tf32_split_keeps_the_chip_bars(passes):
    """One window through the production chain (512-256-128-64-64-64-45,
    random folded weights and h0 made as chip_smoke.decode_inputs makes
    them, from a seeded CPU generator) with every product of the forward
    and of the input-transpose backward on emulated tensor cores, against
    the plain float32 chain and its autograd backward of the same
    dE/dpose (seeded noise).  3xTF32 meets chip_smoke.decode_check's bars,
    pose |dp| <= 1e-5 (1 + |p|) and dE/dh0 |d| / |g| <= 1e-4; a single
    TF32 pass does not, which is why the kernel splits."""
    from globalegomocap_tpu_torch.ops.skeleton import MEAN3D_MM
    gen = torch.Generator().manual_seed(29)
    noise = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    layers = []
    for i, (cin, cout) in enumerate(zip(DEC_DIMS[:-1], DEC_DIMS[1:])):
        last = i == len(DEC_DIMS) - 2
        kern = noise(3, cin, cout) * (3 * cin) ** -0.5 * (0.1 if last
                                                          else 1.0)
        bias = (torch.as_tensor(MEAN3D_MM.T.reshape(-1) / 1000.0,
                                dtype=torch.float32)
                if last else 0.1 * noise(cout))
        layers.append((kern, bias))
    h0 = (noise(1, T, DEC_DIMS[0]) + 0.1 * noise(1, T, DEC_DIMS[0]))
    g_pose = noise(1, T, DEC_DIMS[-1])

    with torch.enable_grad():
        h = h0.clone().requires_grad_(True)
        pose_ref = h
        for i, (kern, bias) in enumerate(layers):
            pose_ref = fde.conv3(pose_ref, kern, bias)
            if i < len(layers) - 1:
                pose_ref = pose_ref * torch.where(pose_ref >= 0.0, 1.0, 0.01)
        (g_ref,) = torch.autograd.grad(pose_ref, h, grad_outputs=g_pose)
    pose_ref = pose_ref.detach()
    pose, g = _chain(h0, layers, g_pose, passes)

    dp = float(((pose - pose_ref).abs() / (1 + pose_ref.abs())).max())
    rel = float((g - g_ref).norm() / g_ref.norm())
    meets = dp <= 1e-5 and rel <= 1e-4
    assert meets == (passes == 3), (passes, dp, rel)
