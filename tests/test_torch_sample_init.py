"""The sample init (solver.init='sample', `conv_vae.sample_init` in
`pipeline.optimize_stage`) against the JAX package's, path by path, at
the tiny prior on the CPU.

The JAX `SequenceOptimizer` of a test process shards over the 8 virtual
devices of tests/conftest.py, and a sharded JAX program draws per shard,
so one rank of the port is held against JAX's pipeline under a plain
`jit` (the per-window `optimize_chunk`, `optimize_chunks_flat`, and
`optimize_chunks_batched` of mode 'vmap'), and two ranks against JAX's
programs over `make_mesh(2)` as the JAX driver builds them: shard_map
(batched_solver: every device draws its own shape, so its rows repeat
device 0's) for the flat and vmap modes and the window-sharded solve,
and jit with shardings for the flat mode with neither flag (one draw
over every device's windows).

Tolerances: float32 solves at 2 + 1 iterations at
tests/test_torch_pipeline.py's (rtol 1e-3, atol 2e-4).  The bf16 tiers
branch on rounding from the second iteration on (ROADMAP.md section C),
so they are held at 0 iterations, where the result is the decode of the
sampled start: bfloat16_delta (float32 draw and decode) within 1e-6,
bfloat16_pure (bf16 draw, bf16 decode) within one bf16 step at the
poses' scale, 2**-7."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from globalegomocap_tpu.models.conv_vae import reparameterize
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu.optimize import pipeline as jpipe
from globalegomocap_tpu.parallel.mesh import (
    make_mesh as jax_mesh, pad_to_multiple, replicate, shard_batch)
from globalegomocap_tpu_torch.models.conv_vae import sample_init
from globalegomocap_tpu_torch.optimize import driver as tdriver
from globalegomocap_tpu_torch.optimize import pipeline as tpipe
from globalegomocap_tpu_torch.parallel import mesh as pm
from tests import torch_parallel_workers as workers
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_chunk, port_state, slice_config, tcfg)

PATHS = ["window", "flat", "vmap"]
SEED = 7


def sample_config(pkg, tier="float32", batched=True, iters=(2, 1),
                  seed=SEED, init="sample"):
    """The serve stack on the plain energy (JAX's fused kernel would run
    its Pallas interpreter) with the batched solver, or with
    `batched=False` the per-window solver."""
    cfg = slice_config(pkg, max_iter=iters[0], global_max_iter=iters[1],
                       robust_tier_on_guard=False, compute_dtype=tier)
    return replace(cfg, solver=replace(
        cfg.solver, fused_energy=False, fused_probes=False,
        batched_solver=batched, init=init, init_seed=seed))


@pytest.fixture(scope="module")
def prior():
    v = jax_variables(jdriver.build_model(slice_config(jcfg)), seed=0)
    return v, port_state(v), chunks(26, seeds=(1, 2, 3))


def _fields(res) -> dict:
    return {k: np.asarray(jnp.asarray(getattr(res, k)).astype(jnp.float32))
            for k in res._fields}


def _staged(jopt, cs, multiple=1):
    """JAX's host staging of `cs`, the padding to its 8 devices cut and
    the chunk axis edge-padded to `multiple`."""
    st = jopt.stage(cs, on_host=True)
    n = st.n_chunks

    def cut(x):
        return None if x is None else pad_to_multiple(x[:n], multiple)[0]
    return (cut(st.est), cut(st.cams), cut(st.heat), cut(st.gt),
            cut(st.origins), st.full_hw, n)


def _jax_chunks(jopt, jc, cs, mode, shards=None):
    """JAX's batched pipeline of mode 'flat' or 'vmap' on `cs`: under a
    plain jit, or over make_mesh(shards) as the JAX driver runs it
    (shard_map where the config sets fused_energy or batched_solver,
    else jit with shardings)."""
    est, cams, heat, gt, org, full_hw, n = _staged(jopt, cs, shards or 1)
    fn = (jpipe.optimize_chunks_flat if mode == "flat"
          else jpipe.optimize_chunks_batched)

    def run(lv, gv, est, cams, heat, gt, org):
        return fn(jopt.model, lv, gv, est, cams, heat, gt, jopt._camera, jc,
                  origins=org, full_hw=full_hw)
    if shards is None:
        prog = jax.jit(run)
    elif jc.solver.fused_energy or jc.solver.batched_solver:
        prog = jax.jit(jax.shard_map(
            run, mesh=jax_mesh(shards),
            in_specs=(P(), P(), P("dp"), P("dp"), P("dp"), P("dp"),
                      P("dp")),
            out_specs=P("dp"), check_vma=False))
    else:
        mesh = jax_mesh(shards)
        repl, sh = replicate(mesh), shard_batch(mesh)
        prog = jax.jit(run, in_shardings=(repl, repl, sh, sh, sh, sh, sh))
    res = prog(jopt.local_variables, jopt.global_variables, est, cams, heat,
               gt, org)
    return {k: v[:n] for k, v in _fields(res).items()}


def _jax_path(prior, jc, path):
    v, _, cs = prior
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), v, v, jc)
    if path == "window":
        return _fields(jopt.optimize_chunk(cs[0]))
    return _jax_chunks(jopt, jc, cs, path)


def _port_path(prior, tc, path):
    _, sd, cs = prior
    topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                     device="cpu")
    if path == "window":
        return workers.fields(topt.optimize_chunk(port_chunk(cs[0])))
    return workers.fields(topt.optimize_chunks_batched(
        topt.stage([port_chunk(c) for c in cs], on_host=True), mode=path))


def _hold(got, want, atol, rtol=0.0):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mu_dt,lv_dt", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16")], ids=["float32", "bfloat16_pure", "f32head"])
def test_sample_init_is_jax_reparameterize(mu_dt, lv_dt):
    """sample_init against JAX's reparameterize(mu, log_var,
    PRNGKey(seed)) in the dtypes the tiers encode in (bfloat16_f32head:
    a float32 mu, a bf16 log_var): the draw takes mu's dtype, and the
    result is JAX's dtype; float32 within float32 rounding of the draw,
    bfloat16 within one bf16 step.  A row offset takes the rows of the
    larger draw."""
    rng = np.random.default_rng(0)
    mu = rng.normal(size=(12, 64)).astype(np.float32)
    lv = rng.uniform(-2.0, 0.5, size=(12, 64)).astype(np.float32)
    jm, jl = jnp.asarray(mu, mu_dt), jnp.asarray(lv, lv_dt)
    want = reparameterize(jm, jl, jax.random.PRNGKey(SEED))
    tm = torch.from_numpy(mu).to(getattr(torch, mu_dt))
    tl = torch.from_numpy(lv).to(getattr(torch, lv_dt))
    got = sample_init(tm, tl, SEED)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    atol = 2e-6 if mu_dt == "float32" else 2.0 ** -6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=atol)
    rows = sample_init(tm[6:], tl[6:], SEED, row=6)
    np.testing.assert_array_equal(rows.float().numpy(),
                                  got[6:].float().numpy())


# ---------------------------------------------------------------------------
# one rank against JAX's pipeline under a plain jit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_sample_init_matches_jax(prior, path):
    """float32 at 2 + 1 iterations: the per-window path (one chunk, the
    per-window solver), the flat path (3 chunks, one (C*W, latent) draw)
    and the vmap mode (the same (W, latent) rows for every chunk)."""
    jc, tc = (sample_config(pkg, batched=path != "window")
              for pkg in (jcfg, tcfg))
    _hold(_port_path(prior, tc, path), _jax_path(prior, jc, path),
          atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("tier,path", [
    ("bfloat16_delta", "flat"), ("bfloat16_delta", "vmap"),
    ("bfloat16_pure", "window"), ("bfloat16_pure", "flat")])
def test_sampled_start_matches_jax_at_the_bf16_tiers(prior, tier, path):
    """At 0 iterations stage 1 returns the decode of the sampled start
    and stage 2 its residual anchor: the float32 draw of bfloat16_delta
    within 1e-6 on the batched paths, where its delta state runs (the
    per-window solver runs it as the mixed tier, with float32's draw),
    the bf16 draw of bfloat16_pure within one bf16 step on the
    per-window and the batched solver."""
    jc, tc = (sample_config(pkg, tier, batched=path != "window",
                            iters=(0, 0)) for pkg in (jcfg, tcfg))
    want = _jax_path(prior, jc, path)
    got = _port_path(prior, tc, path)
    _hold(got, want, atol=1e-6 if tier == "bfloat16_delta" else 2.0 ** -7)


def test_the_sample_moves_the_start_and_follows_the_seed(prior):
    """The sampled start is not mu's (by more than 1e-2 m), the same seed
    gives the same result bit for bit, and another seed another one."""
    def start(**kw):
        return _port_path(prior, sample_config(tcfg, iters=(0, 0), **kw),
                          "flat")["mid_local"]
    mu, a, b, c = (start(init="mu"), start(), start(), start(seed=8))
    assert np.abs(a - mu).max() > 1e-2
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-2


def test_sample_init_is_refused_only_when_unknown():
    """check_supported takes 'sample' and still names an unknown init."""
    tpipe.check_supported(sample_config(tcfg))
    with pytest.raises(ValueError, match="solver.init='gaussian'"):
        tpipe.check_supported(sample_config(tcfg, init="gaussian"))


# ---------------------------------------------------------------------------
# two ranks against JAX over make_mesh(2)
# ---------------------------------------------------------------------------

CASES = {   # name: (mode, batched_solver, iterations)
    "flat-shard_map": ("flat", True, (2, 1)),
    "vmap-shard_map": ("vmap", True, (2, 1)),
    "flat-jit": ("flat", False, (2, 1)),
    "window-shard_map": ("window", True, (2, 1)),
    "flat-shard_map-start": ("flat", True, (0, 0)),
    "flat-jit-start": ("flat", False, (0, 0)),
}


@pytest.fixture(scope="module")
def two_ranks(prior):
    _, sd, cs = prior
    pc = [port_chunk(c) for c in cs]
    return pm.spawn(workers.sample_sharded, 2, ["cpu"] * 2, timeout_s=240,
                    threads=1,
                    args=([(name, sample_config(tcfg, batched=b, iters=it),
                            sd, pc, mode)
                           for name, (mode, b, it) in CASES.items()],))


@pytest.mark.parametrize("name", list(CASES)[:4])
def test_two_ranks_match_jax_over_two_devices(prior, two_ranks, name):
    """Each rank's gathered result against JAX's two-device program: 3
    chunks padded to 4 (2 a rank), or one chunk's 3 windows padded to 4;
    both ranks return the same result."""
    v, _, cs = prior
    mode, batched, iters = CASES[name]
    jc = sample_config(jcfg, batched=batched, iters=iters)
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), v, v, jc)
    if mode == "window":
        want = _fields(jopt.optimize_chunk_sharded(cs[0], mesh=jax_mesh(2)))
    else:
        want = _jax_chunks(jopt, jc, cs, mode, shards=2)
    for rank in two_ranks:
        _hold(rank[name], want, atol=2e-4, rtol=1e-3)


def test_shard_map_ranks_repeat_rank_zeros_rows(two_ranks):
    """At 0 iterations (the decode of the sampled start): under
    shard_map each rank draws its own (2 * W, latent) rows from index 0,
    under jit one (4 * W, latent) draw is split between the ranks, so
    the two flat results agree on rank 0's chunks and differ on rank
    1's."""
    for rank in two_ranks:
        a = rank["flat-shard_map-start"]["mid_local"]
        b = rank["flat-jit-start"]["mid_local"]
        np.testing.assert_allclose(a[:2], b[:2], rtol=1e-5, atol=1e-6)
        assert np.abs(a[2] - b[2]).max() > 1e-2
