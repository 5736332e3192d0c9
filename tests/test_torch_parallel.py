"""The port's mesh helpers (`parallel/mesh.py`) and the chunk-sharded
batched solve (`SequenceOptimizer` over a mesh of two ranks) against the
JAX package's, whose `SequenceOptimizer` shards the chunk axis over the 8
virtual CPU devices of tests/conftest.py.

The ranks are two gloo processes on the CPU, spawned once for the module
(`parallel.mesh.spawn`); they run `tests/torch_parallel_workers.py`,
which imports no JAX, and hand numpy results back.  The same worker
called here with a mesh of one rank gives the port's one-rank reference.

Tolerances: the pads and slices exact; the solves against JAX at the
fixed-iteration tolerance of tests/test_torch_pipeline.py (rtol 1e-3,
atol 2e-4 at 2 + 1 iterations, the tiny prior, 3 chunks padded to 4,
the plain energy);
against the port's one-rank solve 1e-5 relative (1e-6 absolute: the
ranks solve the same windows in smaller batches); the coverage 1e-6
relative; the statistic of the padded stack against JAX's numpy one
1e-5 (test_torch_prior_bank.py's)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from globalegomocap_tpu.data.synthetic import synthetic_chunk_v2
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu.optimize import prior_bank as jbank
from globalegomocap_tpu.parallel.mesh import pad_to_multiple as jax_pad
from globalegomocap_tpu_torch.config import TrainConfig
from globalegomocap_tpu_torch.optimize import driver as tdriver
from globalegomocap_tpu_torch.parallel import mesh as pm
from globalegomocap_tpu_torch.train.train_vae import Trainer
from tests import torch_parallel_workers as workers
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_chunk, port_state, slice_config, tcfg)

KNOBS = dict(max_iter=2, global_max_iter=1, robust_tier_on_guard=False)


def solve_config(pkg):
    """The serve stack at KNOBS on the plain energy: JAX's fused kernel
    is a Pallas kernel in interpret mode here, which doubles its compile
    time; the kernels' launches per rank are checked on the card."""
    cfg = slice_config(pkg, **KNOBS)
    return replace(cfg, solver=replace(cfg.solver, fused_energy=False,
                                       fused_probes=False))
MODES = ["flat", "vmap"]
SMOOTH, JERKY = 5e-4, 2e-2     # bank statistics either side of the chunks'


def cpu_mesh(size=1, rank=0):
    return pm.Mesh(None, "gloo" if size > 1 else None, rank, size,
                   torch.device("cpu"))


# ---------------------------------------------------------------------------
# the helpers in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,multiple,axis", [
    ((5, 3), 2, 0), ((5, 3), 4, 1), ((6, 2, 2), 3, 0), ((1, 4), 8, 0),
    ((7,), 1, 0), ((3, 26, 15, 3), 2, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    """Edge padding of numpy arrays and tensors: JAX's values and length;
    an axis that needs nothing comes back as it is."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want, wn = jax_pad(jnp.asarray(x), multiple, axis)
    for arr in (x, torch.from_numpy(x)):
        got, n = pm.pad_to_multiple(arr, multiple, axis)
        assert n == wn == shape[axis]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        if shape[axis] % multiple == 0:
            assert got is arr


def test_shard_batch_takes_each_ranks_equal_slice():
    """Three ranks' slices of axis 0 and 1 cover the array in rank order,
    numpy and tensors alike; an axis of 7 raises, as JAX's device_put
    onto P('dp'); on an index range edge-padded by pad_to_multiple it
    gives each rank the rows that the driver stages."""
    x = np.arange(6 * 9).reshape(6, 9)
    for axis in (0, 1):
        for arr in (x, torch.from_numpy(x)):
            parts = [pm.shard_batch(cpu_mesh(3, r), arr, axis)
                     for r in range(3)]
            joined = (np.concatenate if isinstance(arr, np.ndarray)
                      else torch.cat)(parts, axis)
            np.testing.assert_array_equal(np.asarray(joined), x)
    with pytest.raises(ValueError, match="7 does not divide into 3"):
        pm.shard_batch(cpu_mesh(3, 0), np.zeros(7))
    assert pm.window_sharding is pm.shard_batch
    assert pm.shard_batch(cpu_mesh(), x) is x
    rows = [pm.shard_batch(cpu_mesh(4, r),
                           pm.pad_to_multiple(np.arange(3), 4)[0]).tolist()
            for r in range(4)]
    assert rows == [[0], [1], [2], [2]]
    rows = [pm.shard_batch(cpu_mesh(2, r),
                           pm.pad_to_multiple(np.arange(5), 2)[0]).tolist()
            for r in range(2)]
    assert rows == [[0, 1, 2], [3, 4, 4]]


def test_a_mesh_without_a_group_is_one_rank(monkeypatch):
    """make_mesh without a process group: one rank, no group, no backend,
    on the device asked for (the card by default, as for spawn's ranks
    where no devices are listed); asking for another
    rank count raises naming both (JAX's make_mesh takes fewer devices);
    the trainer's num_devices goes through it."""
    assert not dist.is_initialized()
    m = pm.make_mesh(device="cpu")
    assert (m.group, m.backend, m.rank, m.size, m.device) == (
        None, None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match=r"make_mesh\(2\).* 1 rank"):
        pm.make_mesh(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.spawn(workers.fails_on, 2, args=(0,))
    cfg = TrainConfig(latent_dim=8, num_devices=2, batch_size=4)
    with pytest.raises(ValueError, match=r"make_mesh\(2\)"):
        Trainer(cfg, None, None, device="cpu")
    with pytest.raises(ValueError, match="batch_size 5 does not split"):
        Trainer(TrainConfig(latent_dim=8, batch_size=5), None, None,
                device="cpu", mesh=cpu_mesh(2))


@pytest.fixture(scope="module")
def case():
    """The tiny prior's weights (two seeded pairs for the bank), 3 JAX
    chunks of 26 frames, and a jerky chunk."""
    model = jdriver.build_model(slice_config(jcfg))
    va, vb = jax_variables(model, seed=0), jax_variables(model, seed=9)
    cs = chunks(26, seeds=(1, 2, 3))
    jerky = synthetic_chunk_v2(26, seed=3)
    return (va, vb), (port_state(va), port_state(vb)), cs, jerky


def _worker_args(case):
    _, (sa, sb), cs, jerky = case
    bank = [("smooth", sa, SMOOTH), ("jerky", sb, JERKY)]
    return (solve_config(tcfg), sa, [port_chunk(c) for c in cs],
            bank, port_chunk(jerky))


def test_a_mesh_of_one_rank_makes_no_collective(case, monkeypatch):
    """Without a group every helper returns its input, and the optimizer
    stages, solves both modes and the window-sharded chunk with no
    collective call: optimize_chunk_sharded is optimize_chunk bit for
    bit, and the rows staged are the chunks, unpadded."""
    def refuse(*a, **k):
        raise AssertionError("a collective on a mesh of one rank")
    for name in ("all_reduce", "all_gather", "broadcast",
                 "all_gather_into_tensor"):
        monkeypatch.setattr(dist, name, refuse)
    m = cpu_mesh()
    t = torch.ones(3)
    assert pm.all_reduce(m, t) is t and pm.all_gather(m, t) is t
    lin = torch.nn.Linear(2, 2)
    pm.replicate(m, lin)
    out = workers.chunk_sharded(m, *_worker_args(case))
    assert out["host"]["rows"] == out["device"]["rows"] == 3
    cfg, sa, cs, _, _ = _worker_args(case)
    opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sa, sa, cfg,
                                    device="cpu")
    a, b = opt.optimize_chunk(cs[0]), opt.optimize_chunk_sharded(cs[0])
    for f in a._fields:
        torch.testing.assert_close(getattr(b, f), getattr(a, f), rtol=0,
                                   atol=0)


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(case):
    """The two ranks' results (collectives, the chunk-sharded solves and
    the bank) and the one-rank reference of the same worker."""
    out = pm.spawn(workers.several, 2, ["cpu"] * 2, timeout_s=300,
                   threads=1, args=([
        ("collectives", ()), ("chunk_sharded", _worker_args(case))],))
    one = workers.chunk_sharded(cpu_mesh(), *_worker_args(case))
    return out, one


def test_spawn_hands_back_rank_zeros_exception():
    """A rank's exception reaches the caller as itself (rank 0's first),
    and the group is torn down: a later spawn works (the fixture's)."""
    with pytest.raises(ValueError, match="rank 0 failed on purpose"):
        pm.spawn(workers.fails_on, 2, ["cpu"] * 2, timeout_s=120,
                 threads=1, args=(0,))


def test_collectives_over_two_gloo_ranks(ranks):
    """all_reduce and its backward (the upstream gradients summed),
    all_gather along an axis, one all_gather of a float32 and a bf16
    field, and replicate of a module and Adam's state from rank 0."""
    (r0, _), (r1, _) = ranks[0]
    for r, rec in enumerate((r0, r1)):
        assert (rec["rank"], rec["size"], rec["backend"], rec["device"]) \
            == (r, 2, "gloo", "cpu")
        np.testing.assert_array_equal(rec["sum"], [0.0, 3.0, 6.0])
        np.testing.assert_array_equal(rec["grad"], [2.0, 4.0, 6.0])
        np.testing.assert_array_equal(rec["gather"],
                                      [[0, 0, 1, 1], [0, 0, 1, 1]])
        np.testing.assert_array_equal(rec["fa"][:, 0, 0], [0.0, 1.0])
        np.testing.assert_array_equal(rec["fb"], [[0.5] * 4, [1.5] * 4])
        assert rec["fb_dtype"] == "torch.bfloat16"
    torch.manual_seed(0)          # rank 0's module and step, here
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(lin.parameters())
    lin(torch.randn(4, 3)).sum().backward()
    opt.step()
    for rec in (r0, r1):
        np.testing.assert_array_equal(rec["weight"], lin.weight.detach())
        np.testing.assert_array_equal(rec["moment"],
                                      opt.state[lin.weight]["exp_avg"])


@pytest.fixture(scope="module")
def jax_solves(case):
    """JAX's batched solve of the 3 chunks in both modes, host-staged and
    sharded over its 8 devices (padded to 8)."""
    (va, _), _, cs, _ = case
    jc = solve_config(jcfg)
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), va, va, jc)
    staged = jopt.stage(cs, on_host=True)
    assert staged.est.shape[0] == 8 and staged.n_chunks == 3
    return {mode: jax.tree_util.tree_map(
        np.asarray, jopt.optimize_chunks_batched(staged, mode=mode))
        for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_chunk_sharded_solve_matches_jax(ranks, jax_solves, mode):
    """3 chunks on two ranks, padded to 4: each rank stages 2 rows of the
    3 chunks, the guard's coverage is the one-rank batch's, and every
    rank's gathered result, on either staging, is the same, within
    1e-5 of the one-rank solve and within the fixed-iteration tolerance
    of JAX's."""
    out, one = ranks
    (_, r0), (_, r1) = out
    for where in ("host", "device"):
        for rec in (r0, r1):
            assert rec[where]["rows"] == 2 and rec[where]["n_chunks"] == 3
            np.testing.assert_allclose(rec[where]["coverage"],
                                       one[where]["coverage"], rtol=1e-6)
        key = f"{where}-{mode}"
        for name, want in jax_solves[mode]._asdict().items():
            got = r0[key][name]
            assert got.shape == want.shape == (3, 26, 15, 3), name
            np.testing.assert_array_equal(r1[key][name], got)
            np.testing.assert_allclose(got, one[key][name], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{key} {name}")
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4,
                                       err_msg=f"{key} {name}")


def test_bank_selection_over_two_ranks(case, ranks):
    """optimize_chunk_sharded with a prior bank picks JAX's entry for the
    jerky chunk and solves it as one rank does; the staged batch's
    statistic is JAX's quirk: taken over the chunks edge-padded to the
    mesh size (3 to 4 here), so the duplicated last chunk weighs in."""
    (_, r0), (_, r1) = ranks[0]
    one = ranks[1]
    _, _, cs, jerky = case
    jc = solve_config(jcfg)
    (va, vb), _, _, _ = case
    bank = jbank.PriorBank().add("smooth", va, va, SMOOTH).add(
        "jerky", vb, vb, JERKY)
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), va, va, jc,
                                     prior_bank=bank)
    jopt._select_priors(jbank.motion_accel_stat(
        np.asarray(jerky.estimated_local), window=10))
    assert r0["bank_name"] == r1["bank_name"] == one["bank_name"] \
        == jopt.last_prior_name
    for name, want in one["bank"].items():
        np.testing.assert_allclose(r0["bank"][name], want, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    est = np.stack([np.asarray(c.estimated_local) for c in cs])
    padded = jbank.motion_accel_stat(np.asarray(jax_pad(est, 2)[0]),
                                     window=10)
    assert r0["bank_stat"] == r1["bank_stat"]
    assert r0["bank_stat"] == pytest.approx(padded, rel=1e-5)
    assert abs(padded - one["bank_stat"]) > 1e-4 * padded
