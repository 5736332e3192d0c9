"""The port's `cli/evaluate_all.py`, `optimize_sequence_dir(batched=True)`
and `SequenceOptimizer.optimize_chunks_batched(mode="vmap")` against the
JAX package, on flax msgpack priors written by the JAX package's
`save_msgpack` (the tiny prior of tests/test_golden.py) and the same
synthetic chunks.

evaluate_all runs at its defaults (strong-Wolfe L-BFGS, one staged flat
solve a sequence) except --max_iter 3 --global_max_iter 2 and the
repo's sampling pairing (the port's `pallas`, the heatmap_sample
kernel's plain version here, against JAX's `dense`, the same function):
per-sequence and overall metrics within 5 % (the JAX CLI builds its
SolverConfig from --solver alone, so the test gives it the same
iteration budget there).  A batched sequence with the strong-Wolfe
solver at 1 + 1 iterations and with Adam, and mode="vmap" (and its
cross-window coupling) at 2 + 1, are held field by field at
tests/test_torch_pipeline.py's tolerance (rtol 1e-3, atol 2e-4).  The
strong-Wolfe solve of the second chunk (seed 2) branches on rounding at
its second iteration (mid_local 5e-4 apart), in the per-chunk path as in
the flat one: each package's flat solve equals its own per-chunk solve
exactly, so the flat path adds nothing to it (ROADMAP section C).  The
vmap mode also equals the port's own per-chunk pipeline exactly."""

import functools
import os
from dataclasses import replace

import jax
import numpy as np
import pytest

from globalegomocap_tpu import config as jconfig_module
from globalegomocap_tpu.cli import evaluate_all as jev
from globalegomocap_tpu.data.test_data import save_test_chunk
from globalegomocap_tpu.evaluation.metrics import METRIC_KEYS
from globalegomocap_tpu.models.checkpoint import save_msgpack
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.cli import evaluate_all as tev
from globalegomocap_tpu_torch.optimize import driver as tdriver
from globalegomocap_tpu_torch.optimize import pipeline as tpipe
from tests.test_torch_chunk import chunk_config
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_chunk, port_state, tcfg)

PRIOR = ["--latent_dim", "32", "--hidden_dims", "8,8,16,16,32"]
RESULT = ("estimated", "mid", "mid_local", "optimized", "gt")


def _write(root, name, cs, start=0):
    for c in cs:
        n = c.estimated_local.shape[0]
        save_test_chunk(c, str(root / name /
                               f"data_start_{start}_end_{start + n}"))
        start += n


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """seqA: 2 chunks of 26 frames; seqB: one chunk and a corrupt one;
    seqC (its own root): chunks of 26 and 34 frames."""
    tmp = tmp_path_factory.mktemp("evaluate_all")
    v = jax_variables(jdriver.build_model(chunk_config(jcfg)), seed=0)
    save_msgpack(v, str(tmp / "prior.msgpack"))
    _write(tmp / "data", "seqA", chunks(26, (1, 2)))
    _write(tmp / "data", "seqB", chunks(26, (3,)))
    bad = tmp / "data" / "seqB" / "data_start_26_end_52"
    bad.mkdir()
    (bad / "test_data.pkl").write_bytes(b"not a pickle")
    _write(tmp / "mixed", "seqC", chunks(26, (5,)))
    _write(tmp / "mixed", "seqC", chunks(34, (6,)), start=26)
    return tmp, v


def _argv(files, root="data"):
    tmp, _ = files
    ck = str(tmp / "prior.msgpack")
    return ["--data_root", str(tmp / root), "--local_ckpt", ck,
            "--global_ckpt", ck] + PRIOR


def _recorded(monkeypatch, cls, log):
    """Every optimize_chunks_batched result of `cls`, as numpy."""
    orig = cls.optimize_chunks_batched

    def solve(self, staged, mode="vmap"):
        res = orig(self, staged, mode=mode)
        log.append({k: np.asarray(getattr(res, k).cpu()
                                  if hasattr(getattr(res, k), "cpu")
                                  else getattr(res, k)) for k in RESULT})
        return res
    monkeypatch.setattr(cls, "optimize_chunks_batched", solve)


def _hold(tres, jres):
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        for k in RESULT:
            assert t[k].shape == j[k].shape, k
            np.testing.assert_allclose(t[k], j[k], rtol=1e-3, atol=2e-4,
                                       err_msg=k)


def test_evaluate_all_matches_jax(files, monkeypatch, capsys):
    tlog = []
    _recorded(monkeypatch, tdriver.SequenceOptimizer, tlog)
    tper = tev.main(_argv(files) + ["--device", "cpu", "--sampling",
                                    "pallas", "--max_iter", "3",
                                    "--global_max_iter", "2"])
    out = capsys.readouterr().out
    assert out.count("SKIPPED corrupt chunk") == 1
    assert "overall averages" in out and "for 2 sequences" in out
    monkeypatch.setattr(jconfig_module, "SolverConfig", functools.partial(
        jconfig_module.SolverConfig, max_iter=3, global_max_iter=2))
    jper = jev.main(_argv(files) + ["--sampling", "dense"])
    assert set(tper) == set(jper) == {"seqA", "seqB"}
    for key in METRIC_KEYS[:17]:
        for seq in jper:
            a, b = float(tper[seq][key]), float(jper[seq][key])
            assert abs(a - b) <= 0.05 * abs(b), (seq, key, a, b)
        a = np.mean([float(v[key]) for v in tper.values()])
        b = np.mean([float(v[key]) for v in jper.values()])
        assert abs(a - b) <= 0.05 * abs(b), ("overall", key, a, b)
    # one flat solve a sequence: 2 chunks, then 1
    assert [r["optimized"].shape[0] for r in tlog] == [2, 1]


@pytest.mark.parametrize("solver", [
    {"method": "lbfgs", "max_iter": 1, "global_max_iter": 1},
    {"method": "adam", "adam_steps": 4}], ids=["lbfgs", "adam"])
def test_batched_sequence_matches_jax(files, monkeypatch, solver):
    """optimize_sequence_dir(batched=True) with the strong-Wolfe solver
    at 1 + 1 iterations and Adam at 4 steps a stage: the flat solve field
    by field and the per-chunk metrics."""
    tmp, v = files
    out, logs = [], ([], [])
    for (pkg, drv, sampling), log in zip(
            ((jcfg, jdriver, "dense"), (tcfg, tdriver, "pallas")), logs):
        _recorded(monkeypatch, drv.SequenceOptimizer, log)
        cfg = chunk_config(pkg, sampling)
        cfg = replace(cfg, solver=replace(cfg.solver, **solver))
        kw = {} if pkg is jcfg else {"device": "cpu"}
        w = v if pkg is jcfg else port_state(v)
        opt = drv.SequenceOptimizer(drv.build_model(cfg), w, w, cfg, **kw)
        out.append(drv.optimize_sequence_dir(opt, str(tmp / "data" / "seqA"),
                                             verbose=False, batched=True))
    (jerr, _, jt), (terr, _, tt) = out
    assert jt["failed_chunks"] == tt["failed_chunks"] == []
    _hold(logs[1], logs[0])
    for a, b in zip(terr, jerr):
        for key in METRIC_KEYS:
            np.testing.assert_allclose(a[key], np.asarray(b[key]),
                                       rtol=1e-3, atol=2e-4, err_msg=key)


def test_unequal_lengths_fall_back_and_a_corrupt_chunk_is_listed(
        files, capsys):
    """A sequence of unequal chunks goes through the per-chunk loop (the
    same averages as batched=False); the corrupt chunk of seqB is
    skipped and listed, the other chunk solved."""
    tmp, v = files
    sd = port_state(v)
    cfg = chunk_config(tcfg, "pallas", max_iter=2, global_max_iter=1)
    cfg = replace(cfg, solver=replace(cfg.solver, method="lbfgs"))
    opt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sd, sd, cfg,
                                    device="cpu")
    seq = str(tmp / "mixed" / "seqC")
    errs, avg, timing = tdriver.optimize_sequence_dir(opt, seq, batched=True)
    assert "falling back to per-chunk" in capsys.readouterr().out
    _, ref, _ = tdriver.optimize_sequence_dir(opt, seq, verbose=False)
    assert len(errs) == 2 and timing["failed_chunks"] == []
    for key in METRIC_KEYS:
        np.testing.assert_array_equal(avg[key], ref[key], err_msg=key)
    errs, _, timing = tdriver.optimize_sequence_dir(
        opt, str(tmp / "data" / "seqB"), verbose=False, batched=True)
    assert len(errs) == 1
    assert [os.path.basename(d) for d, _ in timing["failed_chunks"]] == [
        "data_start_26_end_52"]


def _vmap_both(files, **energy):
    """optimize_chunks_batched(mode="vmap") of both packages over two
    chunks at the parity CLI's lbfgs_fixed knobs, 2 + 1 iterations, and
    the port's own optimize_chunk of each chunk."""
    _, v = files
    sd = port_state(v)
    cs = chunks(26, (1, 2))
    out = []
    for pkg, drv, sampling in ((jcfg, jdriver, "dense"),
                               (tcfg, tdriver, "pallas")):
        cfg = chunk_config(pkg, sampling, max_iter=2, global_max_iter=1)
        cfg = replace(cfg, energy=replace(cfg.energy, **energy),
                      solver=replace(cfg.solver, remat=bool(energy)))
        kw = {} if pkg is jcfg else {"device": "cpu"}
        w = v if pkg is jcfg else sd
        opt = drv.SequenceOptimizer(drv.build_model(cfg), w, w, cfg, **kw)
        batch = cs if pkg is jcfg else [port_chunk(c) for c in cs]
        out.append(opt.optimize_chunks_batched(opt.stage(batch),
                                               mode="vmap"))
    per_chunk = [opt.optimize_chunk(port_chunk(c)) for c in cs]
    return jax.tree_util.tree_map(np.asarray, out[0]), out[1], per_chunk, \
        opt


@pytest.mark.parametrize("energy", [{}, {"overlap_consistency": 0.1}],
                         ids=["independent", "coupled-remat"])
def test_vmap_mode_matches_jax(files, energy):
    """Per chunk, per-window solves (or one joint solve over the chunk's
    windows, coupled on their shared frames, with the decode
    rematerialised): field by field against JAX's vmapped pipeline, and
    exactly the port's optimize_chunk of each chunk.  The flat path
    refuses the coupling, which would cross chunk boundaries."""
    jres, tres, per_chunk, opt = _vmap_both(files, **energy)
    for k in RESULT:
        a = getattr(tres, k).numpy()
        np.testing.assert_allclose(a, getattr(jres, k), rtol=1e-3,
                                   atol=2e-4, err_msg=k)
        for i, r in enumerate(per_chunk):
            np.testing.assert_array_equal(a[i], getattr(r, k).numpy(),
                                          err_msg=k)
    if energy:
        staged = opt.stage([port_chunk(c) for c in chunks(26, (1, 2))])
        with pytest.raises(ValueError, match="overlap_consistency"):
            opt.optimize_chunks_batched(staged, mode="flat")
        with pytest.raises(ValueError, match="overlap_consistency"):
            tpipe.optimize_chunks_flat(
                *opt._stages, staged.est, staged.cams, staged.heat,
                staged.gt, opt._camera_dev, opt.cfg)


def test_batched_sweep_clock_leaves_the_metrics_out(files, monkeypatch):
    """optimize_sequence_dir(batched=True) times the staged solve and not
    the 17 metrics, as the JAX driver's batched path does: with
    calculate_errors slowed by a fixed sleep in both drivers, each
    package's total_s (and so per_chunk_s) stays below the call's wall
    time less the sleep."""
    import time
    tmp, v = files
    sleep = 0.5
    for pkg, drv in ((jcfg, jdriver), (tcfg, tdriver)):
        orig = drv.calculate_errors

        def slow(*args, _orig=orig):
            time.sleep(sleep)
            return _orig(*args)
        monkeypatch.setattr(drv, "calculate_errors", slow)
        cfg = chunk_config(pkg, "dense" if pkg is jcfg else "pallas")
        cfg = replace(cfg, solver=replace(cfg.solver, method="adam",
                                          adam_steps=2))
        kw = {} if pkg is jcfg else {"device": "cpu"}
        w = v if pkg is jcfg else port_state(v)
        opt = drv.SequenceOptimizer(drv.build_model(cfg), w, w, cfg, **kw)
        seq = str(tmp / "data" / "seqA")
        drv.optimize_sequence_dir(opt, seq, verbose=False, batched=True)
        t0 = time.perf_counter()
        errs, _, timing = drv.optimize_sequence_dir(opt, seq, verbose=False,
                                                    batched=True)
        wall = time.perf_counter() - t0
        assert len(errs) == 2 and timing["failed_chunks"] == []
        assert timing["per_chunk_s"] == pytest.approx(timing["total_s"] / 2)
        assert timing["total_s"] <= wall - sleep, (pkg.__name__, timing,
                                                   wall)
