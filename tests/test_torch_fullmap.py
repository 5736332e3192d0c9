"""Full-map reprojection through the port's entry points, against the JAX
package on the same chunks and weights (tiny prior, CPU):

- the flat serve path's guard fallback: a tripped crop-mass guard with
  guard_crop=0 stages the full maps (bf16, bit-exact against the JAX
  staging) and solves them with the batched solver over the plain
  energy, sampled by `sampling_impl`;
- the port's `cli/optimize_sequence` (per-chunk path) at --solver
  lbfgs_fixed against the JAX CLI: the 17-metric summary within 5 %;
- the port's serve CLI with --guard_crop 0 and an unmeetable
  --heatmap_crop_min_mass, and with unequal chunk lengths (the per-chunk
  fallback through `optimize_sequence_dir`).

The port's `pallas` sampling runs the heatmap_sample kernel's plain
version on the CPU; where the JAX side runs the whole slice, it samples
with `dense` (the same function) to stay out of interpret mode."""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from globalegomocap_tpu.cli import optimize_sequence as jcli
from globalegomocap_tpu.cli import serve as jserve
from globalegomocap_tpu.data.test_data import save_test_chunk
from globalegomocap_tpu.evaluation.metrics import METRIC_KEYS
from globalegomocap_tpu.models.checkpoint import save_msgpack
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.cli import optimize_sequence as tcli
from globalegomocap_tpu_torch.cli import serve as tserve
from globalegomocap_tpu_torch.evaluation.metrics import (
    calculate_errors as t_errors)
from globalegomocap_tpu_torch.optimize import driver as tdriver
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_chunk, port_state, slice_config,
    tcfg)

PRIOR = ["--latent_dim", "32", "--hidden_dims", "8,8,16,16,32"]


@pytest.fixture(scope="module")
def prior():
    v = jax_variables(jdriver.build_model(slice_config(jcfg)), seed=0)
    return v, port_state(v)


def _flat_both(prior, sampling, coverage=0.1, **knobs):
    v, sd = prior
    cs = chunks()
    jc = slice_config(jcfg, guard_crop=0, sampling_impl="dense", **knobs)
    tc = slice_config(tcfg, guard_crop=0, sampling_impl=sampling, **knobs)
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), v, v, jc)
    jstaged = jopt.stage(cs, coverage=coverage, on_host=True)
    jres = jax.tree_util.tree_map(
        np.asarray, jopt.optimize_chunks_batched(jstaged, mode="flat"))
    topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                     device="cpu")
    tstaged = topt.stage([port_chunk(c) for c in cs], coverage=coverage,
                         on_host=True)
    tres = topt.optimize_chunks_batched(tstaged, mode="flat")
    return jstaged, tstaged, jres, tres, topt


def test_guard_fallback_stages_full_maps(prior):
    v, sd = prior
    cs = chunks()
    jc = slice_config(jcfg, guard_crop=0)
    tc = slice_config(tcfg, guard_crop=0)
    jst = jdriver.SequenceOptimizer(jdriver.build_model(jc), v, v, jc).stage(
        cs, coverage=0.1, on_host=True)
    topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                     device="cpu")
    tst = topt.stage([port_chunk(c) for c in cs], coverage=0.1, on_host=True)
    assert tst.heat.shape == (2, 26, 64, 64, 15)
    assert tst.heat.dtype == torch.bfloat16
    assert tst.origins is None and tst.full_hw is None
    np.testing.assert_array_equal(
        tst.heat.to(torch.float32).numpy(),
        np.asarray(jax.numpy.asarray(jst.heat).astype(
            jax.numpy.float32))[:2])
    eff = topt._cfg_for_coverage(0.1)
    assert eff.heatmap_crop == 0
    assert (eff.solver.max_iter, eff.solver.history_size,
            len(eff.solver.step_candidates)) == (15, 10, 4)


@pytest.mark.parametrize("sampling", ["dense", "pallas"])
def test_guard_fallback_matches_jax_field_by_field(prior, sampling):
    """2+1 iterations on full maps (robust tier off, which would lift
    stage 1 to 15 iterations): every field at the tolerance of
    tests/test_torch_pipeline.py."""
    _, _, jres, tres, _ = _flat_both(prior, sampling, max_iter=2,
                                     global_max_iter=1,
                                     robust_tier_on_guard=False)
    for name in jres._fields:
        a, b = getattr(tres, name).numpy(), getattr(jres, name)[:2]
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-4, err_msg=name)


def test_guard_fallback_metrics_match_jax_in_the_robust_tier(prior):
    _, _, jres, tres, _ = _flat_both(prior, "pallas")
    terr = t_errors(tres.estimated, tres.mid, tres.optimized, tres.gt)
    from globalegomocap_tpu.evaluation.metrics import calculate_errors
    for c in range(2):
        jerr = calculate_errors(*(jax.numpy.asarray(x[c]) for x in (
            jres.estimated, jres.mid, jres.optimized, jres.gt)))
        for key in METRIC_KEYS[:17]:
            a, b = float(terr[key][c]), float(jerr[key])
            assert abs(a - b) <= 0.05 * abs(b), (c, key, a, b)


@pytest.fixture(scope="module")
def files(tmp_path_factory, prior):
    """A sequence of two 26-frame chunks, one of a 26- and a 34-frame
    chunk, and the prior as a torch state dict and a flax msgpack."""
    v, sd = prior
    tmp = tmp_path_factory.mktemp("fullmap")
    for j, c in enumerate(chunks(26, (1, 2))):
        save_test_chunk(c, str(tmp / "equal" / "seqA" /
                               f"data_start_{26 * j}_end_{26 * (j + 1)}"))
    for j, c in enumerate(chunks(26, (3,)) + chunks(34, (4,))):
        save_test_chunk(c, str(tmp / "mixed" / "seqM" /
                               f"data_start_{40 * j}_end_{40 * (j + 1)}"))
    save_msgpack(v, str(tmp / "prior.msgpack"))
    torch.save(sd, tmp / "prior.pt")
    return tmp


def _cli_args(files, ckpt, *extra):
    return (["--data_path", str(files / "equal" / "seqA"), "--local_ckpt",
             str(ckpt), "--global_ckpt", str(ckpt)] + PRIOR + list(extra))


def test_optimize_sequence_cli_matches_jax(files, capsys):
    """The parity CLI with --solver lbfgs_fixed on full maps (4 step
    candidates, fused probes off), cut to 8+8 iterations and history 6 to
    keep the JAX compile short; tests/test_torch_chunk.py holds the
    per-chunk path at the full 25+25 and history 25."""
    short = ["--max_iter", "8", "--history_size", "6"]
    tavg = tcli.main(_cli_args(files, files / "prior.pt", "--solver",
                               "lbfgs_fixed", "--sampling", "pallas",
                               "--device", "cpu", *short))
    out = capsys.readouterr().out
    assert out.count("Average ") == 16 and "joints error is:" in out
    assert "total optimization time" in out and "SKIPPED" not in out
    javg = jcli.main(_cli_args(files, files / "prior.msgpack", "--solver",
                               "lbfgs_fixed", "--sampling", "dense", *short))
    for key in METRIC_KEYS[:17]:
        a, b = float(tavg[key]), float(javg[key])
        assert abs(a - b) <= 0.05 * abs(b), (key, a, b)


def test_optimize_sequence_cli_bf16_tier_matches_jax(files, capsys):
    """The parity CLI at --compute_dtype bfloat16 (the per-window solver:
    bf16 evals, float32 encode and output decode), one iteration per
    stage, as tests/test_torch_bf16_tiers.py explains: the 17-metric
    summary within 5 % of the JAX CLI's."""
    args = ["--solver", "lbfgs_fixed", "--compute_dtype", "bfloat16",
            "--max_iter", "1", "--history_size", "6"]
    tavg = tcli.main(_cli_args(files, files / "prior.pt", "--sampling",
                               "pallas", "--device", "cpu", *args))
    assert "SKIPPED" not in capsys.readouterr().out
    javg = jcli.main(_cli_args(files, files / "prior.msgpack", "--sampling",
                               "dense", *args))
    for key in METRIC_KEYS[:17]:
        a, b = float(tavg[key]), float(javg[key])
        assert abs(a - b) <= 0.05 * abs(b), (key, a, b)


def _serve_lines(capsys):
    return {r["sequence"]: r for r in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}


@pytest.mark.parametrize("root,keys", [
    ("equal", {"sequence", "chunks", "windows", "latency_ms",
               "windows_per_sec", "optimized_global_mpjpe",
               "original_global_mpjpe"}),
    ("mixed", {"sequence", "chunks", "latency_ms",
               "optimized_global_mpjpe"})])
def test_serve_full_map_fallback_and_mixed_lengths_match_jax(
        files, capsys, root, keys):
    """--guard_crop 0 with a crop-mass bar no map can meet (1.1): the
    guard trips and the full maps are solved in the robust tier.  The
    mixed-length sequence goes through the per-chunk fallback."""
    trip = ["--guard_crop", "0", "--heatmap_crop_min_mass", "1.1"]
    tserve.main(["--data_root", str(files / root), "--local_ckpt",
                 str(files / "prior.pt"), "--global_ckpt",
                 str(files / "prior.pt"), "--device", "cpu", "--sampling",
                 "pallas"] + trip + PRIOR)
    port = _serve_lines(capsys)
    jck = str(files / "prior.msgpack")
    jserve.main(["--data_root", str(files / root), "--local_ckpt", jck,
                 "--global_ckpt", jck, "--compute_dtype", "float32",
                 "--unroll", "1", "--prefetch_depth", "0", "--sampling",
                 "dense"] + trip + PRIOR)
    ref = _serve_lines(capsys)
    assert set(port) == set(ref) and len(port) == 1
    for name, rec in port.items():
        assert set(rec) == keys == set(ref[name])
        assert rec["chunks"] == ref[name]["chunks"]
        a, b = rec["optimized_global_mpjpe"], ref[name][
            "optimized_global_mpjpe"]
        assert abs(a - b) <= 0.05 * b, (a, b)


def test_sequence_dir_isolates_failing_chunks_and_batches(files, prior,
                                                          capsys):
    """`optimize_sequence_dir` keeps the JAX package's per-chunk fault
    isolation (a chunk that fails to load is skipped and listed in
    timing["failed_chunks"]), and solves a sequence of unequal-length
    chunks chunk by chunk."""
    _, sd = prior
    tc = slice_config(tcfg, max_iter=1, global_max_iter=1)
    opt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                    device="cpu")
    seq = files / "broken" / "seqA"
    shutil.copytree(files / "equal" / "seqA", seq, dirs_exist_ok=True)
    bad = seq / "data_start_52_end_78"
    bad.mkdir(exist_ok=True)
    (bad / "test_data.pkl").write_bytes(b"not a pickle")
    errs, avg, timing = tdriver.optimize_sequence_dir(opt, str(seq),
                                                      verbose=True)
    assert len(errs) == 2 and set(avg) >= {"optimized_global_mpjpe"}
    assert [d for d, _ in timing["failed_chunks"]] == [str(bad)]
    assert "SKIPPED" in capsys.readouterr().out
    errs, _, timing = tdriver.optimize_sequence_dir(
        opt, str(files / "mixed" / "seqM"), verbose=True)
    assert len(errs) == 2 and timing["failed_chunks"] == []
    out = capsys.readouterr().out
    assert out.count("running data:") == 2 and "SKIPPED" not in out


def test_serve_reports_a_chunk_that_fails_to_solve(files, capsys,
                                                   monkeypatch):
    """In serve's per-chunk fallback a chunk whose solve raises (as a
    failed kernel launch does on the card) turns the sequence's line into
    an error record naming the chunk, not a metric over the others."""
    real = tdriver.SequenceOptimizer.optimize_chunk

    def failing(self, chunk, cfg=None):
        if chunk.n_frames == 34:
            raise RuntimeError("kernel launch failed")
        return real(self, chunk, cfg)

    monkeypatch.setattr(tdriver.SequenceOptimizer, "optimize_chunk", failing)
    tserve.main(["--data_root", str(files / "mixed"), "--local_ckpt",
                 str(files / "prior.pt"), "--global_ckpt",
                 str(files / "prior.pt"), "--device", "cpu", "--max_iter",
                 "1", "--global_max_iter", "1"] + PRIOR)
    rec = _serve_lines(capsys)["seqM"]
    assert set(rec) == {"sequence", "error", "failed_chunks"}
    assert "kernel launch failed" in rec["error"]
    assert [d.rsplit("/", 1)[-1] for d in rec["failed_chunks"]] == [
        "data_start_40_end_80"]
