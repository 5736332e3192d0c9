"""The port's serve at the JAX serve's defaults (prefetch depth 2,
in-flight depth 3, guard policy 'first'), with --device cpu: its records
against the JAX serve's at its defaults (metrics within 5 %, as
tests/test_torch_serve.py holds them); the guard policy on a degraded
second sequence at --prefetch_depth 0 and 2; the watch-mode cases of
tests/test_serve_cli.py on the port; and the --max_batches count, which
a load-error record does not advance."""

import json

import numpy as np
import pytest
import torch

from globalegomocap_tpu.cli import serve as jserve
from globalegomocap_tpu.data.test_data import save_test_chunk
from globalegomocap_tpu.models.checkpoint import save_msgpack
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.cli import serve as tserve
from globalegomocap_tpu_torch.optimize import driver as tdriver
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_chunk, port_state, slice_config,
    tcfg)

PRIOR = ["--latent_dim", "32", "--hidden_dims", "8,8,16,16,32"]
METRICS = ("optimized_global_mpjpe", "original_global_mpjpe")


def _noise_chunks(n, seed):
    """Synthetic chunks whose maps are flat uniform noise: k=8 peak crops
    keep about 64 / 4096 of their mass."""
    rng = np.random.default_rng(seed)
    return [c._replace(heatmaps=rng.random(c.heatmaps.shape,
                                           dtype=np.float32))
            for c in chunks(26, tuple(range(seed, seed + n)))]


def _write(root, name, cs):
    for j, c in enumerate(cs):
        save_test_chunk(c, str(root / name / f"data_start_{26 * j}_end_"
                                              f"{26 * (j + 1)}"))


@pytest.fixture(scope="module")
def priors(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_stream")
    v = jax_variables(jdriver.build_model(slice_config(jcfg)), seed=0)
    save_msgpack(v, str(tmp / "prior.msgpack"))
    torch.save(port_state(v), tmp / "prior.pt")
    return tmp, str(tmp / "prior.pt"), str(tmp / "prior.msgpack")


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def _port(root, ck, *extra):
    return tserve.main(["--data_root", str(root), "--local_ckpt", ck,
                        "--global_ckpt", ck, "--device", "cpu", *extra]
                       + PRIOR)


def _jax(root, jck, *extra):
    return jserve.main(["--data_root", str(root), "--local_ckpt", jck,
                        "--global_ckpt", jck, "--unroll", "1", *extra]
                       + PRIOR)


def _hold(port, ref):
    assert set(port) == set(ref)
    for name, rec in port.items():
        assert set(rec) == set(ref[name])
        assert (rec["chunks"], rec["windows"]) == (ref[name]["chunks"],
                                                   ref[name]["windows"])
        for key in METRICS:
            assert abs(rec[key] - ref[name][key]) <= 0.05 * ref[name][key]


def test_serve_defaults_match_jax_serve_defaults(priors, capsys):
    tmp, ck, jck = priors
    root = tmp / "clean"
    _write(root, "seqA", chunks(26, (1, 2)))
    _write(root, "seqB", chunks(26, (3, 4)))
    p = tserve.build_parser()
    assert (p.get_default("prefetch_depth"), p.get_default("max_in_flight"),
            p.get_default("stage_on_host")) == (2, 3, True)
    assert _port(root, ck) == 2
    port = {r["sequence"]: r for r in _lines(capsys)}
    assert _jax(root, jck) == 2
    _hold(port, {r["sequence"]: r for r in _lines(capsys)})


def _record_decisions(monkeypatch, cls, log):
    """Log (coverage, staged heat width) of every batched solve."""
    orig = cls.optimize_chunks_batched

    def solve(self, staged, mode="flat"):
        log.append((staged.crop_coverage, staged.heat.shape[-1]))
        return orig(self, staged, mode=mode)
    monkeypatch.setattr(cls, "optimize_chunks_batched", solve)


@pytest.mark.parametrize("depth", ["0", "2"])
def test_guard_policy_first_reuses_the_first_decision(priors, capsys,
                                                      monkeypatch, depth):
    """seqA's clean maps keep the k=8 fast path; seqB's noise maps trip
    the guard on their own (coverage well under 0.9) but, as in the JAX
    serve, take seqA's decision: the stream's first coverage is reused
    (for the service's lifetime at depth 0, for the scan pass at depth
    2)."""
    tmp, ck, jck = priors
    root = tmp / "guard"
    if not root.exists():
        _write(root, "seqA", chunks(26, (1, 2)))
        _write(root, "seqB", _noise_chunks(2, 40))
    cfg = slice_config(tcfg)
    sd = torch.load(ck, weights_only=True)
    topt = tdriver.SequenceOptimizer(tdriver.build_model(cfg), sd, sd, cfg,
                                     device="cpu")
    own = topt.stage([port_chunk(c) for c in _noise_chunks(2, 40)],
                     on_host=True).crop_coverage
    assert own < 0.5
    logs = {"port": [], "jax": []}
    _record_decisions(monkeypatch, tdriver.SequenceOptimizer, logs["port"])
    _record_decisions(monkeypatch, jdriver.SequenceOptimizer, logs["jax"])
    flags = ("--compute_dtype", "float32", "--prefetch_depth", depth)
    _port(root, ck, *flags)
    port = {r["sequence"]: r for r in _lines(capsys)}
    _jax(root, jck, *flags)
    _hold(port, {r["sequence"]: r for r in _lines(capsys)})
    for who, log in logs.items():
        assert len(log) == 2, who
        (cov_a, width_a), (cov_b, width_b) = log
        assert cov_a >= 0.9 and width_a == 8 * 8 * 15, who
        assert (cov_b, width_b) == (cov_a, width_a), who
    np.testing.assert_allclose(logs["port"][0][0], logs["jax"][0][0],
                               rtol=1e-6)


class _StopWatch(Exception):
    pass


def _watch_main(root, ck, monkeypatch, *extra):
    """The port's serve in watch mode with time.sleep patched to record
    the call and raise, so the loop ends (tests/test_serve_cli.py)."""
    sleeps = []

    def fake_sleep(t):
        sleeps.append(t)
        raise _StopWatch
    monkeypatch.setattr(tserve.time, "sleep", fake_sleep)
    with pytest.raises(_StopWatch):
        _port(root, ck, "--watch_interval", "0.5", *extra)
    return sleeps


def test_watch_emits_in_flight_before_idle(priors, capsys, monkeypatch):
    """Pass 1 submits seqA (progress, no sleep); pass 2 is idle and must
    emit the in-flight result before it sleeps."""
    tmp, ck, _ = priors
    root = tmp / "watch_one"
    _write(root, "seqA", chunks(26, (3,)))
    assert len(_watch_main(root, ck, monkeypatch)) == 1
    assert any(r.get("sequence") == "seqA" and "windows_per_sec" in r
               for r in _lines(capsys))


def test_watch_sleeps_on_empty_dirs(priors, capsys, monkeypatch):
    tmp, ck, _ = priors
    root = tmp / "watch_empty"
    (root / "not_yet_uploaded").mkdir(parents=True)
    assert _watch_main(root, ck, monkeypatch) == [0.5]
    assert capsys.readouterr().out.strip() == ""


def _corrupt(root, name):
    d = root / name / "data_start_0_end_26"
    d.mkdir(parents=True)
    (d / "test_data.pkl").write_bytes(b"not a pickle")


def test_watch_retries_failed_loads(priors, capsys, monkeypatch):
    """A chunk that fails to load (still being written) is retried on
    later scans, with no error record under the retry cap."""
    tmp, ck, _ = priors
    root = tmp / "watch_uploading"
    _corrupt(root, "uploading")
    assert _watch_main(root, ck, monkeypatch) == [0.5]
    assert capsys.readouterr().out.strip() == ""


def test_one_shot_emits_load_error(priors, capsys):
    tmp, ck, _ = priors
    root = tmp / "corrupt_only"
    _corrupt(root, "corrupt")
    assert _port(root, ck) == 0          # an error record is not emitted
    rec = _lines(capsys)[-1]
    assert rec["sequence"] == "corrupt" and "error" in rec


def test_max_batches_skips_load_errors(priors, capsys):
    """--max_batches 1 with an unreadable first sequence: the error record
    does not count, so the next sequence is solved, as in the JAX
    serve."""
    tmp, ck, jck = priors
    root = tmp / "max_batches"
    _corrupt(root, "a_corrupt")
    _write(root, "b_good", chunks(26, (5,)))
    outs = []
    for run in (_port, _jax):
        assert run(root, ck if run is _port else jck, "--compute_dtype",
                   "float32", "--max_batches", "1") == 1
        outs.append(_lines(capsys))
    for recs in outs:
        assert [r["sequence"] for r in recs] == ["a_corrupt", "b_good"]
        assert "error" in recs[0] and "windows" in recs[1]
    _hold({"b_good": outs[0][1]}, {"b_good": outs[1][1]})


def test_watch_max_batches_skips_load_errors(priors, capsys, monkeypatch):
    """The same in watch mode once the retries are used up: the loop ends
    after the good sequence without sleeping."""
    tmp, ck, _ = priors
    root = tmp / "max_batches_watch"
    _corrupt(root, "a_corrupt")
    _write(root, "b_good", chunks(26, (5,)))
    monkeypatch.setattr(tserve.time, "sleep", lambda t: pytest.fail(
        "slept before --max_batches was reached"))
    assert _port(root, ck, "--watch_interval", "0.5", "--max_batches", "1",
                 "--max_load_retries", "1") == 1
    recs = _lines(capsys)
    assert [r["sequence"] for r in recs] == ["a_corrupt", "b_good"]
    assert "error" in recs[0] and "windows" in recs[1]
