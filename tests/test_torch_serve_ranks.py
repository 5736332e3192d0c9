"""serve and evaluate_all over two ranks (`cli/optimize_sequence.py::
run_on_ranks`), against the same CLIs on one rank and against the JAX
package's serve and evaluate_all on the same roots (JAX shards them over
its virtual devices, as its CLIs do), and the staging collectives of the
prefetch worker (`parallel/mesh.py`'s staging group).

The ranks are two gloo processes on the CPU, spawned once for the
module (`parallel.mesh.spawn`); in them the CLIs find the default group
and take it, as under `torchrun`.  They run
`tests/torch_parallel_workers.py`, which imports no JAX.  The traffic:
four equal-length sequences of 1 to 3 chunks (3 chunks pad to 4 over
two ranks), one of unequal chunk lengths (the per-chunk fallback, which
every rank solves with no collective) and one with a chunk that does
not load (serve records the error; evaluate_all solves its other
chunk), at serve's streaming defaults (prefetch depth 2, 3 in flight)
and float32 with 2 + 1 iterations: the bf16 default tier branches on
rounding between batch sizes (ROADMAP.md, section C).

Tolerances: the records equal one rank's with the timings left out
(their metrics are rounded to 5 decimals); evaluate_all's averages
within 1e-5 relative (1e-6 absolute), the precedent of
test_torch_parallel.py for solves in smaller batches.  Against JAX:
the records in JAX's order with JAX's keys and counts and the metrics
within 5 % (test_torch_serve.py), evaluate_all's per-sequence and
overall averages within 5 % (test_torch_evaluate_all.py)."""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from globalegomocap_tpu import config as jconfig_module
from globalegomocap_tpu.cli import evaluate_all as jeval
from globalegomocap_tpu.cli import serve as jserve
from globalegomocap_tpu.data.test_data import save_test_chunk
from globalegomocap_tpu.evaluation.metrics import METRIC_KEYS
from globalegomocap_tpu.models.checkpoint import save_msgpack
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.cli import evaluate_all as teval
from globalegomocap_tpu_torch.cli import serve as tserve
from globalegomocap_tpu_torch.parallel import mesh as pm
from tests import torch_parallel_workers as workers
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_chunk, port_state, slice_config, tcfg)

PRIOR = ["--latent_dim", "32", "--hidden_dims", "8,8,16,16,32"]
SOLVE = ["--compute_dtype", "float32", "--max_iter", "2",
         "--global_max_iter", "1"]
TIMINGS = ("latency_ms", "windows_per_sec")
METRICS = ("optimized_global_mpjpe", "original_global_mpjpe")


def _write(root, name, cs):
    at = 0
    for c in cs:
        save_test_chunk(c, os.path.join(root, name,
                                        f"data_start_{at}_end_"
                                        f"{at + c.n_frames}"))
        at += c.n_frames


def _corrupt(root, name):
    """A chunk directory `name`/data_start_26_end_52 whose pickle does
    not load."""
    d = os.path.join(root, name, "data_start_26_end_52")
    os.makedirs(d)
    with open(os.path.join(d, "test_data.pkl"), "wb") as f:
        f.write(b"not a pickle")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Priors (the port's file; JAX's beside it as prior.msgpack), the
    one-shot root, three copies of the watch root (for the ranks, the
    one-rank run and the JAX run) and the sequence that arrives
    mid-run."""
    tmp = str(tmp_path_factory.mktemp("serve_ranks"))
    v = jax_variables(jdriver.build_model(slice_config(jcfg)), seed=0)
    ck = os.path.join(tmp, "prior.pt")
    torch.save(port_state(v), ck)
    save_msgpack(v, os.path.join(tmp, "prior.msgpack"))
    root = os.path.join(tmp, "root")
    for name, seeds in (("a", (1, 2, 3)), ("b", (4, 5)), ("c", (6,)),
                        ("d", (7, 8, 9))):
        _write(root, name, chunks(26, seeds))
    _write(root, "e", chunks(26, (10,)) + chunks(34, (11,)))
    _write(root, "x", chunks(26, (14,)))
    _corrupt(root, "x")
    watch = os.path.join(tmp, "watch")
    _write(watch, "a", chunks(26, (1, 2, 3)))
    _write(watch, "b", chunks(26, (4, 5)))
    _corrupt(watch, "x")
    shutil.copytree(watch, watch + "_one")
    shutil.copytree(watch, watch + "_jax")
    _write(tmp, "arrival", chunks(26, (12, 13)))
    return tmp, ck, root, watch


def _argv(ck, root, *extra):
    return (["--data_root", root, "--local_ckpt", ck, "--global_ckpt", ck,
             "--device", "cpu"] + SOLVE + PRIOR + list(extra))


def _watch_argv(ck, root):
    return _argv(ck, root, "--watch_interval", "0.01", "--max_batches",
                 "3", "--max_load_retries", "2")


def _eval_argv(ck, root):
    return _argv(ck, root, "--solver", "lbfgs_fixed")


def _prefetch_args():
    cfg = slice_config(tcfg, max_iter=2, global_max_iter=1,
                       robust_tier_on_guard=False)
    v = jax_variables(jdriver.build_model(slice_config(jcfg)), seed=0)
    batches = [[port_chunk(c) for c in chunks(26, (s, s + 1, s + 2))]
               for s in range(1, 19, 3)]
    return cfg, port_state(v), batches, 0.3


@pytest.fixture(scope="module")
def ranks(case):
    """The two ranks' results, then the same calls on one rank here."""
    tmp, ck, root, watch = case
    arrival = os.path.join(tmp, "arrival")
    out = pm.spawn(workers.several, 2, ["cpu"] * 2, timeout_s=240,
                   threads=1, args=([
        ("prefetch_under_gathers", _prefetch_args()),
        ("cli_ranks", (_argv(ck, root), _eval_argv(ck, root),
                       (_watch_argv(ck, watch), watch, "new", arrival)))],))
    real = tserve.time.sleep
    tserve.time.sleep = workers.arrive_on_sleep(watch + "_one", "new",
                                                arrival, True)
    try:
        one = {"prefetch": workers.prefetch_under_gathers(
                   pm.make_mesh(device="cpu"), *_prefetch_args()),
               "serve": workers._captured(tserve.main, _argv(ck, root)),
               "eval": workers._captured(teval.main, _eval_argv(ck, root)),
               "watch": workers._captured(
                   tserve.main, _watch_argv(ck, watch + "_one"))}
    finally:
        tserve.time.sleep = real
    return out, one


@pytest.fixture(scope="module")
def jax_runs(case):
    """The JAX package's serve (one-shot and watch, the same sequence
    arriving at its first idle pass) and evaluate_all on the same roots
    and priors, at the ranks' solver settings: its values and what each
    printed.  JAX's evaluate_all builds its SolverConfig from --solver
    alone, so the budget of 2 + 1 iterations is given to it there."""
    tmp, _, root, watch = case
    jck = os.path.join(tmp, "prior.msgpack")

    def argv(data_root, *extra):
        return (["--data_root", data_root, "--local_ckpt", jck,
                 "--global_ckpt", jck] + PRIOR + list(extra))
    solve = SOLVE + ["--unroll", "1"]
    real = jserve.time.sleep
    jserve.time.sleep = workers.arrive_on_sleep(
        watch + "_jax", "new", os.path.join(tmp, "arrival"), True)
    try:
        out = {"serve": workers._captured(jserve.main, argv(root, *solve)),
               "watch": workers._captured(jserve.main, argv(
                   watch + "_jax", *solve, "--watch_interval", "0.01",
                   "--max_batches", "3", "--max_load_retries", "2"))}
    finally:
        jserve.time.sleep = real
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig_module, "SolverConfig", functools.partial(
            jconfig_module.SolverConfig, max_iter=2, global_max_iter=1))
        out["eval"] = workers._captured(
            jeval.main, argv(root, "--solver", "lbfgs_fixed"))
    return out


def _records(text):
    return [{k: v for k, v in json.loads(line).items() if k not in TIMINGS}
            for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("run", ["serve", "watch"])
def test_serve_over_two_ranks_matches_one_rank(ranks, run):
    """Rank 0 prints one rank's records in its order (the per-chunk
    fallback, the load error, the four batches; in watch mode the
    retried load's error, the first pass's batches, emitted at the idle
    pass, and the sequence that arrived after it), rank 1 prints nothing,
    and both return one rank's count."""
    out, one = ranks
    want_n, want_text = one[run]
    (n0, text0), (n1, text1) = (rank[1][run] for rank in out)
    assert n0 == n1 == want_n == (5 if run == "serve" else 3)
    assert text1 == ""
    assert _records(text0) == _records(want_text)
    names = [r["sequence"] for r in _records(text0)]
    if run == "serve":
        assert names == ["e", "x", "a", "b", "c", "d"]
    else:
        assert names == ["x", "a", "b", "new"]
        assert "error" in _records(text0)[0]


@pytest.mark.parametrize("run", ["serve", "watch"])
def test_serve_over_two_ranks_matches_jax_serve(ranks, jax_runs, run):
    """Rank 0's records are JAX's serve's on the same root: the same
    sequences in the same order (the per-chunk fallback, the load error,
    the batches; in watch mode the arrival last), each with JAX's keys,
    chunk and window counts and error, its metrics within 5 %; both
    return JAX's count."""
    out, _ = ranks
    want_n, want_text = jax_runs[run]
    (n0, text0), (n1, _) = (rank[1][run] for rank in out)
    assert n0 == n1 == want_n
    got, want = _records(text0), _records(want_text)
    assert [r["sequence"] for r in got] == [r["sequence"] for r in want]
    for rec, ref in zip(got, want):
        assert set(rec) == set(ref), rec["sequence"]
        for key in set(ref) - set(METRICS):
            assert rec[key] == ref[key], (rec["sequence"], key)
        for key in set(ref) & set(METRICS):
            assert abs(rec[key] - ref[key]) <= 0.05 * ref[key], (
                rec["sequence"], key, rec[key], ref[key])


def test_evaluate_all_over_two_ranks_matches_jax(ranks, jax_runs):
    """Both ranks return JAX's evaluate_all's sequences, each
    sequence's 17 averages and their means over the sequences within
    5 % of JAX's; rank 0 prints JAX's skipped chunk."""
    out, _ = ranks
    want, want_text = jax_runs["eval"]
    assert "SKIPPED corrupt chunk" in want_text
    assert "SKIPPED corrupt chunk" in out[0][1]["eval"][1]
    for got in (rank[1]["eval"][0] for rank in out):
        assert list(got) == list(want)
        for key in METRIC_KEYS[:17]:
            for seq in want:
                a, b = float(got[seq][key]), float(want[seq][key])
                assert abs(a - b) <= 0.05 * abs(b), (seq, key, a, b)
            a = np.mean([float(v[key]) for v in got.values()])
            b = np.mean([float(v[key]) for v in want.values()])
            assert abs(a - b) <= 0.05 * abs(b), ("overall", key, a, b)


def test_evaluate_all_over_two_ranks_matches_one_rank(ranks):
    """Rank 0 prints the sweep's lines (one rank's labels; the wall clock
    left out) and the skipped chunk, rank 1 nothing, and both return one
    rank's averages, the unequal-length sequence's from the per-chunk
    loop."""
    out, one = ranks
    want, want_text = one["eval"]
    (got0, text0), (got1, text1) = (rank[1]["eval"] for rank in out)
    assert text1 == ""

    def labels(t):
        return [x.split(":")[0] for x in t.splitlines()
                if not x.startswith("total wall")]
    assert labels(text0) == labels(want_text)
    assert "SKIPPED corrupt chunk" in text0
    assert list(got0) == list(got1) == list(want) == \
        ["a", "b", "c", "d", "e", "x"]
    for seq in want:
        for k, v in want[seq].items():
            for got in (got0, got1):
                np.testing.assert_allclose(got[seq][k], v, rtol=1e-5,
                                           atol=1e-6, err_msg=f"{seq} {k}")


def test_staging_collectives_keep_their_order_under_a_prefetcher(ranks):
    """Six batches staged by a prefetch worker whose every staging
    all-reduces, while the main thread gathers each solve, with the
    worker's all_reduce before the main thread's all_gather on rank 0
    and after it on rank 1: both ranks return one rank's fields.  Were
    both threads on one group, the ranks would pair one thread's
    collective with the other's and hang until the spawn's deadline."""
    out, one = ranks
    for rank in out:
        got = rank[0]
        assert len(got) == len(one["prefetch"]) == 6
        for g, w in zip(got, one["prefetch"]):
            for name, v in w.items():
                np.testing.assert_allclose(g[name], v, rtol=1e-5, atol=1e-6,
                                           err_msg=name)


def test_broadcast_object_and_the_staging_group_on_one_rank():
    """On a mesh of one rank broadcast_object returns its value as it is
    and the staging mesh is the mesh; a mesh of several ranks stages on
    its own group, a gloo group under NCCL too."""
    m = pm.make_mesh(device="cpu")
    obj = {"a": [1, 2]}
    assert pm.broadcast_object(m, obj) is obj
    assert m.stage_group is None and m.staging() is m
    two = pm.Mesh("world", "nccl", 1, 2, torch.device("cpu"), "stage")
    assert (two.staging().group, two.staging().backend,
            two.staging().rank) == ("stage", "gloo", 1)


@pytest.mark.parametrize("cards", [1, 2])
def test_the_ranks_follow_the_visible_cards(cards, monkeypatch):
    """With no group, --device cuda runs one rank a visible card: one
    card is one rank in this process (no spawn, no group), two cards two
    NCCL ranks spawned over cuda:0 and cuda:1, rank 0's value returned;
    the CPU is one rank."""
    from globalegomocap_tpu_torch.cli.optimize_sequence import run_on_ranks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    spawned = []

    def fake_spawn(fn, world, devices, args=()):
        spawned.append((fn, world, devices))
        return [("rank", r) for r in range(world)]
    monkeypatch.setattr(pm, "spawn", fake_spawn)

    def fn(mesh, args):
        return mesh
    args = tserve.build_parser().parse_args(
        ["--data_root", "r", "--local_ckpt", "c", "--global_ckpt", "c"])
    assert args.device == "cuda"
    got = run_on_ranks(fn, args)
    if cards == 1:
        assert spawned == []
        assert (got.size, got.group, got.device.type) == (1, None, "cuda")
    else:
        assert spawned == [(fn, 2, ["cuda:0", "cuda:1"])]
        assert got == ("rank", 0)
    args.device = "cpu"
    assert run_on_ranks(fn, args).size == 1 and len(spawned) == cards - 1
    args.device = "cuda:1"
    got = run_on_ranks(fn, args)
    assert (got.size, str(got.device)) == (1, "cuda:1")
    assert len(spawned) == cards - 1


class _Stop(Exception):
    pass


def test_a_rank_under_torchrun_takes_its_local_card(monkeypatch):
    """Under an NCCL group (as torchrun starts one) with --device cuda,
    optimize_sequence's main and run_on_ranks take this rank of the
    group on cuda:LOCAL_RANK, not every rank on cuda:0."""
    from globalegomocap_tpu_torch.cli import optimize_sequence as tos
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pm.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pm.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(pm.dist, "get_rank", lambda: 1)
    monkeypatch.setattr(pm.dist, "get_backend", lambda: "nccl")
    monkeypatch.setattr(pm, "_stage_group", lambda: "stage")
    monkeypatch.setenv("LOCAL_RANK", "1")
    meshes = []

    def load_optimizer(args, cfg, mesh=None):
        meshes.append(mesh)
        raise _Stop
    monkeypatch.setattr(tos, "load_optimizer", load_optimizer)
    with pytest.raises(_Stop):
        tos.main(["--data_path", "d", "--local_ckpt", "c",
                  "--global_ckpt", "c"])
    args = tserve.build_parser().parse_args(
        ["--data_root", "r", "--local_ckpt", "c", "--global_ckpt", "c"])
    meshes.append(tos.run_on_ranks(lambda mesh, _: mesh, args))
    for m in meshes:
        assert (m.rank, m.size, str(m.device), m.backend) == (
            1, 2, "cuda:1", "nccl")
        assert m.staging().backend == "gloo"
