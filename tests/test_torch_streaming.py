"""The port's streaming runtime (`optimize/streaming.py`) case by case
against tests/test_streaming.py, each held against the JAX package's
runtime: results in submission order, bit for bit against direct calls
within the port and field by field against JAX at 2+1 iterations
(rtol 1e-3, atol 2e-4, test_torch_chunk.py's tolerances); the
multi-stream dispatch order; the guard policies; submit_batch on chunk
lists and staged batches; back-pressure; and StagePrefetcher."""

import numpy as np
import pytest
import torch

from globalegomocap_tpu.data.synthetic import synthetic_chunk_v2
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu.optimize import streaming as jstreaming
from globalegomocap_tpu_torch.optimize import driver as tdriver
from globalegomocap_tpu_torch.optimize import streaming as tstreaming
from tests.torch_port_helpers import (
    TINY_PRIOR, chunks, jax_variables, jcfg, port_chunk, port_state,
    slice_config, tcfg)

FIELDS = ("estimated", "mid", "mid_local", "optimized", "gt")
TOL = dict(rtol=1e-3, atol=2e-4)


def per_chunk_config(pkg):
    """The per-window path on full maps at 2+1 iterations."""
    return pkg.OptimizeConfig(
        prior=pkg.PriorConfig(**TINY_PRIOR),
        solver=pkg.SolverConfig(method="lbfgs_fixed", max_iter=2,
                                history_size=3, global_max_iter=1),
        heatmap_crop=0, camera="egosyn")


def _pair(jc, tc, seed=0):
    jm = jdriver.build_model(jc)
    v = jax_variables(jm, seed=seed)
    sd = port_state(v)
    return (jdriver.SequenceOptimizer(jm, v, v, jc),
            tdriver.SequenceOptimizer(tdriver.build_model(tc), sd, sd, tc,
                                      device="cpu"))


@pytest.fixture(scope="module")
def full():
    """Per-chunk solves on full maps, both packages."""
    return _pair(per_chunk_config(jcfg), per_chunk_config(tcfg))


@pytest.fixture(scope="module")
def staged_pair():
    """Serve's flat path on staged k=8 crops at 2+1 iterations."""
    return _pair(slice_config(jcfg, max_iter=2, global_max_iter=1),
                 slice_config(tcfg, max_iter=2, global_max_iter=1))


def _same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _close(port, ref):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(port, f).numpy(),
                                   np.asarray(getattr(ref, f)), **TOL,
                                   err_msg=f)


def test_streaming_matches_direct(full):
    jopt, topt = full
    cs = chunks(26, seeds=(0, 1, 2))
    service = tstreaming.StreamingOptimizer(topt, max_in_flight=2)
    streamed = service.process_all([port_chunk(c) for c in cs])
    assert len(streamed) == 3
    assert [r.estimated.dim() for r in streamed] == [3, 3, 3]
    for c, res in zip(cs, streamed):
        _same(res, topt.optimize_chunk(port_chunk(c)))
    ref = jstreaming.StreamingOptimizer(jopt, max_in_flight=2).process_all(
        cs)
    for res, r in zip(streamed, ref):
        _close(res, r)
    service.submit(port_chunk(cs[0]))           # the pipeline resets
    assert len(service.drain()) == 1


def test_multi_stream_priority_scheduling(full):
    jopt, topt = full
    low = chunks(26, seeds=(0, 1))
    high = chunks(26, seeds=(2, 3))
    orders, results = [], []
    for pkg, opt, conv in ((tstreaming, topt, port_chunk),
                           (jstreaming, jopt, lambda c: c)):
        ms = pkg.MultiStreamOptimizer(opt, max_in_flight=1)
        ms.open_stream("low", priority=0)
        ms.open_stream("high", priority=5)
        for name, c in (("low", low[0]), ("low", low[1]),
                        ("high", high[0]), ("high", high[1])):
            ms.submit(name, conv(c))
        results.append(ms.drain())
        orders.append(ms.dispatch_order)
    assert orders[0] == orders[1] == ["low", "high", "high", "low"]
    out, ref = results
    for stream, cs in (("low", low), ("high", high)):
        assert len(out[stream]) == 2
        for c, res, r in zip(cs, out[stream], ref[stream]):
            _same(res, topt.optimize_chunk(port_chunk(c)))
            _close(res, r)
    with pytest.raises(ValueError):
        ms.open_stream("low")
    ms = tstreaming.MultiStreamOptimizer(topt, max_in_flight=1)
    ms.open_stream("low")
    with pytest.raises(ValueError):
        ms.open_stream("low")
    with pytest.raises(KeyError):
        ms.submit("nope", port_chunk(low[0]))
    ms.submit("low", port_chunk(low[0]))        # streams stay open
    assert len(ms.drain()["low"]) == 1


def test_streaming_guard_policy_resolves_once(staged_pair):
    """'first' resolves the guard once and reuses it, 'every' per chunk,
    'off' never: the same decisions as the JAX runtime's on a clean chunk
    followed by a degraded one (which trips the guard on its own)."""
    jopt, topt = staged_pair
    cs = [chunks(26, seeds=(61,))[0], synthetic_chunk_v2(26, seed=5)]
    decisions = {}
    for pkg, opt, conv in ((tstreaming, topt, port_chunk),
                           (jstreaming, jopt, lambda c: c)):
        calls = []
        orig = opt._effective_cfg
        opt._effective_cfg = lambda h: (calls.append(1), orig(h))[1]
        try:
            for policy in ("first", "every", "off"):
                service = pkg.StreamingOptimizer(opt, guard=policy)
                n0 = len(calls)
                got = [service._chunk_cfg(conv(c)) for c in cs]
                decisions[pkg.__name__, policy] = (
                    len(calls) - n0,
                    [(g.heatmap_crop, g.crop_center, g.solver.max_iter)
                     for g in got])
        finally:
            del opt._effective_cfg
    for policy, n in (("first", 1), ("every", 2), ("off", 0)):
        port = decisions[tstreaming.__name__, policy]
        assert port == decisions[jstreaming.__name__, policy], policy
        assert port[0] == n
    assert decisions[tstreaming.__name__, "every"][1][1][0] == 16
    assert decisions[tstreaming.__name__, "first"][1][1][0] == 8
    with pytest.raises(ValueError, match="guard"):
        tstreaming.StreamingOptimizer(topt, guard="sometimes")
    # the per-chunk path under 'first' and 'every' on stationary maps
    clean = [port_chunk(c) for c in chunks(26, seeds=(61, 62))]
    first = tstreaming.StreamingOptimizer(topt, guard="first").process_all(
        clean)
    every = tstreaming.StreamingOptimizer(topt, guard="every").process_all(
        clean)
    for a, b in zip(first, every):
        _same(a, b)


def test_streaming_submit_batch(staged_pair):
    jopt, topt = staged_pair
    batch_a = chunks(26, seeds=(81, 82))
    batch_b = chunks(26, seeds=(83, 84))
    service = tstreaming.StreamingOptimizer(topt, max_in_flight=2)
    service.submit_batch([port_chunk(c) for c in batch_a])   # staged here
    pre = topt.stage([port_chunk(c) for c in batch_b])
    service.submit_batch(pre)                                 # pre-staged
    out = service.drain()
    assert len(out) == 2
    assert out[0].optimized.shape == out[1].optimized.shape == (
        2, 26, 15, 3)
    assert sum(r.estimated.shape[0] for r in out) == 4
    _same(out[0], topt.optimize_chunks_batched(
        topt.stage([port_chunk(c) for c in batch_a]), mode="flat"))
    _same(out[1], topt.optimize_chunks_batched(pre, mode="flat"))
    jservice = jstreaming.StreamingOptimizer(jopt, max_in_flight=2)
    jservice.submit_batch(batch_a)
    jservice.submit_batch(jopt.stage(batch_b))
    for res, ref in zip(out, jservice.drain()):
        _close(res, ref)


def test_streaming_backpressure_bounds_in_flight(full):
    """A producer faster than the solves is throttled: the deque never
    exceeds max_in_flight, as in the JAX runtime, and every result comes
    back in order.  (Device memory over the submissions is checked on the
    card, tests/test_torch_gpu.py.)"""
    jopt, topt = full
    cs = chunks(26, seeds=tuple(range(200, 205)))
    observed = {}
    for pkg, opt, conv in ((tstreaming, topt, port_chunk),
                           (jstreaming, jopt, lambda c: c)):
        service = pkg.StreamingOptimizer(opt, max_in_flight=2)
        depths = []
        for c in cs:
            service.submit(conv(c))
            depths.append(len(service._in_flight))
        observed[pkg.__name__] = (depths, service.drain())
    depths, out = observed[tstreaming.__name__]
    assert max(depths) <= 2 and depths == observed[jstreaming.__name__][0]
    assert len(out) == len(cs)
    for c, res in zip(cs, out):
        _same(res, topt.optimize_chunk(port_chunk(c)))
    # the completed results hold no input: only merged (N, 15, 3) fields
    assert all(getattr(r, f).shape == (26, 15, 3) for r in out
               for f in FIELDS)


def test_stage_prefetcher_matches_inline_staging(staged_pair):
    """Source order, results identical to inline staging, the guard
    resolved once ('first'), pre-staged batches passed through as the
    same object, and a worker exception re-raised on the consumer; the
    results against the JAX runtime's prefetched ones."""
    jopt, topt = staged_pair
    batches = [chunks(26, seeds=(10 * b, 10 * b + 1)) for b in range(3)]
    port = [[port_chunk(c) for c in b] for b in batches]
    service = tstreaming.StreamingOptimizer(topt, max_in_flight=2)
    seen = []
    for staged in tstreaming.StagePrefetcher(topt, port, depth=2):
        seen.append(staged)
        service.submit_batch(staged)
    out = service.drain()
    assert len(out) == 3
    cov = topt.stage(port[0]).crop_coverage
    assert [s.crop_coverage for s in seen] == [cov] * 3   # resolved once
    for batch, staged, res in zip(port, seen, out):
        ref = topt.stage(batch, coverage=cov)
        assert all(torch.equal(a, b) for a, b in
                   zip(staged.tensors(), ref.tensors()))
        _same(res, topt.optimize_chunks_batched(ref, mode="flat"))
    jservice = jstreaming.StreamingOptimizer(jopt, max_in_flight=2)
    for staged in jstreaming.StagePrefetcher(jopt, batches, depth=2):
        jservice.submit_batch(staged)
    for res, ref in zip(out, jservice.drain()):
        _close(res, ref)

    pre = topt.stage(port[0])
    got = list(tstreaming.StagePrefetcher(topt, [pre], depth=1))
    assert got[0] is pre

    def bad_source():
        yield port[0]
        raise RuntimeError("producer failed")

    it = iter(tstreaming.StagePrefetcher(topt, bad_source(), depth=1))
    next(it)
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)
    with pytest.raises(ValueError, match="depth"):
        tstreaming.StagePrefetcher(topt, [], depth=0)
