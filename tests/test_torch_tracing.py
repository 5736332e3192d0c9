"""The port's recorder (`utils/profiling.py`): nesting, request ids,
counters, the bounded buffer, two threads at once, thread CPU time
against wall time; its spans in a torch.profiler trace, where the
benchmark's trace reader names an idle gap by the innermost one; the
spans and counters of the streaming runtime and of a train step at a
tiny size on the CPU; and the benchmark's readers of them
(`egobench/harness/program_spans.py`, `egobench/metrics/`) on planted
records."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from egobench.harness import common, program_spans
from egobench.harness import trace as bench_trace
from globalegomocap_tpu_torch import config as tcfg
from globalegomocap_tpu_torch.data.amass import AmassWindows
from globalegomocap_tpu_torch.data.synthetic import synthetic_chunk
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
from globalegomocap_tpu_torch.optimize import driver as tdriver
from globalegomocap_tpu_torch.optimize import streaming as tstreaming
from globalegomocap_tpu_torch.train.train_vae import Trainer
from globalegomocap_tpu_torch.utils.profiling import (
    RECORDER, Record, SpanTimer)
from tests.torch_port_helpers import TINY_PRIOR, slice_config


def by_kind(records, kind="span"):
    return [r for r in records if r.kind == kind]


# ---------------------------------------------------------------- recorder

def test_spans_nest_and_inherit_the_request():
    t = SpanTimer()
    with t.span("outer", request=7) as outer:
        with t.span("inner"):
            t.count("work", 3)
        with t.span("other", request=9):
            t.count("work", 4)
    with t.span("alone"):
        pass
    spans = {r.name: r for r in by_kind(t.records())}
    assert spans["outer"].parent == 0 and spans["outer"].request == 7
    assert spans["inner"].parent == spans["outer"].id == outer._id
    assert spans["inner"].request == 7
    assert spans["other"].parent == spans["outer"].id
    assert spans["other"].request == 9
    assert spans["alone"].parent == 0 and spans["alone"].request is None
    counts = by_kind(t.records(), "counter")
    assert [(c.value, c.request, c.parent) for c in counts] == [
        (3, 7, spans["inner"].id), (4, 9, spans["other"].id)]
    # a span closes after its children, and covers them
    assert spans["outer"].start <= spans["inner"].start
    assert spans["inner"].end <= spans["outer"].end


def test_counters_and_device_spans():
    t = SpanTimer()
    t.count("bytes", 10)
    t.count("bytes", 5, request=3)
    t.device_span("card", 0.25, request=3)
    recs = t.records()
    assert [(r.kind, r.name, r.value, r.request) for r in recs] == [
        ("counter", "bytes", 10, None), ("counter", "bytes", 5, 3),
        ("device", "card", 0.25, 3)]
    assert all(isinstance(r, Record) and r.start == r.end for r in recs)
    assert t.summary() == {}          # counters are no spans


def test_buffer_keeps_the_newest_and_counts_what_it_dropped():
    t = SpanTimer(capacity=4)
    for i in range(10):
        with t.span("s", request=i):
            pass
    assert [r.request for r in t.records()] == [6, 7, 8, 9]
    assert t.dropped == 6
    assert t.summary()["s"]["count"] == 4


def test_two_threads_record_at_once():
    t = SpanTimer(capacity=3000)
    n = 1500
    start = threading.Barrier(2)

    def work(rid):
        start.wait(timeout=30)
        for _ in range(n):
            with t.span("outer", request=rid):
                with t.span("inner"):
                    t.count("c", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(rid,))
                   for rid in (1, 2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    recs = t.records()
    assert len(recs) + t.dropped == 2 * 3 * n
    outers = {r.id: r for r in recs if r.name == "outer"}
    for r in recs:
        if r.name == "inner" and r.parent in outers:
            # nested on its own thread: its parent carries its request
            assert outers[r.parent].request == r.request
        if r.name != "outer":
            assert r.request in (1, 2) and r.parent != 0
    assert len({r.id for r in recs}) == len(recs)


def test_thread_cpu_time_is_within_wall_time():
    t = SpanTimer()
    with t.span("sleep", cpu=True):
        time.sleep(0.05)
    with t.span("busy", cpu=True):
        sum(i * i for i in range(20000))
    with t.span("empty", cpu=True):
        with t.span("inside"):
            pass
    spans = {r.name: r for r in t.records()}
    assert spans.pop("inside").cpu is None       # not asked for
    for r in spans.values():
        assert 0.0 <= r.cpu <= r.value
    assert spans["sleep"].value >= 0.05 and spans["sleep"].cpu < 0.025


# ---------------------------------------------------------- shared clock

def test_spans_label_the_trace_and_enter_no_profiler_without_one(
        monkeypatch, tmp_path):
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    t = SpanTimer()
    with t.span("dispatch"):
        with t.span("solve.stage1"):
            pass
    assert entered == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with real(bench_trace.Tracer.START):
            pass
        with t.span("dispatch"):
            torch.ones(4).sum()
            with t.span("solve.stage1"):
                time.sleep(0.05)               # the planted gap
            torch.ones(4).sum()
        with real(bench_trace.Tracer.END):
            pass
    assert entered == ["dispatch", "solve.stage1"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    inner = next(e for e in events if e.get("name") == "solve.stage1"
                 and e.get("cat") == "user_annotation")
    # the device around the gap, and the dispatching thread's launches
    a, b = float(inner["ts"]), float(inner["ts"]) + float(inner["dur"])
    events += [
        {"ph": "X", "cat": "kernel", "name": "k0", "ts": a - 5.0,
         "dur": 6.0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": b - 1.0,
         "dur": 6.0, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": a, "dur": 1.0, "tid": inner["tid"]}]
    gaps = bench_trace.read(events)["idle_gaps"]
    assert gaps[0][0] == "solve.stage1: between host ops"
    assert gaps[0][1] >= 0.04


# ------------------------------------------------------------- runtime

def tiny_optimizer():
    cfg = slice_config(tcfg, max_iter=2, global_max_iter=1)
    model = tdriver.build_model(cfg)
    state = model.state_dict()
    return cfg, tdriver.SequenceOptimizer(model, state, state, cfg,
                                          device="cpu")


def test_runtime_records_each_request_under_its_id():
    cfg, opt = tiny_optimizer()
    requests = [[synthetic_chunk(26, seed=s) for s in pair]
                for pair in ((1, 2), (3, 4))]
    t0 = time.perf_counter()
    service = tstreaming.StreamingOptimizer(opt, max_in_flight=1)
    staged = []
    for batch in tstreaming.StagePrefetcher(opt, requests, depth=1):
        staged.append(batch)
        service.submit_batch(batch, mode="flat")
    out = service.drain()
    assert [r.optimized.shape[0] for r in out] == [2, 2]
    recs = [r for r in RECORDER.records() if r.start >= t0]
    ids = [b.request for b in staged]
    assert len(set(ids)) == 2 and None not in ids
    for rid in ids:
        mine = [r for r in recs if r.request == rid]
        names = sorted(r.name for r in mine if r.kind == "span")
        assert names == sorted(
            ["stage", "stage.copy", "stage.copy", "prefetch.wait",
             "runtime.slot_wait", "dispatch", "solve.stage1", "solve.lift",
             "solve.stage2", "solve.lift", "solve.merge"]), names
        dispatch = next(r for r in mine if r.name == "dispatch")
        for name in ("solve.stage1", "solve.lift", "solve.stage2",
                     "solve.merge"):
            assert all(r.parent == dispatch.id for r in mine
                       if r.name == name)
        # the evaluations: (1 + max_iter K) + (1 + global_max_iter K) a
        # window, K candidates probed at once
        k = len(cfg.solver.step_candidates)
        windows = 2 * ((26 - cfg.window.seq_len) // cfg.window.stride + 1)
        evals = sum(r.value for r in mine if r.name == "solve.evals")
        assert evals == windows * ((1 + cfg.solver.max_iter * k)
                                   + (1 + cfg.solver.global_max_iter * k))
        copied = [r for r in mine if r.name == "stage.h2d_bytes"]
        assert copied and all(r.value == 0 for r in copied)   # the CPU
    assert not [r for r in recs if r.name == "runtime.device"]


# ---------------------------------------------------------------- train

def test_train_step_records_its_phases_in_order():
    cfg = tcfg.TrainConfig(latent_dim=32, seq_length=10, batch_size=8,
                           epochs=1, log_step=0)
    model = ConvVAE(latent_dim=32, seq_len=10,
                    hidden_dims=TINY_PRIOR["hidden_dims"])
    windows = AmassWindows(np.random.default_rng(0).standard_normal(
        (32, 10, 45)).astype(np.float32))
    trainer = Trainer(cfg, windows, windows, model=model, device="cpu",
                      variables=model.state_dict())
    t0 = time.perf_counter()
    batch = next(windows.epoch_batches(np.random.default_rng(1), 8))
    trainer._run([trainer._device_batch(batch)],
                 {"loss": torch.zeros(())})
    spans = [r for r in by_kind(RECORDER.records()) if r.start >= t0]
    assert [r.name for r in spans] == [
        "data.batch", "train.batch", "train.forward", "train.backward",
        "train.optimizer", "train.step"]          # in the order they close
    named = {r.name: r for r in spans}
    step = named["train.step"]
    assert step.request == 0 and named["train.batch"].request == 0
    phases = [named[n] for n in ("train.forward", "train.backward",
                                 "train.optimizer")]
    assert all(p.parent == step.id and p.request == 0 for p in phases)
    assert [p.start for p in phases] == sorted(p.start for p in phases)
    assert step.start <= phases[0].start and phases[-1].end <= step.end


# -------------------------------------------------------------- readers

def rec(kind, name, start, value, request=None, cpu=None):
    end = start + value if kind == "span" else start
    return Record(kind, name, start, end, cpu, value, request, 0, 0)


PLANTED = [
    # solve: requests 1 and 2 are dispatched inside the window (10, 20)
    rec("span", "dispatch", 9.0, 0.5, 0, cpu=0.4),
    rec("span", "dispatch", 11.0, 0.2, 1, cpu=0.1),
    rec("span", "dispatch", 12.0, 0.4, 2, cpu=0.3),
    rec("span", "dispatch", 12.5, 0.4, 1),      # no CPU time: left out
    rec("span", "dispatch", 19.9, 0.6, 3, cpu=0.6),
    # staging: requests 1, 2 and 3 are staged inside the window
    rec("span", "stage", 7.9, 0.7, 0),
    rec("span", "stage", 10.2, 0.1, 1),
    rec("span", "stage", 11.4, 0.2, 2),
    rec("span", "stage", 19.5, 0.2, 3),
    rec("span", "stage.copy", 8.0, 0.5, 0),
    rec("span", "stage.copy", 10.21, 0.05, 1),
    rec("span", "stage.copy", 10.27, 0.03, 1),
    rec("span", "stage.copy", 11.45, 0.04, 2),
    rec("span", "stage.copy", 19.55, 0.06, 3),
    rec("counter", "stage.h2d_bytes", 8.0, 9e6, 0),
    rec("counter", "stage.h2d_bytes", 10.21, 3e6, 1),
    rec("counter", "stage.h2d_bytes", 10.27, 1e6, 1),
    rec("counter", "stage.h2d_bytes", 11.45, 4e6, 2),
    rec("counter", "stage.h2d_bytes", 19.55, 5e6, 3),
    rec("span", "prefetch.wait", 10.9, 0.01, 1),
    rec("span", "prefetch.wait", 11.9, 0.03, 2),
    rec("span", "runtime.slot_wait", 10.99, 0.0, 1),
    rec("span", "runtime.slot_wait", 11.99, 0.002, 2),
    rec("device", "runtime.device", 11.5, 0.1, 1),
    rec("device", "runtime.device", 12.5, 0.3, 2),
    rec("counter", "solve.evals", 11.1, 100, 1),
    rec("counter", "solve.evals", 11.1, 28, 1),
    rec("counter", "solve.evals", 12.1, 128, 2),
    rec("counter", "solve.evals", 9.1, 999, 0),
    # train: steps 5 and 6 inside the window
    rec("span", "train.step", 9.0, 0.1, 4),
    rec("span", "train.step", 13.0, 0.03, 5),
    rec("span", "train.step", 14.0, 0.04, 6),
    rec("span", "data.batch", 8.0, 0.01),
    rec("span", "data.batch", 12.9, 0.001),
    rec("span", "data.batch", 13.95, 0.002),
    rec("span", "train.batch", 12.95, 0.003, 5),
    rec("span", "train.batch", 13.96, 0.004, 6),
    rec("span", "train.forward", 9.0, 1.0, 4),
    rec("span", "train.forward", 13.0, 0.010, 5),
    rec("span", "train.forward", 14.0, 0.012, 6),
    rec("span", "train.backward", 13.01, 0.015, 5),
    rec("span", "train.backward", 14.01, 0.017, 6),
    rec("span", "train.optimizer", 13.02, 0.004, 5),
    rec("span", "train.optimizer", 14.02, 0.006, 6),
]

# each reader's value on PLANTED, by hand
EXPECTED = {
    "stage_copy_ms.solve": 1e3 * (0.05 + 0.03 + 0.04 + 0.06) / 3,
    "staged_mb.solve": (3e6 + 1e6 + 4e6 + 5e6) / 3 / 1e6,
    "staging_wait_ms.solve": 1e3 * (0.01 + 0.03) / 2,
    "slot_wait_ms.solve": 1e3 * 0.002 / 2,
    "dispatch_cpu_share.solve": 100.0 * (0.1 + 0.3) / (0.2 + 0.4),
    "solve_device_ms.solve": 1e3 * (0.1 + 0.3) / 2,
    "evals_per_window.solve": (100 + 28 + 128) / 2 / 4,
    "feed_ms.train": 1e3 * (0.001 + 0.002 + 0.003 + 0.004) / 2,
    "forward_ms.train": 1e3 * (0.010 + 0.012) / 2,
    "backward_ms.train": 1e3 * (0.015 + 0.017) / 2,
    "optimizer_ms.train": 1e3 * (0.004 + 0.006) / 2,
}


class Planted:
    def __init__(self, records):
        self._records = list(records)

    def records(self):
        return list(self._records)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_program_span_readers(name, monkeypatch):
    read = common.metric_reader(name)
    run = common.Run(window=(10.0, 20.0),
                     facts={"windows_per_request": 4})
    monkeypatch.setattr(program_spans, "recorder",
                        lambda: Planted(PLANTED))
    assert read(run) == pytest.approx(EXPECTED[name], rel=1e-12)
    # nothing to read: no recorder (the parent's program), no records, or
    # no request in the window
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert read(run) is None
    monkeypatch.setattr(program_spans, "recorder", lambda: Planted([]))
    assert read(run) is None
    monkeypatch.setattr(program_spans, "recorder",
                        lambda: Planted(PLANTED))
    assert read(common.Run(window=(30.0, 40.0),
                           facts={"windows_per_request": 4})) is None
