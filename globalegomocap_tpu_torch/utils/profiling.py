"""The program's spans and counters, and the device trace.

`SpanTimer` is the counterpart of `SpanTimer` in
`globalegomocap_tpu/utils/profiling.py`, grown into the port's recorder;
`device_trace` is the counterpart of `device_trace` (torch.profiler's
Chrome trace, where the JAX package writes jax.profiler's TensorBoard
trace).  A `sync_value` tensor on a CUDA device makes a span end only
after the card has finished the work queued on that device (the JAX
package's `block_until_ready`).

`RECORDER` is the one process-wide recorder every part of the port
records into, always on.  A span records its name, its start and end on
`time.perf_counter()` (the clock a caller's own timings use), the span
open on the same thread when it began (its parent), and a request id,
inherited from that parent unless one is given; a span opened with
`cpu=True` (the root spans `stage`, `dispatch`, `train.step`) also
records the thread CPU time it took (`time.thread_time()`: below the
wall time where the thread waited, on the GIL, a blocking CUDA call or
the scheduler).  Each read of that clock is a system call, which took
2.4–3.4 µs on an H100 host's CPU, more than the rest of a span, so
the spans inside a phase leave it out.  A counter adds a
number under a name, with the request id of the span open on its thread.
The records sit in a buffer of fixed capacity that drops the oldest when
full (`dropped` counts them); the prefetch worker and the main thread
write into it at once.  While a torch.profiler session records, each
span also opens `torch.profiler.record_function(<its name>)`, so it lands
in the Chrome trace (`--profile_dir`) as a `user_annotation` on the
kernels' clock, nested in whatever its caller opened; with no profiler
recording nothing is entered.

The port's spans and counters, from the request down:

| Name | Kind | Where | Meaning |
| --- | --- | --- | --- |
| `stage` | span, CPU time | `optimize/driver.py::SequenceOptimizer.stage` | staging one batch of chunks; opens the request id (a per-optimizer sequence number, carried on as `StagedBatch.request`) |
| `stage.copy` | span | `_stage_device`, `_stage_host` | the host-to-device copies of the maps and of the fields (the fill of the pinned memory included), one span each |
| `stage.ring_wait` | span | `optimize/transfer.py::PinnedRing.slot`, inside `stage.copy` | waiting until a pinned slot of the ring is free and its last copy to the card has finished |
| `stage.h2d_bytes` | counter | `SequenceOptimizer._put`, `_put_maps` | bytes that cross to the card (0 on the CPU) |
| `stage.relayout_bytes` | counter | `SequenceOptimizer._put_maps` (`_stage_device`) | map bytes that crossed in an order other than channels-last and were reordered on the card (0 on the CPU) |
| `prefetch.wait` | span | `optimize/streaming.py::StagePrefetcher.__iter__` | the consumer waiting for a staged batch; the id of the batch it got |
| `runtime.slot_wait` | span | `StreamingOptimizer` (`submit`, `submit_batch`) | waiting for an in-flight submission to finish until a slot is free |
| `dispatch` | span, CPU time | `SequenceOptimizer.optimize_chunks_batched` | the enqueue of one batched solve |
| `solve.stage1`, `solve.lift`, `solve.stage2`, `solve.merge` | spans | `optimize/pipeline.py` (`solve_windows`; the merge in `optimize_chunks_flat`, `optimize_chunk`) | stage 1's solve, the coordinate lifts, stage 2's solve, the overlap merge and smoothing |
| `solve.evals` | counter | `optimize/lbfgs.py` (`_fixed_loop`, `lbfgs_minimize`) | lanes x points of each objective call |
| `runtime.device` | device span | `StreamingOptimizer`, filed when a submission retires | the card's time (CUDA events on the solve's stream) from the start of a submission's work to its end |
| `data.batch` | span | `data/amass.py::AmassWindows.epoch_batches` | gathering one batch of windows on the host |
| `train.batch` | span | `train/train_vae.py::Trainer._device_batch` | a batch's copy to the card; the id of the step that takes it |
| `train.step` | span, CPU time | the step `make_train_step` returns | one update; the id is the step count |
| `train.forward` | span | inside `train.step` | the learning rate, encode, noise, decode and loss |
| `train.backward` | span | inside `train.step` | `zero_grad` and `backward` (with the mesh's all-reduce) |
| `train.optimizer` | span | inside `train.step` | `optimizer.step()` |
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

_perf_counter = time.perf_counter


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with torch.profiler (host operators, the port's
    spans, and the card's kernels where CUDA is available) and write it
    as a Chrome trace, `log_dir`/trace_<pid>.json (open it in
    chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def _wait_for(sync_value) -> None:
    """Wait for the card's queued work on `sync_value`'s device (nothing
    to wait for on the CPU)."""
    if sync_value is not None and sync_value.device.type == "cuda":
        torch.cuda.synchronize(sync_value.device)


class Record(NamedTuple):
    """One record of a `SpanTimer`.  kind: 'span', 'counter' or 'device'
    (a span timed on the card's clock, filed when the host learns it);
    start, end: perf_counter seconds (a counter's or a device span's
    both are the moment it was filed); cpu: the thread CPU seconds of a
    span opened with cpu=True, else None;
    value: a span's wall seconds, a counter's number, a device span's
    seconds on the card; request: the request id, or None; id: the
    record's own id; parent: the id of the span open on the same thread
    (0 where none was)."""
    kind: str
    name: str
    start: float
    end: float
    cpu: float | None
    value: float
    request: int | None
    id: int
    parent: int


class _ThreadState:
    """One thread's open spans and the number of records it added."""

    __slots__ = ("stack", "added")

    def __init__(self):
        self.stack = []
        self.added = 0


class _Local(threading.local):
    """The calling thread's `_ThreadState`, made on its first use and
    registered with its recorder."""

    def __init__(self, registry: list):
        self.state = _ThreadState()
        registry.append(self.state)


class _Span:
    """One open span of a `SpanTimer` (the context manager `span`
    returns); `request` may be set before it closes."""

    __slots__ = ("_timer", "name", "request", "_cpu", "_state", "_id",
                 "_parent", "_note", "_start")

    def __init__(self, timer, name, request, cpu):
        self._timer = timer
        self.name = name
        self.request = request
        self._cpu = cpu

    def __enter__(self):
        timer = self._timer
        self._state = state = timer._local.state
        stack = state.stack
        if stack:
            top = stack[-1]
            self._parent = top._id
            if self.request is None:
                self.request = top.request
        else:
            self._parent = 0
        self._id = next(timer._ids)
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._note = torch.profiler.record_function(self.name)
            self._note.__enter__()
        else:
            self._note = None
        # the CPU clock's reads lie inside the wall clock's
        self._start = _perf_counter()
        self._cpu = time.thread_time() if self._cpu else None
        return self

    def __exit__(self, exc_type, exc, tb):
        cpu = None if self._cpu is None else time.thread_time() - self._cpu
        end = _perf_counter()
        if self._note is not None:
            self._note.__exit__(exc_type, exc, tb)
        state = self._state
        state.stack.pop()
        state.added += 1
        self._timer._records.append((
            "span", self.name, self._start, end, cpu, end - self._start,
            self.request, self._id, self._parent))
        return False


class _SyncSpan(_Span):
    """A span that ends once the card has finished the work queued on
    its `sync_value`'s device."""

    __slots__ = ("_sync",)

    def __exit__(self, exc_type, exc, tb):
        _wait_for(self._sync)
        return super().__exit__(exc_type, exc, tb)


class SpanTimer:
    """Named spans, counters and device spans in a buffer of `capacity`
    records, the oldest dropped when it is full (`dropped` counts them);
    with `sync_value` (a tensor) a span ends only after the card has
    finished the work queued so far on that tensor's device.  Safe to
    record into from several threads, with no lock: each thread nests
    its own spans and counts its own records, and an append to the
    buffer, like the copy `records` takes, is atomic under the GIL."""

    def __init__(self, capacity: int = 1 << 16):
        self._records: collections.deque = collections.deque(
            maxlen=capacity)
        self._threads: list[_ThreadState] = []
        self._local = _Local(self._threads)
        self._ids = itertools.count(1)

    @property
    def dropped(self) -> int:
        """Records dropped from the full buffer: all but the newest
        `capacity` of those ever added."""
        added = sum(t.added for t in list(self._threads))
        return max(0, added - self._records.maxlen)

    def span(self, name: str, sync_value=None, request: int | None = None,
             cpu: bool = False) -> _Span:
        """A context manager that records a span `name` around its block
        (it yields the open span, whose `request` may still be set);
        `cpu` adds the thread CPU time."""
        if sync_value is None:
            return _Span(self, name, request, cpu)
        span = _SyncSpan(self, name, request, cpu)
        span._sync = sync_value
        return span

    def count(self, name: str, value: float,
              request: int | None = None) -> None:
        """Add `value` under the counter `name` (under the request id of
        the span open on this thread unless `request` is given)."""
        state = self._local.state
        top = state.stack[-1] if state.stack else None
        if top is not None and request is None:
            request = top.request
        t = _perf_counter()
        state.added += 1
        self._records.append(("counter", name, t, t, None, value, request,
                              next(self._ids),
                              top._id if top is not None else 0))

    def device_span(self, name: str, seconds: float,
                    request: int | None = None) -> None:
        """File a span of `seconds` measured on the card's clock (no
        parent: the host learns of it outside the span that caused it)."""
        t = _perf_counter()
        self._local.state.added += 1
        self._records.append(("device", name, t, t, None, seconds, request,
                              next(self._ids), 0))

    def records(self) -> list[Record]:
        """Every record held, oldest first."""
        return [Record._make(r) for r in list(self._records)]

    def summary(self) -> dict:
        """{span name: {mean_s, total_s, count}} over the spans held."""
        out: dict = {}
        for r in self.records():
            if r.kind == "span":
                s = out.setdefault(r.name, {"total_s": 0.0, "count": 0})
                s["total_s"] += r.value
                s["count"] += 1
        return {k: {"mean_s": v["total_s"] / v["count"],
                    "total_s": v["total_s"], "count": v["count"]}
                for k, v in out.items()}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=1)


RECORDER = SpanTimer()
