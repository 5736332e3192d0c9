"""Streaming sequence optimisation for serving.

Counterpart of `globalegomocap_tpu/optimize/streaming.py`: a long-lived
service that keeps the priors on the card and pipelines the solves with
a bounded in-flight depth, a worker that stages batch t+1 while the card
solves batch t, and a priority scheduler over many concurrent streams.

    service = StreamingOptimizer(seq_optimizer, max_in_flight=2)
    for staged in StagePrefetcher(seq_optimizer, batches, depth=2):
        service.submit_batch(staged)
    results = service.drain()

What the JAX runtime gets from asynchronous dispatch, the port gets from
PyTorch's: a warm `optimize_chunks_batched(staged)` only queues work on
the current CUDA stream (`optimize/driver.py`), so `submit_batch` returns
while the card solves.  A submission records a CUDA event on that stream;
completing the oldest submission waits on its event, where the JAX one
calls `block_until_ready`.  On the CPU every call has finished when it
returns and there is no event.

The prefetch worker stages on a CUDA stream of its own, through pinned
host buffers, and hands each batch over with an event the solve's stream
waits on (`SequenceOptimizer._consume`), so staging copies do not queue
behind a solve.  The native host crop releases the GIL; the solve's
dispatch, a Python loop of launches, holds it between launches, so
staging and dispatch overlap only in part.

The runtime records the port's spans (`utils/profiling.py`): the
consumer's wait for a staged batch (`prefetch.wait`), the wait for a
free slot (`runtime.slot_wait`), and on the card each submission's time
on the solve's stream (`runtime.device`, from two timing events, filed
when the submission retires), each under the batch's request id.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import heapq
import queue
import threading

import torch

from globalegomocap_tpu_torch.data.test_data import TestChunk
from globalegomocap_tpu_torch.optimize.driver import (
    SequenceOptimizer, StagedBatch)
from globalegomocap_tpu_torch.optimize.pipeline import ChunkResult
from globalegomocap_tpu_torch.utils.profiling import RECORDER

GUARD_POLICIES = ("first", "every", "off")


def _check_guard(guard: str) -> None:
    if guard not in GUARD_POLICIES:
        raise ValueError(f"unknown guard policy {guard!r}")


def _done_event(device: torch.device, timing: bool = False):
    """An event recorded after the work queued so far on the current
    stream of `device` (None on the CPU, where that work is done);
    `timing` makes it one that `elapsed_time` can read."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=timing)
    event.record(torch.cuda.current_stream(device))
    return event


def _wait(event) -> None:
    if event is not None:
        event.synchronize()


class StreamingOptimizer:
    """Pipelined chunk optimisation with bounded in-flight depth.

    guard: crop-mass-guard policy per submitted chunk or batch:
      'first' (default): resolve the guard on the first submission and
        reuse the decision for the stream (a capture session's maps come
        from one network, so their coverage is stationary);
      'every': re-resolve per submission;
      'off': never crop-guard (the configured heatmap_crop as it is).
    stage_on_host: how `submit_batch` stages a chunk list
      (`SequenceOptimizer.stage(on_host=...)`); the default, False,
      stages on the device, as the JAX runtime does.
    """

    def __init__(self, optimizer: SequenceOptimizer,
                 max_in_flight: int = 2, guard: str = "first",
                 stage_on_host: bool = False):
        _check_guard(guard)
        self.optimizer = optimizer
        self.max_in_flight = max_in_flight
        self.guard = guard
        self.stage_on_host = stage_on_host
        self._guard_cfg = optimizer.cfg if guard == "off" else None
        self._batch_coverage: float | None = None
        self._in_flight: collections.deque = collections.deque()
        self._completed: list[ChunkResult] = []

    def _chunk_cfg(self, chunk: TestChunk):
        if self.guard == "every":
            return self.optimizer._effective_cfg(chunk.heatmaps)
        if self._guard_cfg is None:
            self._guard_cfg = self.optimizer._effective_cfg(chunk.heatmaps)
        return self._guard_cfg

    def _dispatch(self, solve, request: int | None = None) -> None:
        """Wait for the oldest submissions until a slot is free, then
        queue `solve()` between two timing events (the span
        `runtime.device` of `request`)."""
        with RECORDER.span("runtime.slot_wait", request=request):
            while len(self._in_flight) >= self.max_in_flight:
                self._finish_oldest()
        device = self.optimizer.device
        start = _done_event(device, timing=True)
        result = solve()
        self._in_flight.append(
            (result, start, _done_event(device, timing=True), request))

    def submit(self, chunk: TestChunk) -> None:
        """Enqueue a chunk (per-window solves, `optimize_chunk`).  Returns
        once the work is queued; blocks only when `max_in_flight` results
        are already pending (then waits for the oldest)."""
        self._dispatch(lambda: self.optimizer.optimize_chunk(
            chunk, cfg=self._chunk_cfg(chunk)))

    def submit_batch(self, chunks_or_staged, mode: str = "flat") -> None:
        """Enqueue a whole equal-length batch as one flat solve: a
        StagedBatch (passed on as it is) or a chunk list, staged here
        under the guard policy ('first' measures the coverage on the first
        batch only and reuses it).  The drained result of a batch is the
        batched ChunkResult (leading chunk axis)."""
        if not isinstance(chunks_or_staged, StagedBatch):
            if self.guard == "off":
                cov = 1.0
            elif self.guard == "first" and self._batch_coverage is not None:
                cov = self._batch_coverage
            else:
                cov = None                       # measured while staging
            chunks_or_staged = self.optimizer.stage(
                chunks_or_staged, coverage=cov, on_host=self.stage_on_host)
            if self._batch_coverage is None:
                self._batch_coverage = chunks_or_staged.crop_coverage
        staged = chunks_or_staged
        if staged.ready is not None:
            # the solve's stream waits for staging here, ahead of the
            # span `runtime.device`, which then times the solve alone
            self.optimizer._consume(staged)
            staged = dataclasses.replace(staged, ready=None)
        self._dispatch(lambda: self.optimizer.optimize_chunks_batched(
            staged, mode=mode), staged.request)

    def _finish_oldest(self) -> None:
        result, start, done, request = self._in_flight.popleft()
        _wait(done)
        if start is not None:
            RECORDER.device_span("runtime.device",
                                 1e-3 * start.elapsed_time(done), request)
        self._completed.append(result)

    def drain(self) -> list[ChunkResult]:
        """Wait for all in-flight work; return every completed result in
        submission order and reset the pipeline."""
        while self._in_flight:
            self._finish_oldest()
        out = self._completed
        self._completed = []
        return out

    def process_all(self, chunks) -> list[ChunkResult]:
        """Submit every chunk, drain, return the results."""
        for c in chunks:
            self.submit(c)
        return self.drain()


class StagePrefetcher:
    """Stage batch t+1 on a worker thread while the card solves batch t.

    Iterating yields StagedBatch objects in source order; a StagedBatch
    in the source passes through as the same object.  The worker owns the
    crop-guard measurement ('first': the first batch's coverage is reused
    for the rest of this source).  On the card it stages on a CUDA stream
    of its own and marks each batch with an event recorded there
    (`StagedBatch.ready`), which the solve's stream waits on.  A worker
    exception re-raises on the consumer at the point of consumption.  The
    queue holds at most `depth` staged batches, which bounds their device
    memory.  Over a mesh of several ranks staging's collectives run on
    the mesh's staging group (`parallel/mesh.py`), so the worker's
    all_reduce never pairs with the consumer's gathers on another rank.

        for staged in StagePrefetcher(opt, batches, depth=2):
            service.submit_batch(staged)
    """

    _DONE = object()

    def __init__(self, optimizer: SequenceOptimizer, source,
                 depth: int = 2, on_host: bool = False,
                 guard: str = "first"):
        _check_guard(guard)
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.optimizer = optimizer
        self.on_host = on_host
        self.guard = guard
        self._coverage: float | None = 1.0 if guard == "off" else None
        dev = optimizer.device
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" \
            else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._run, args=(iter(source),), daemon=True)
        self._thread.start()

    def _run(self, it) -> None:
        stream_ctx = (torch.cuda.stream(self._stream)
                      if self._stream is not None
                      else contextlib.nullcontext())
        try:
            with stream_ctx:
                for batch in it:
                    self._q.put(batch if isinstance(batch, StagedBatch)
                                else self._stage(batch))
        except BaseException as e:   # noqa: BLE001 - re-raised by __iter__
            self._err = e
        finally:
            self._q.put(self._DONE)

    def _stage(self, chunks) -> StagedBatch:
        staged = self.optimizer.stage(chunks, coverage=self._coverage,
                                      on_host=self.on_host)
        if self.guard == "first" and self._coverage is None:
            self._coverage = staged.crop_coverage
        if self._stream is None:
            return staged
        ready = torch.cuda.Event()
        ready.record(self._stream)
        return dataclasses.replace(staged, ready=ready)

    def __iter__(self):
        while True:
            with RECORDER.span("prefetch.wait") as span:
                item = self._q.get()
                span.request = getattr(item, "request", None)
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item


class MultiStreamOptimizer:
    """Serve many concurrent sequences over one optimizer.

    Each stream is a named sequence of chunks with a priority; pending
    chunks of all streams sit in one priority queue (higher priority
    first, FIFO within a priority), and the scheduler keeps at most
    `max_in_flight` solves outstanding.  Per-stream result order is
    submission order; `dispatch_order` lists the stream of each dispatch.
    """

    def __init__(self, optimizer: SequenceOptimizer,
                 max_in_flight: int = 2, guard: str = "first"):
        _check_guard(guard)
        self.optimizer = optimizer
        self.max_in_flight = max_in_flight
        self.guard = guard
        self._guard_cfg = optimizer.cfg if guard == "off" else None
        self._pending: list = []           # heap of (-prio, seq, name, chunk)
        self._seq = 0
        self._priorities: dict[str, int] = {}
        self._in_flight: collections.deque = collections.deque()
        self._completed: dict[str, list[ChunkResult]] = {}
        self.dispatch_order: list[str] = []

    def open_stream(self, name: str, priority: int = 0) -> None:
        if name in self._priorities:
            raise ValueError(f"stream {name!r} already open")
        self._priorities[name] = priority
        self._completed[name] = []

    def submit(self, name: str, chunk: TestChunk) -> None:
        """Enqueue a chunk on an open stream.  Never blocks: chunks beyond
        the in-flight capacity wait in the priority queue and dispatch as
        slots free up."""
        if name not in self._priorities:
            raise KeyError(f"unknown stream {name!r}; open_stream first")
        heapq.heappush(self._pending,
                       (-self._priorities[name], self._seq, name, chunk))
        self._seq += 1
        self._pump()

    def _pump(self) -> None:
        """Dispatch pending chunks into free in-flight slots, highest
        priority first (FIFO within a priority)."""
        while self._pending and len(self._in_flight) < self.max_in_flight:
            _, _, name, chunk = heapq.heappop(self._pending)
            self.dispatch_order.append(name)
            if self.guard == "every":
                cfg = self.optimizer._effective_cfg(chunk.heatmaps)
            else:
                if self._guard_cfg is None:
                    self._guard_cfg = self.optimizer._effective_cfg(
                        chunk.heatmaps)
                cfg = self._guard_cfg
            result = self.optimizer.optimize_chunk(chunk, cfg=cfg)
            self._in_flight.append(
                (name, result, _done_event(self.optimizer.device)))

    def _finish_oldest(self) -> None:
        name, result, done = self._in_flight.popleft()
        _wait(done)
        self._completed[name].append(result)

    def drain(self) -> dict[str, list[ChunkResult]]:
        """Wait for everything; return {stream: results in submission
        order} and reset the queues (streams stay open)."""
        while self._in_flight or self._pending:
            self._finish_oldest()
            self._pump()
        out = self._completed
        self._completed = {k: [] for k in self._priorities}
        return out
