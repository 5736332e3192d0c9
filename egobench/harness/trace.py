"""The traced part of a run: torch.profiler over a short, steady stretch
of the window, its Chrome trace written under TMPDIR, read back and
deleted.

`read` reduces the trace to what the per-layer readers and the result's
`breakdown` need: the device's busy time (the union of kernel, copy and
set intervals), each kernel's launches and time by name, the device
operations that took most time, and the idle gaps of the device labelled
by what the dispatching thread was doing then (the innermost host
operation or harness span open at the gap's middle).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Tracer:
    """The profiler over a late part of a window: `start` a little ahead
    of it (the profiler's own start-up, a second or two, falls before
    the first marker), `end` `seconds` after the first marker or at the
    window's close, whichever comes first, and `stop` once the window has
    closed (its wind-down falls outside the window).  Two host markers
    bound the traced part on the trace's own clock, so nothing waits for
    the device at either end.  `due(now, t_end)` says what to do; `lead`
    is how long ahead of the traced part the profiler starts (its
    start-up took about 1 s beside the train loop, and 10–14 s beside
    the 32-chunk solve's three busy threads, on the H100 machine)."""

    START, END = "egobench.trace_start", "egobench.trace_end"

    def __init__(self, torch, seconds: float, lead: float):
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.seconds = seconds
        self.lead = lead
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.span = None
        self._t0 = None

    @property
    def started(self) -> bool:
        return self._t0 is not None

    def due(self, now: float, t_end: float) -> None:
        """Start or end the traced part as the window's clock says."""
        if not self.started and now >= t_end - self.seconds - self.lead:
            self.start()
        elif self.started and self.span is None \
                and now >= self._t0 + self.seconds:
            self.end()

    def start(self):
        self.began = time.perf_counter()      # before the start-up
        self.prof.start()
        self._t0 = time.perf_counter()
        with self.torch.profiler.record_function(self.START):
            pass

    def end(self):
        """Mark the end of the traced part (once)."""
        if self.span is not None:
            return
        with self.torch.profiler.record_function(self.END):
            pass
        self.span = (self._t0, time.perf_counter())

    def stop(self) -> dict:
        self.prof.stop()
        fd, path = tempfile.mkstemp(prefix="egobench-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        return read(events)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, t, depth):
    """Name of the latest-starting span of `spans` (sorted) open at t,
    looking back at most `depth` spans; None if none is."""
    i = bisect.bisect_right(spans, (t, float("inf")))
    for a, b, name, _ in reversed(spans[max(0, i - depth):i]):
        if b >= t:
            return name
    return None


def read(trace) -> dict:
    """{busy_s, window_s, kernels {name: (launches, seconds)},
    device_ops, idle_gaps} of a Chrome trace (a dict with 'traceEvents'
    or a list of events), over the part between the tracer's two
    markers where the trace has them."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev, host = [], {}
    launches: dict = {}
    lo, hi = -float("inf"), float("inf")
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if e.get("name") == Tracer.START:
            lo = ts
        elif e.get("name") == Tracer.END:
            hi = ts + dur
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", "?")))
        elif cat in HOST_CATS:
            host.setdefault(e.get("tid"), []).append(
                (ts, ts + dur, e.get("name", "?"), cat))
        elif cat == "cuda_runtime":
            launches[e.get("tid")] = launches.get(e.get("tid"), 0) + 1
    dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev
           if b > lo and a < hi]
    kernels: dict = {}
    for a, b, name in dev:
        n, s = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, s + (b - a) * 1e-6)
    busy = _merge([(a, b) for a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    if lo == -float("inf") or hi == float("inf"):
        lo = min((a for a, _ in busy), default=0.0)
        hi = max((b for _, b in busy), default=0.0)
    # the dispatching thread: the one that made the most runtime calls
    tid = max(launches, key=launches.get) if launches else None
    ops = sorted(x for x in host.get(tid, []) if x[3] == "cpu_op")
    notes = sorted(x for x in host.get(tid, []) if x[3] != "cpu_op")
    gaps: dict = {}
    edges = [(lo, lo)] + busy + [(hi, hi)]
    for (_, end), (nxt, _) in zip(edges, edges[1:]):
        if nxt <= end:
            continue
        mid = 0.5 * (end + nxt)
        label = (_innermost(notes, mid, len(notes)) or "no span") + ": " \
            + (_innermost(ops, mid, 64) or "between host ops")
        gaps[label] = gaps.get(label, 0.0) + (nxt - end) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"busy_s": busy_s, "window_s": (hi - lo) * 1e-6,
            "kernels": kernels,
            "device_ops": [[name[:160], s] for name, (_, s) in top],
            "idle_gaps": [[k[:160], v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]]}
