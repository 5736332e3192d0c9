"""The cost of one span of the port's recorder (`utils/profiling.py`):
`--spans` empty spans timed on the host clock, less the empty loop, with
no profiler recording and inside a torch.profiler session (CPU, and CUDA
where there is a card), beside a span that reads the thread CPU time,
the clocks a span reads and a counter.
Run from the root of a checkout; prints one JSON line (microseconds):

    python3 tests/torch_span_cost_probe.py [--spans 100000]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from globalegomocap_tpu_torch.utils.profiling import SpanTimer  # noqa: E402


def per_call_us(fn, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t0) / n


def spans_us(n: int, cpu: bool = False) -> float:
    """Microseconds a span, less the loop that runs them."""
    span = SpanTimer(capacity=n).span
    with span("probe", cpu=cpu):
        pass
    t0 = time.perf_counter()
    for _ in range(n):
        with span("probe", cpu=cpu):
            pass
    t1 = time.perf_counter()
    for _ in range(n):
        pass
    t2 = time.perf_counter()
    return 1e6 * ((t1 - t0) - (t2 - t1)) / n


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--spans", type=int, default=100_000)
    n = p.parse_args(argv).spans
    timer = SpanTimer(capacity=n)
    out = {"spans": n,
           "perf_counter_us": per_call_us(time.perf_counter, n),
           "thread_time_us": per_call_us(time.thread_time, n),
           "count_us": per_call_us(lambda: timer.count("probe", 1), n),
           "span_us": [spans_us(n) for _ in range(5)],
           "span_cpu_us": spans_us(n, cpu=True)}
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        out["span_profiled_us"] = [spans_us(n) for _ in range(3)]
    out["span_after_us"] = spans_us(n)
    out["torch"] = torch.__version__
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
