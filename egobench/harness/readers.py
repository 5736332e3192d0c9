"""What the per-layer readers in egobench/metrics/ share.  Each returns
None where the run holds nothing to read, and the harness then leaves
the metric out of the line."""

from __future__ import annotations

from egobench.counts import flops


def span_ms(run, name):
    """Mean host time (ms) of the harness's span `name` over the window,
    leaving out the traced part."""
    return run.spans.mean_ms(name, *run.window)


def idle_share(run):
    """Per cent of the traced part with no operation on the device."""
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_time(run, pattern):
    """(launches, mean seconds a launch) of the kernels whose name holds
    `pattern` in the trace, or None."""
    if not run.trace:
        return None
    n = s = 0
    for name, (count, secs) in run.trace["kernels"].items():
        if pattern in name:
            n, s = n + count, s + secs
    return (n, s / n) if n else None


def energy_roofline(run, pattern, stage_key, reproj):
    """Per cent of a stage-energy kernel's least time (counts/flops.py at
    the run's shapes) in its mean time a launch."""
    k = kernel_time(run, pattern)
    if k is None:
        return None
    f = run.facts
    least = flops.energy_mean_least_seconds(
        f["windows_per_request"], f["seq_len"], f["k"], f["crop_bytes"],
        f[stage_key], reproj)
    return 100.0 * least / k[1]
