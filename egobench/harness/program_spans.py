"""The port's own spans and counters (`RECORDER` in
globalegomocap_tpu_torch/utils/profiling.py, which names each one) over a
run's window, for the per-layer readers in egobench/metrics/.

A request is an id with a `dispatch` span inside the window (for the
staging metrics, a `stage` span, so that they count the requests
`stage_ms.solve` counts), a step an id with a `train.step` span there;
a request's or a step's records are those under its id, wherever they
lie in time.  Each reader returns None where there is nothing to
read: a program without the recorder, no request or step in the window,
or no record of the name under their ids.
"""

from __future__ import annotations


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from globalegomocap_tpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    return rec if hasattr(rec, "records") else None


def _held():
    rec = recorder()
    return rec.records() if rec is not None else []


def ids(run, records, anchor: str) -> set:
    """The request ids of the spans `anchor` that lie in the window."""
    lo, hi = run.window
    return {r.request for r in records
            if r.kind == "span" and r.name == anchor
            and r.request is not None and lo <= r.start and r.end <= hi}


def per_request(run, name: str, anchor: str = "dispatch"):
    """Σ `value` (a span's seconds, a counter's number, a device span's
    seconds on the card) of the records `name` under the ids of `anchor`
    in the window, over the number of those ids."""
    held = _held()
    want = ids(run, held, anchor)
    values = [r.value for r in held if r.name == name and r.request in want]
    if not want or not values:
        return None
    return sum(values) / len(want)


def cpu_share(run, name: str):
    """Per cent of the wall time of the spans `name` in the window (those
    that record their thread CPU time) that their thread spent on the
    CPU."""
    held = _held()
    want = ids(run, held, name)
    spans = [r for r in held if r.kind == "span" and r.name == name
             and r.request in want and r.cpu is not None]
    wall = sum(r.value for r in spans)
    if not spans or wall <= 0:
        return None
    return 100.0 * sum(r.cpu for r in spans) / wall


def window_per_request(run, names, anchor: str):
    """Σ seconds of the spans `names` that lie in the window (with or
    without an id), over the number of ids of `anchor` in the window."""
    held = _held()
    want = ids(run, held, anchor)
    lo, hi = run.window
    spans = [r.value for r in held if r.kind == "span" and r.name in names
             and lo <= r.start and r.end <= hi]
    if not want or not spans:
        return None
    return sum(spans) / len(want)
