"""What every cell's run shares: finding a cell's files and its loop by
name, the run's context, the host spans, the import guard, the device
record and the result line."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)                 # egobench/
ROOT = os.path.dirname(BENCH)                 # the checkout

# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "globalegomocap_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_files(bench: dict, workload: str) -> tuple:
    """(cell entry, configuration file's contents, traffic mix's
    contents) of the cell named `workload`; KeyError for a name
    BENCHMARK.json lacks, FileNotFoundError for a missing file."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it has {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise KeyError(f"workload {workload!r} names configuration "
                       f"{cell['config']!r}, which BENCHMARK.json lacks")
    cfg = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    mix = load_json(os.path.join(BENCH, "traffic", cell["traffic"] + ".json"))
    return cell, cfg, mix


def limits(workload: str) -> dict:
    """The cell's limits, egobench/limits/<workload>.json."""
    return load_json(os.path.join(BENCH, "limits", workload + ".json"))


def loop(kind: str):
    """The module egobench/loops/<kind>.py that drives a mix of `kind`:
    `run(torch, ctx)`, `controls(torch, ctx)` and `PROGRAM_CONTROLS`;
    FileNotFoundError for a kind with no loop."""
    if not os.path.isfile(os.path.join(BENCH, "loops", kind + ".py")):
        raise FileNotFoundError(f"no loop egobench/loops/{kind}.py for the "
                                f"mix kind {kind!r}")
    return importlib.import_module("egobench.loops." + kind)


def context(cell, cfg, mix, limits, seed, seconds, device, t0,
            trace=False, program=None) -> SimpleNamespace:
    """What a loop's `run` and `controls` read: the cell's entry and
    files, the seed, the window's seconds, whether to trace, the device,
    the process's start (`t0`, perf_counter), and `program`: options of
    the program's configuration to override (a control's), never the
    reference's.  `marks` collects the set-up's phases."""
    return SimpleNamespace(cell=cell, cfg=cfg, mix=mix, limits=limits,
                           seed=int(seed), seconds=float(seconds),
                           device=device, t0=t0, trace=bool(trace),
                           program=dict(program or {}), marks=[])


def mark(ctx, name: str) -> None:
    """The end of a set-up phase `name`, on the host clock."""
    ctx.marks.append((name, time.perf_counter()))


def setup_phases(ctx) -> str:
    """The set-up's phases and their seconds, for the log."""
    out, last = [], ctx.t0
    for name, t in ctx.marks:
        out.append(f"{name} {t - last:.3f}")
        last = t
    return ", ".join(out)


def correct(checks: dict) -> bool:
    """Every number compared is a number and within its limit."""
    return all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: with trace the
    per-layer ones, else the end-to-end ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def metric_reader(name: str):
    """`read(run)` of egobench/metrics/<name>.py; FileNotFoundError for a
    metric with no reader."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader {path} for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        "egobench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list:
    """Loaded modules (of `modules`, default sys.modules) whose top-level
    name is a JAX library or the JAX package, compared whole: the port's
    name only begins with the JAX package's."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


class Spans:
    """Host-clock spans by name: (start, end) pairs, thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: dict = {}

    def add(self, name: str, start: float, end: float) -> None:
        with self._lock:
            self.items.setdefault(name, []).append((start, end))

    def wrap(self, name: str, fn, after=None):
        """fn with a span `name` around each call; `after(result, start,
        end)` runs after the span closes."""
        def call(*args, **kwargs):
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            end = time.perf_counter()
            self.add(name, start, end)
            if after is not None:
                after(out, start, end)
            return out
        return call

    def mean_ms(self, name: str, lo: float, hi: float):
        """Mean duration (ms) of the spans `name` that lie in [lo, hi];
        None where there are none."""
        spans = [(a, b) for a, b in self.items.get(name, [])
                 if lo <= a and b <= hi]
        if not spans:
            return None
        return 1e3 * sum(b - a for a, b in spans) / len(spans)


@dataclass
class Run:
    """What a run hands its per-layer readers."""
    # host clock of the window's untraced part, where the host's
    # per-layer readings are taken
    window: tuple = (0.0, 0.0)
    spans: Spans = field(default_factory=Spans)
    facts: dict = field(default_factory=dict)
    trace: dict | None = None


def card_record(torch, count: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def emit(result: dict, checks: dict) -> None:
    """The numbers compared, each with its limit, as the last lines on
    standard error, and the result as the last line on standard output,
    with the checks under the key that comes last."""
    result = dict(result, checks=checks)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
