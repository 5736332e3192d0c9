"""One run of one cell:

    python3 egobench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

finds the cell in BENCHMARK.json, its configuration, traffic mix and
limits by name, runs the loop that the mix's `kind` names
(egobench/loops/<kind>.py) on the card, checks what the timed path
produced against the plain reference, and prints the result as the last
line of standard output: with --trace 0 the cell's end-to-end metrics,
with --trace 1 its per-layer ones, read from the run by
egobench/metrics/<metric>.py.  No card, too few cards, or a module of
JAX or of the JAX package in the process: no result and a non-zero exit.
"""

from __future__ import annotations

import argparse
import os
import sys

from egobench.harness import common


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    return p.parse_args(argv)


def process_settings() -> None:
    """Compile caches at fixed paths inside the checkout (the kernels'
    nvcc builds go to the port's own build/kernels/ there)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(common.BENCH, ".cache",
                                                  "triton")


def result_line(entries, readers, rec, parts, checks, device) -> dict:
    """The result's keys (`checks` joins last, in `common.emit`): the
    end-to-end metrics the run measured, or with `readers` (a traced
    run) the per-layer ones they find in the run, with the device's
    busy and traced seconds and the breakdown."""
    result = {"correct": common.correct(checks),
              "attempted": parts["attempted"], "failed": parts["failed"],
              "metrics": {}, "device": device}
    for m in entries:
        value = (readers[m["name"]](rec) if readers
                 else parts["metrics"][m["name"]])
        if value is not None:
            result["metrics"][m["name"]] = {"value": value,
                                            "unit": m["unit"]}
    if readers and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace["busy_s"]
        result["device"]["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    return result


def main(argv, t0: float) -> int:
    args = parse(argv)
    bench = common.benchmark()
    cell, cfg, mix = common.cell_files(bench, args.workload)
    limits = common.limits(args.workload)
    loop = common.loop(mix["kind"])
    entries = common.cell_metrics(bench, args.workload, bool(args.trace))
    readers = ({m["name"]: common.metric_reader(m["name"]) for m in entries}
               if args.trace else {})
    process_settings()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"egobench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)        # the card's context
    import globalegomocap_tpu_torch  # noqa: F401 - the precision policy
    ctx = common.context(cell, cfg, mix, limits, args.seed, args.seconds,
                         device, t0, trace=args.trace)
    common.mark(ctx, "imports and the card's context")
    rec, parts, checks = loop.run(torch, ctx)
    print(f"egobench: set-up phases (s): {common.setup_phases(ctx)}",
          file=sys.stderr, flush=True)
    found = common.forbidden_modules()
    if found:
        print(f"egobench: the process holds {found}: JAX or the JAX "
              f"package was imported", file=sys.stderr)
        return 3
    print(f"egobench: card {common.card_line()}", file=sys.stderr)
    result = result_line(entries, readers, rec, parts, checks,
                         common.card_record(torch, int(cell["chips"]),
                                            parts["peak"]))
    common.emit(result, checks)
    return 0
