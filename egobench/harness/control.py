"""The readings the limits in egobench/limits/ are set from, on the card.

    python3 -m egobench.harness.control --workload <cell> --seeds 1,2,3
        [--program-seeds 4,5,...] [--seconds 4] [--out readings.json]

For each seed of --seeds, the cell's controls: the loop's own
(`controls`: the plain reference put in the program's place one
precision down, and for a train cell the fault of half the batch left
out), and each of the program's own lower-precision paths
(`PROGRAM_CONTROLS`), run through the cell's loop with a short window
and checked as a benchmark run checks it.  For each seed of
--program-seeds, a sound run of the program the same way.  Every reading
goes through the cell's limits and the harness's `correct`, and prints
as one JSON line: a control has to come out `"correct": false`, a sound
run `true`.  Without a card it prints nothing and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from egobench.harness import common


def judged(numbers: dict, limits: dict) -> dict:
    """`numbers` with the harness's verdict over those that have a
    limit."""
    checks = {k: {"value": float(v), "limit": limits[k]}
              for k, v in numbers.items() if k in limits}
    return dict(numbers, correct=common.correct(checks) if checks else None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--program-seeds", default="")
    p.add_argument("--seconds", default=4.0, type=float)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    bench = common.benchmark()
    cell, cfg, mix = common.cell_files(bench, args.workload)
    limits = common.limits(args.workload)
    loop = common.loop(mix["kind"])
    import torch
    if not torch.cuda.is_available():
        print("egobench.control: the readings are the card's; this "
              "machine has none", file=sys.stderr)
        return 2
    import globalegomocap_tpu_torch  # noqa: F401 - the precision policy
    device = torch.device("cuda:0")
    rows = []

    def say(row):
        row = {k: (None if isinstance(v, float) and not math.isfinite(v)
                   else v) for k, v in row.items()}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def program(seed, overrides):
        ctx = common.context(cell, cfg, mix, limits, seed, args.seconds,
                             device, time.perf_counter(), program=overrides)
        _, _, checks = loop.run(torch, ctx)
        torch.cuda.empty_cache()
        return judged({k: v["value"] for k, v in checks.items()}, limits)

    for s in [int(x) for x in args.seeds.split(",") if x]:
        ctx = common.context(cell, cfg, mix, limits, s, args.seconds,
                             device, time.perf_counter())
        for name, numbers in loop.controls(torch, ctx).items():
            say({"kind": name, "seed": s, **judged(numbers, limits)})
        torch.cuda.empty_cache()
        for name, overrides in loop.PROGRAM_CONTROLS.items():
            try:
                say({"kind": name, "seed": s, **program(s, overrides)})
            except Exception as e:  # noqa: BLE001 - a control that crashes
                say({"kind": name, "seed": s, "correct": False,
                     "error": repr(e)[:300]})
    for s in [int(x) for x in args.program_seeds.split(",") if x]:
        say({"kind": "program", "seed": s, **program(s, {})})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
