"""Counts the ranks that abort as they leave: loops of two-rank gloo
groups on the CPU whose ranks use the default and the staging group and
finish at different times, several loops side by side to load the host.

The abort it counts is the one `parallel/mesh.py::_rank_main` now
prevents: a rank that returned first died by SIGABRT ("terminate called
without an active exception") at interpreter exit while its peer still
ran.  It showed only under load, so each mode starts `--loops`
processes at once.  Imports nothing of JAX.  From the root of a
checkout (a copy of an older tree takes this file as it is):

    python3 tests/torch_spawn_probe.py --loops 6 --runs 20
    python3 tests/torch_spawn_probe.py --loops 6 --runs 15 --torchrun
    python3 tests/torch_spawn_probe.py --loops 6 --runs 3 \\
        --pytest tests/test_torch_sample_init.py

The first mode spawns through `parallel.mesh.spawn` (`--variant noauto`
drops the all_reduce's backward, `--variant nostage` the staging
group's collective); the second starts each pair with `torchrun`, the
caller making the default group, `run_on_ranks` running on it and the
caller destroying it with no barrier; the third runs a test file in
`--loops` pytest processes at once, `--runs` rounds.  Prints the aborts
of each loop and their sum.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def work(mesh, slow_rank: int, sleep_s: float) -> int:
    """Ten rounds of all_reduce (with its backward), the staging group's
    all_reduce, all_gather and broadcast_object; then `slow_rank`
    sleeps `sleep_s`."""
    import torch

    from globalegomocap_tpu_torch.parallel import mesh as pm
    variant = os.environ.get("SPAWN_PROBE_VARIANT", "")
    x = torch.ones(64, requires_grad=variant != "noauto")
    for _ in range(10):
        y = pm.all_reduce(mesh, x * 2.0)
        if variant != "noauto":
            y.sum().backward()
        if variant != "nostage":
            pm.all_reduce(mesh.staging(), torch.ones(2))
        pm.all_gather(mesh, torch.ones(3))
        pm.broadcast_object(mesh, {"a": 1})
    if mesh.rank == slow_rank:
        time.sleep(sleep_s)
    return mesh.rank


def spawn_loop(runs: int) -> int:
    """`runs` spawns, the slow rank and its sleep (1-2 s) by turns: the
    number that raised."""
    from globalegomocap_tpu_torch.parallel import mesh as pm
    bad = 0
    for i in range(runs):
        try:
            pm.spawn(work, 2, ["cpu"] * 2, timeout_s=240, threads=1,
                     args=(i % 2, 1.0 + (i % 3) * 0.5))
        except Exception as e:  # noqa: BLE001 - counted, and printed
            bad += 1
            print(f"run {i}: {type(e).__name__}: {e}", flush=True)
    return bad


def torchrun_rank(slow_rank: int) -> None:
    """One rank under torchrun: the caller's group, the port on it, the
    caller's teardown with no barrier."""
    from types import SimpleNamespace

    import torch
    import torch.distributed as dist

    from globalegomocap_tpu_torch.cli.optimize_sequence import run_on_ranks
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    run_on_ranks(lambda mesh, args: work(mesh, slow_rank, 1.0),
                 SimpleNamespace(device="cpu"))
    dist.destroy_process_group()


def torchrun_loop(runs: int, port: int) -> int:
    bad = 0
    for i in range(runs):
        out = subprocess.run(
            ["torchrun", "--nproc_per_node", "2", "--master_addr",
             "127.0.0.1", "--master_port", str(port), __file__,
             "--rank_of_torchrun", str(i % 2)],
            capture_output=True, text=True)
        if out.returncode:
            bad += 1
            why = [ln for ln in (out.stdout + out.stderr).splitlines()
                   if "terminate called" in ln or "Signal" in ln]
            print(f"run {i}: rc {out.returncode}; {'; '.join(why[:2])}",
                  flush=True)
    return bad


def pytest_rounds(path: str, loops: int, runs: int) -> int:
    """`runs` rounds of `loops` pytest processes of `path` at once: the
    number of SIGABRT deaths their logs report."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    bad = 0
    for r in range(runs):
        procs = [subprocess.Popen(
            [sys.executable, "-m", "pytest", path, "-q", "-p",
             "no:cacheprovider"], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for _ in range(loops)]
        for p in procs:
            log = p.communicate()[0]
            n = log.count("terminated with signal SIGABRT")
            bad += n
            print(f"round {r}: {log.strip().splitlines()[-1]}; "
                  f"SIGABRT {n}", flush=True)
    return bad


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--loops", type=int, default=6)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--variant", choices=["", "noauto", "nostage"],
                    default="")
    ap.add_argument("--torchrun", action="store_true")
    ap.add_argument("--pytest", default=None)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rank_of_torchrun", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_of_torchrun is not None:
        torchrun_rank(args.rank_of_torchrun)
        return
    if args.pytest:
        print(f"SIGABRT {pytest_rounds(args.pytest, args.loops, args.runs)}"
              f" in {args.loops * args.runs} runs of {args.pytest}")
        return
    if args.one:
        bad = (torchrun_loop(args.runs, args.port) if args.torchrun
               else spawn_loop(args.runs))
        print(f"ABORTS {bad} of {args.runs}", flush=True)
        return
    env = dict(os.environ, SPAWN_PROBE_VARIANT=args.variant)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--one", "--runs", str(args.runs),
         "--port", str(29500 + 11 * k)] + (["--torchrun"] if args.torchrun
                                           else []),
        env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL) for k in range(args.loops)]
    total = 0
    for p in procs:
        lines = p.communicate()[0].strip().splitlines()
        print("\n".join(lines), flush=True)
        total += int(lines[-1].split()[1])
    print(f"aborts: {total} in {args.loops * args.runs} "
          f"{'torchrun pairs' if args.torchrun else 'spawns'} "
          f"({time.time() - t0:.1f} s)")


if __name__ == "__main__":
    main()
