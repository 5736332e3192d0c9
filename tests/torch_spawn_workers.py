"""The rank functions of tests/test_torch_spawn.py.

`globalegomocap_tpu_torch.parallel.mesh.spawn` starts each rank as a
fresh process that imports its function by this module's path, so this
module imports only the port's mesh, torch and the standard library: a
rank starts in about as long as torch takes to import."""

from __future__ import annotations

import atexit
import json
import os
import signal
import time

import torch
import torch.distributed as dist

from globalegomocap_tpu_torch.parallel import mesh as pm


def _record_exit(path: str) -> None:
    """At interpreter exit: the time, whether a process group is still
    initialised and whether the mesh still holds a staging group."""
    with open(path, "w") as f:
        json.dump({"t": time.time(), "initialized": dist.is_initialized(),
                   "stage_group": pm._STAGE_GROUP != [None, None]}, f)


def uneven_exit(mesh, slow_rank: int, sleep_s: float, out_dir: str) -> dict:
    """all_reduce with its backward on the default group, all_reduce on
    the staging group and all_gather, then `slow_rank` sleeps `sleep_s`
    before it returns while the other returns at once.  An exit hook
    writes `exit<rank>.json` into `out_dir` (it holds the rank number,
    not the mesh, so that no process group is kept alive by it)."""
    atexit.register(_record_exit,
                    os.path.join(out_dir, f"exit{mesh.rank}.json"))
    x = torch.arange(3, dtype=torch.float32).mul(mesh.rank + 1)
    x.requires_grad_(True)
    s = pm.all_reduce(mesh, x)
    s.sum().backward()
    cover = pm.all_reduce(mesh.staging(), torch.ones(2))
    g = pm.all_gather(mesh, torch.full((1,), float(mesh.rank)))
    if mesh.rank == slow_rank:
        time.sleep(sleep_s)
    return {"rank": mesh.rank, "sum": s.detach().tolist(),
            "grad": x.grad.tolist(), "cover": cover.tolist(),
            "gather": g.tolist(), "t_return": time.time()}


def dies_by_signal(mesh, rank: int, after_result: bool) -> int:
    """`rank` kills itself with SIGABRT: at interpreter exit, after
    `spawn`'s rank has written its result and torn its groups down, or
    in place of returning one."""
    pm.all_reduce(mesh.staging(), torch.ones(1))
    if mesh.rank == rank:
        if not after_result:
            os.kill(os.getpid(), signal.SIGABRT)
        atexit.register(os.kill, os.getpid(), signal.SIGABRT)
    return mesh.rank
