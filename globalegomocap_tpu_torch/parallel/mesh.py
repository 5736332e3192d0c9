"""The process-group mesh and the sharding helpers.

Counterpart of `globalegomocap_tpu/parallel/mesh.py`.  The JAX package
scales over a 1-D device mesh with the axis 'dp': training shards the
batch axis (XLA inserting the gradient all-reduce), the solve shards the
chunk or the window axis.  The port runs one process a rank under
`torch.distributed`: NCCL over the cards (one process, one card, one
rank), gloo over processes on the CPU.  A `Mesh` records the group of
the ranks (None for a mesh of one rank), its backend, this rank, the
size and this rank's device.

A mesh of one rank changes nothing: every helper returns its input as it
is, pads nothing and makes no collective call.

Collectives route by `mesh.backend`, never by catching an error.  NCCL
takes tensors on the rank's card; a host tensor is copied there and
back.  gloo takes host tensors and, for the three collectives used here
(`all_reduce`, `broadcast`, `all_gather`), CUDA tensors too, which it
copies through the host itself (checked on torch 2.11 with CUDA 12.8:
two gloo ranks sharing one card), so a tensor goes to gloo where it
lies.

`spawn` starts the ranks of a group on one host with
`torch.multiprocessing.spawn`; `torchrun`'s environment (MASTER_ADDR,
RANK, WORLD_SIZE) serves as well, once the caller has initialised the
default group.

Two threads must not issue collectives on one group: nothing makes
their order the same on every rank, and ranks that pair one thread's
collective with the other's hang or mix tensors.  Staging (the
guard's coverage, summed over the ranks) runs on the serve prefetcher's
worker thread while the main thread gathers solves, so a mesh of several
ranks carries a second group over the same ranks, `stage_group`, made
once per default group by `make_mesh`; `Mesh.staging()` is the mesh on
it.  Each thread then owns one ordered channel.  The staging group is a
gloo group whatever the world's backend: its one collective sums two
host numbers, so it never touches a card, and under NCCL it is not a
second NCCL communicator used beside the first from another thread
(which NCCL warns can deadlock).  `broadcast_object` hands rank 0's
Python value (a directory listing, a retry decision) to every rank.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
import weakref
from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from globalegomocap_tpu_torch.device import resolve_device

@dataclass(frozen=True)
class Mesh:
    """The ranks of a 1-D mesh: `group` is the process group (None for a
    mesh of one rank), `backend` its backend ('nccl', 'gloo', or None
    without a group), `device` this rank's device."""
    group: Any
    backend: str | None
    rank: int
    size: int
    device: torch.device
    stage_group: Any = None

    def staging(self) -> "Mesh":
        """This mesh on its staging group (itself where it has none): the
        gloo group that staging's collectives take, on host tensors."""
        if self.stage_group is None:
            return self
        return replace(self, group=self.stage_group, backend="gloo")


# weak references to (default group, its staging group): one staging
# group a default group, however often make_mesh is called.  Weak, so
# that once the caller destroys the groups (under torchrun) and drops its
# meshes, nothing here keeps a process group alive into the
# interpreter's shutdown, where a gloo group freed while a peer still
# runs can abort the process.
_STAGE_GROUP: list = [None, None]


def _held(i: int):
    ref = _STAGE_GROUP[i]
    return None if ref is None else ref()


def _stage_group():
    """The gloo staging group of the default group, made at the first
    call on every rank (making a group is a collective step)."""
    world = dist.group.WORLD
    stage = _held(1)
    if _held(0) is not world or stage is None:
        stage = dist.new_group(list(range(dist.get_world_size())),
                               backend="gloo")
        _STAGE_GROUP[:] = [weakref.ref(world), weakref.ref(stage)]
    return stage


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh over the ranks of the default process group where one is
    initialised (by `spawn`, or by the caller under `torchrun`), else a
    mesh of one rank on `resolve_device(device)`.  This rank's device is
    `device`, or without it cuda:LOCAL_RANK under NCCL.  An `n_devices`
    other than the number of ranks raises ValueError (the JAX package's
    `make_mesh(n)` takes the first n devices, or all where fewer exist)."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        backend = str(dist.get_backend())
        if device is None and backend == "nccl":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
        group = dist.group.WORLD if size > 1 else None
    else:
        size, rank, backend, group = 1, 0, None, None
    if n_devices and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{size} rank(s); a mesh spans every rank")
    return Mesh(group, backend, rank, size, resolve_device(device),
                _stage_group() if size > 1 else None)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def shard_batch(mesh: Mesh, x, axis: int = 0):
    """This rank's equal slice of `x` (a numpy array or a tensor) along
    `axis`.  An axis the mesh size does not divide raises ValueError, as
    JAX's `device_put` onto P('dp') does."""
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"an axis of {n} does not divide into "
                         f"{mesh.size} equal shards")
    if mesh.size == 1:
        return x
    per = n // mesh.size
    if isinstance(x, np.ndarray):
        return np.take(x, np.arange(mesh.rank * per, (mesh.rank + 1) * per),
                       axis=axis)
    return x.narrow(axis, mesh.rank * per, per)


window_sharding = shard_batch   # the optimizer's window axis


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Edge-pad `axis` of `x` (a numpy array or a tensor) to a multiple of
    `multiple`: (padded, the original length).  `x` itself where nothing
    is missing."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, np.ndarray):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, rem)
        return np.pad(x, pad, mode="edge"), n
    last = x.narrow(axis, n - 1, 1)
    reps = [1] * x.dim()
    reps[axis] = rem
    return torch.cat([x, last.repeat(reps)], dim=axis), n


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _route(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor that the backend takes: a copy on the rank's card for a
    host `x` under NCCL, else `x` (contiguous)."""
    if mesh.backend == "nccl" and x.device.type != "cuda":
        return x.to(mesh.device)
    return x.contiguous()


def all_reduce(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable (the gradient of each
    rank's input is the sum of the ranks' upstream gradients, through
    `torch.distributed.nn.functional.all_reduce`); `x` itself on a mesh of
    one rank."""
    if mesh.size == 1:
        return x
    return dist_fn.all_reduce(_route(mesh, x), group=mesh.group).to(x.device)


def all_gather(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every rank's `x` concatenated along `axis` in rank order (JAX's
    tiled `all_gather`); every rank gets the same tensor.  Each rank's `x`
    has the same shape."""
    if mesh.size == 1:
        return x
    t = _route(mesh, x)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=axis).to(x.device)


def all_gather_fields(mesh: Mesh, fields) -> list:
    """Tensors with a common leading axis (a ChunkResult's or
    WindowFields' fields), gathered along it by one `all_gather` of a
    float32 buffer (bf16 fields widen and narrow back exactly)."""
    fields = list(fields)
    if mesh.size == 1:
        return fields
    lead = fields[0].shape[0]
    flat = [f.reshape(lead, -1) for f in fields]
    buf = all_gather(mesh, torch.cat([f.to(torch.float32) for f in flat],
                                     dim=1))
    out, at = [], 0
    for f, fl in zip(fields, flat):
        w = fl.shape[1]
        out.append(buf[:, at:at + w].to(f.dtype).reshape(
            (buf.shape[0],) + tuple(f.shape[1:])))
        at += w
    return out


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's `obj` (any picklable value) on every rank; `obj` itself
    on a mesh of one rank."""
    if mesh.size == 1:
        return obj
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(
        box, group=mesh.group, group_src=0,
        device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


def _broadcast(mesh: Mesh, x: torch.Tensor) -> None:
    t = _route(mesh, x)
    dist.broadcast(t, src=0, group=mesh.group)
    if t is not x:
        with torch.no_grad():
            x.copy_(t)


def replicate(mesh: Mesh, *objs):
    """Give every rank rank 0's values, in place: the parameters and
    buffers of a module, the state of an optimizer (its tensors, in the
    order of its parameters), or tensors.  Returns `objs`."""
    if mesh.size == 1:
        return objs
    for obj in objs:
        if isinstance(obj, torch.nn.Module):
            tensors = [*obj.parameters(), *obj.buffers()]
        elif isinstance(obj, torch.optim.Optimizer):
            tensors = [v for g in obj.param_groups for p in g["params"]
                       for _, v in sorted(obj.state.get(p, {}).items())
                       if isinstance(v, torch.Tensor)]
        else:
            tensors = list(obj) if isinstance(obj, (list, tuple)) else [obj]
        for t in tensors:
            _broadcast(mesh, t.data if isinstance(t, torch.nn.Parameter)
                       else t)
    return objs


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------

def spawn(fn: Callable, world: int, devices=None, backend: str | None = None,
          args: tuple = (), timeout_s: float | None = None,
          threads: int | None = None) -> list:
    """Run `fn(mesh, *args)` on `world` ranks, one process each
    (`torch.multiprocessing.spawn`), and return their results in rank
    order.  `devices`: one device a rank (default: cards
    cuda:0..world-1, through `resolve_device`; the CPU only where the
    caller lists it); `backend`: 'nccl' where every device is a card,
    else 'gloo', unless given.  The ranks meet at a FileStore in
    a temporary directory (no TCP port to choose) and tear the group
    down on every exit.  Each rank runs `threads` intra-op threads
    (default: this process's, split over the ranks, at least one).
    `fn` is pickled by its import path, and so are `args` and the
    results.  If a rank
    raises, rank 0's exception (else the lowest failing rank's) is raised
    here.  A rank that dies by a signal makes this raise too, and after
    its result was written the error names the teardown
    (`RankDiedInTeardown`).  `timeout_s` bounds each collective, the
    ranks' closing barrier and the whole run (the ranks still running
    then are terminated and TimeoutError raised); None leaves torch's
    collective timeout and no bound on the run."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(world)]
    # a card without an index is card 0
    devices = [str(torch.device("cuda", 0) if str(d) == "cuda" else d)
               for d in map(resolve_device, devices)]
    if backend is None:
        backend = ("nccl" if all(torch.device(d).type == "cuda"
                                 for d in devices) else "gloo")
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if threads is None:
        threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        ctx = torch.multiprocessing.spawn(
            _rank_main, args=(fn, world, devices, backend, tuple(args), tmp,
                              timeout_s, threads), nprocs=world, join=False)
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout_s} s")
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            for r in range(world):
                path = os.path.join(tmp, f"error{r}.pkl")
                if os.path.exists(path):
                    raise _load(path) from e
            if (isinstance(e, torch.multiprocessing.ProcessExitedException)
                    and e.signal_name and os.path.exists(
                        os.path.join(tmp, f"done{e.error_index}"))):
                raise RankDiedInTeardown(
                    f"rank {e.error_index} died ({e.signal_name}) after "
                    "writing its result, in teardown") from e
            raise
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        return [_load(os.path.join(tmp, f"result{r}.pkl"))
                for r in range(world)]


class RankDiedInTeardown(RuntimeError):
    """A rank of `spawn` died by a signal after writing its result."""


def _load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _rank_main(rank: int, fn, world: int, devices: list, backend: str,
               args: tuple, tmp: str, timeout_s: float,
               threads: int) -> None:
    """One rank of `spawn`: the group, `fn`, its result or exception, and
    the teardown.  After a result the ranks leave in step: the result
    written, a `done` marker, a barrier on the default group (bounded by
    the group's timeout, `timeout_s`), then the staging group destroyed,
    the default group destroyed and `_STAGE_GROUP` cleared, so that no
    process group is alive when the interpreter shuts down.  After an
    exception no barrier is taken: the peer may wait in a collective that
    never ends, and `spawn` terminates it."""
    torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=None if timeout_s is None
        else datetime.timedelta(seconds=timeout_s))
    try:
        _dump(fn(make_mesh(world, device=device), *args),
              os.path.join(tmp, f"result{rank}.pkl"))
    except BaseException as e:
        try:
            blob = pickle.dumps(e)
        except Exception:  # noqa: BLE001 - an exception that cannot pickle
            blob = pickle.dumps(RuntimeError(
                f"rank {rank}: " + traceback.format_exc()))
        with open(os.path.join(tmp, f"error{rank}.pkl"), "wb") as f:
            f.write(blob)
        _teardown()
        raise
    open(os.path.join(tmp, f"done{rank}"), "w").close()
    dist.barrier(device_ids=[device.index] if backend == "nccl" else None)
    _teardown()


def _teardown() -> None:
    """Destroy the staging group this process made, then the default
    group, then forget the staging group."""
    stage = _held(1)
    if stage is not None and _held(0) is dist.group.WORLD:
        dist.destroy_process_group(stage)
    dist.destroy_process_group()
    _STAGE_GROUP[:] = [None, None]
