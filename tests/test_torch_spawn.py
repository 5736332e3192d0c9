"""How the ranks of `parallel/mesh.py::spawn` leave: two gloo ranks on
the CPU use the default and the staging group and finish at different
times (either rank the slow one).

On the tree before the ordered teardown a rank that returned first
could abort at interpreter exit ("terminate called without an active
exception", SIGABRT) while its peer was still running, a few spawns in
a hundred when several ran side by side (`tests/torch_spawn_probe.py`
counts them).  Too rare to catch in a few spawns, so each spawn here must return both results and no
`ProcessExitedException`, and each rank's exit hook must see that it
left in step with its peer (the fast rank exits after the slow rank's
function returned: the closing barrier) with no process group left
(the staging group destroyed and forgotten, the default group
destroyed).  A rank that dies by a signal after writing its result
still makes `spawn` raise, naming the teardown; one that dies before
raises torch's `ProcessExitedException`.  Under a default group the
caller made (as `torchrun`'s) the port destroys nothing, and holds its
staging group only weakly, so the caller's teardown frees it."""

import json
import weakref

import pytest
import torch
import torch.distributed as dist

from globalegomocap_tpu_torch.parallel import mesh as pm
from tests import torch_spawn_workers as workers

UNEVEN = [(0, 0.5), (1, 0.5), (0, 1.0), (1, 1.0), (1, 0.25)]


@pytest.mark.parametrize("slow_rank,sleep_s", UNEVEN,
                         ids=[f"slow{r}-{s}s" for r, s in UNEVEN])
def test_ranks_leave_in_step_with_no_group_alive(tmp_path, slow_rank,
                                                  sleep_s):
    out = pm.spawn(workers.uneven_exit, 2, ["cpu"] * 2, timeout_s=60,
                   threads=1, args=(slow_rank, sleep_s, str(tmp_path)))
    assert [r["rank"] for r in out] == [0, 1]
    for r in out:
        assert r["sum"] == [0.0, 3.0, 6.0] and r["grad"] == [2.0, 2.0, 2.0]
        assert r["cover"] == [2.0, 2.0] and r["gather"] == [0.0, 1.0]
    exits = [json.loads((tmp_path / f"exit{r}.json").read_text())
             for r in range(2)]
    for e in exits:
        assert not e["initialized"] and not e["stage_group"], e
    fast = 1 - slow_rank
    assert exits[fast]["t"] >= out[slow_rank]["t_return"], (exits, out)


def test_a_rank_killed_after_its_result_raises_naming_the_teardown():
    with pytest.raises(pm.RankDiedInTeardown,
                       match=r"rank 1 died \(SIGABRT\) after writing its "
                             r"result, in teardown"):
        pm.spawn(workers.dies_by_signal, 2, ["cpu"] * 2, timeout_s=60,
                 threads=1, args=(1, True))


def test_a_rank_killed_before_its_result_raises():
    with pytest.raises(torch.multiprocessing.ProcessExitedException,
                       match="SIGABRT") as info:
        pm.spawn(workers.dies_by_signal, 2, ["cpu"] * 2, timeout_s=60,
                 threads=1, args=(0, False))
    assert not isinstance(info.value, pm.RankDiedInTeardown)


def test_under_a_callers_group_the_staging_group_is_held_weakly(tmp_path):
    """The staging group is made once for the caller's default group (a
    gloo group of one rank here); once the caller destroys its groups and
    drops its references, nothing of the port keeps it alive."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        stage = pm._stage_group()
        assert pm._stage_group() is stage
        ref = weakref.ref(stage)
        del stage
    finally:
        dist.destroy_process_group()
    assert ref() is None and pm._held(1) is None
