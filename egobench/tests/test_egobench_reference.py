"""The plain reference against the port at a size the CPU holds, the
controls that have to come out as not correct, and the run with the
timed path broken underneath, which has to come out as not correct."""

import pytest
import torch

from egobench.harness import common
from egobench.harness.control import judged
from egobench.tests import tiny

SOLVE = ["solve-seq32-clean"]


def correct(checks) -> bool:
    return common.correct(checks)


@pytest.mark.parametrize("workload", SOLVE + ["train-b2048"])
def test_reference_agrees_with_the_port(workload):
    _, parts, checks = tiny.run(torch, workload, 2 ** 31 + 101)
    assert parts["failed"] == 0 and parts["attempted"] > 0
    assert correct(checks), checks


@pytest.mark.parametrize("workload", SOLVE)
def test_float8_control_is_not_correct(workload):
    loop, ctx = tiny.context(torch, workload, 2 ** 31 + 7)
    got = loop.controls(torch, ctx)["float8_evals"]
    assert judged(got, ctx.limits)["correct"] is False, got


PROGRAM_CONTROLS = [(w, name) for w in SOLVE + ["train-b2048"]
                    for name in tiny.context(torch, w, 0)[0].PROGRAM_CONTROLS]


@pytest.mark.parametrize("workload,name", PROGRAM_CONTROLS,
                         ids=[f"{w}-{n}" for w, n in PROGRAM_CONTROLS])
def test_programs_lower_precision_is_not_correct(workload, name):
    """The program's own path below the configuration's precision, run
    through the cell's loop and check."""
    loop = tiny.context(torch, workload, 0)[0]
    _, _, checks = tiny.run(torch, workload, 2 ** 31 + 9,
                            program=loop.PROGRAM_CONTROLS[name])
    assert not correct(checks), checks


def _unchanged(monkeypatch, workload):
    if workload == "train-b2048":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
        return
    from globalegomocap_tpu_torch.optimize import lbfgs, pipeline

    def still(vg, x0, **kw):
        return lbfgs.LBFGSResult(x=x0, f=None, grad_norm=None, n_iter=0,
                                 n_evals=0, n_calls=0)
    monkeypatch.setattr(pipeline, "lbfgs_minimize_fixed_batched", still)


def _half_batch(monkeypatch, workload):
    if workload == "train-b2048":
        from globalegomocap_tpu_torch.train.train_vae import Trainer
        orig = Trainer._device_batch
        monkeypatch.setattr(Trainer, "_device_batch",
                            lambda self, b, axis=0: orig(
                                self, b[:len(b) // 2], axis))
        return
    from globalegomocap_tpu_torch.optimize import pipeline
    orig = pipeline.optimize_chunks_flat

    def half(local, glob, est, cams, heat, gt, camera, cfg, origins=None,
             full_hw=None, **kw):
        n = est.shape[0] // 2 or 1
        res = orig(local, glob, est[:n], cams[:n], heat[:n], gt[:n],
                   camera, cfg, origins=origins[:n], full_hw=full_hw, **kw)
        rest = est.shape[0] - n
        return pipeline.ChunkResult(*(torch.cat(
            [f, f.mean(0, keepdim=True).expand((rest,) + f.shape[1:])])
            for f in res))
    monkeypatch.setattr(pipeline, "optimize_chunks_flat", half)


def _altered(monkeypatch, workload):
    from globalegomocap_tpu_torch.optimize import pipeline
    orig = pipeline.optimize_chunks_flat

    def altered(*a, **kw):
        res = orig(*a, **kw)
        moved = res.optimized.clone()
        moved[0] += 0.05                  # one chunk's answer, 5 cm off
        return res._replace(optimized=moved)
    monkeypatch.setattr(pipeline, "optimize_chunks_flat", altered)


FAULTS = [(w, f) for w in SOLVE + ["train-b2048"]
          for f in (_unchanged, _half_batch)] + \
    [(w, _altered) for w in SOLVE]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch, workload)
    _, _, checks = tiny.run(torch, workload, 2 ** 31 + 203)
    assert not correct(checks), checks
