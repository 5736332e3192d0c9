"""The benchmark's tests that need the card (marker `gpu`; they skip
without one): `python -m pytest egobench/tests -m gpu -q`.  The tiny
cells run through the port's CUDA kernels against the reference, and the
train cell's control (TF32, which has no effect on the CPU) has to come
out as not correct."""

import pytest
import torch

from egobench.harness.control import judged
from egobench.tests import tiny
from egobench.tests.test_egobench_reference import SOLVE, correct

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import globalegomocap_tpu_torch  # noqa: F401 - the precision policy
    return torch.device("cuda:0")


@pytest.mark.parametrize("workload", SOLVE + ["train-b2048"])
def test_tiny_cell_on_the_card(workload):
    dev = _card()
    _, parts, checks = tiny.run(torch, workload, 2 ** 31 + 301, device=dev)
    assert parts["failed"] == 0 and parts["peak"] > 0
    assert correct(checks), checks


def test_tf32_control_is_not_correct():
    dev = _card()
    loop, ctx = tiny.context(torch, "train-b2048", 2 ** 31 + 5, device=dev)
    got = loop.controls(torch, ctx)["tf32"]
    assert judged(got, ctx.limits)["correct"] is False, got
