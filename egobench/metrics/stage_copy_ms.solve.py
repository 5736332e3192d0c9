"""Host time (ms) a request spends in the program's `stage.copy` spans:
the pinning and host-to-device copies of the maps and of the fields
inside `SequenceOptimizer.stage` (on the prefetcher's worker), over the
requests staged inside the window, as `stage_ms.solve` counts them."""

from egobench.harness import program_spans


def read(run):
    s = program_spans.per_request(run, "stage.copy", "stage")
    return None if s is None else 1e3 * s
