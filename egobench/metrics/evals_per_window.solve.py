"""Objective evaluations a window solved: the program's counter
`solve.evals` (lanes x points of each objective call, both stages)
summed under a request's id, over the request's windows."""

from egobench.harness import program_spans


def read(run):
    e = program_spans.per_request(run, "solve.evals")
    if e is None:
        return None
    return e / run.facts["windows_per_request"]
