"""A solve cell (mix kind `solve_closed_loop`): whole capture sequences
in a closed loop through the port's streaming runtime.

The window drives `StreamingOptimizer.submit_batch(staged, mode="flat")`
fed by a `StagePrefetcher` over the harness's source of requests, at the
configuration's frozen solver stack and runtime settings.  A request is
a list of chunks from the run's pool in an order drawn from the seed; it
is pulled by the prefetcher's worker, staged there and submitted by the
main thread, which then records an event on its stream; a thread of the
harness waits for that event.  A request's latency runs from the pull to
the event, which follows its merged poses.  The results come back in
submission order from the runtime's own `drain()` once the window has
closed, and a request whose poses are not finite counts as failed.

Host spans, all the benchmark's own: `stage` around each
`SequenceOptimizer.stage` call (the prefetcher's worker), `dispatch`
around each `optimize_chunks_batched` call (the enqueue of a solve,
after `submit_batch` has waited for a slot).

After the window: the peak device memory is read, the program's state is
freed, and the plain reference (`egobench/reference/solve.py`) solves a
sample of the finished requests drawn from the seed; the program's
staging (crops, origins, the guard) must equal the reference's and its
poses must lie within the cell's limits of the reference's.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time

import numpy as np

from egobench.counts import flops
from egobench.harness import common, traffic
from egobench.harness.common import Run
from egobench.harness.weights import draw_state, prior_seeds
from egobench.reference import solve as ref


def optimize_config(o: dict):
    """The program's OptimizeConfig from a configuration's frozen dict."""
    from globalegomocap_tpu_torch.config import (
        EnergyConfig, HeatmapGeometry, OptimizeConfig, PriorConfig,
        SolverConfig, WindowConfig)
    rest = {k: v for k, v in o.items()
            if k not in ("window", "solver", "energy", "prior", "heatmap")}
    return OptimizeConfig(
        window=WindowConfig(**o["window"]),
        solver=SolverConfig(**dict(o["solver"], step_candidates=tuple(
            o["solver"]["step_candidates"]))),
        energy=EnergyConfig(**o["energy"]),
        prior=PriorConfig(**dict(o["prior"], hidden_dims=tuple(
            o["prior"]["hidden_dims"]))),
        heatmap=HeatmapGeometry(**o["heatmap"]), **rest)


class Collector:
    """Times each request's completion: waits on an event recorded after
    its submission, on a thread of the harness, and records the time."""

    def __init__(self):
        self.q: queue.Queue = queue.Queue()
        self.done: dict = {}        # rid -> completion time
        self.error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while True:
                item = self.q.get()
                if item is None:
                    return
                rid, event = item
                if event is not None:
                    event.synchronize()
                self.done[rid] = time.perf_counter()
        except BaseException as e:  # noqa: BLE001 - re-raised by close()
            self.error = e

    def close(self):
        self.q.put(None)
        self._thread.join()
        if self.error is not None:
            raise self.error


def check_ids(mix: dict, seed: int) -> set:
    """The requests a run checks: the first (its staging resolves the
    guard for the stream) and `check_requests` drawn from the seed among
    the `check_from` that follow the warm-up, which every run finishes
    inside its window."""
    warm = int(mix["warmup_requests"])
    rng = np.random.default_rng([int(seed), 3])
    return {0} | {int(x) for x in rng.choice(
        np.arange(warm, warm + int(mix["check_from"])),
        int(mix["check_requests"]), replace=False)}


# the program's own paths below the configuration's bfloat16_delta: the
# control, the output decodes in bfloat16 (the step below), and beside it
# everything in bfloat16 (PERF.md)
PROGRAM_CONTROLS = {"bfloat16_f32enc": {"compute_dtype": "bfloat16_f32enc"},
                    "bfloat16_pure": {"compute_dtype": "bfloat16_pure"}}


def run(torch, ctx) -> tuple:
    """One run of a solve cell: (run record, result parts, checks).
    `ctx` is `common.context(...)`; `ctx.program` overrides options of
    the program's solver configuration (a control), never the
    reference's."""
    from globalegomocap_tpu_torch.data.test_data import TestChunk
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model)
    from globalegomocap_tpu_torch.optimize.pipeline import check_supported
    from globalegomocap_tpu_torch.optimize.streaming import (
        StagePrefetcher, StreamingOptimizer)
    from egobench.harness.trace import Tracer

    cfg, mix, seed, device = ctx.cfg, ctx.mix, ctx.seed, ctx.device
    cuda = device.type == "cuda"
    rt = cfg["runtime"]
    ocfg = optimize_config(dict(cfg["optimize"], **ctx.program))
    check_supported(ocfg)
    rec = Run()
    spans = rec.spans

    # set-up: the weights on the device, the pool on the host, the program
    seeds = prior_seeds(seed)
    prior = cfg["optimize"]["prior"]
    states = [draw_state(torch, prior, s, device) for s in seeds]
    common.mark(ctx, "weights")
    pool = traffic.solve_pool(mix, cfg["camera"], seed)
    chunks = [TestChunk(**c) for c in pool]
    common.mark(ctx, "pool")
    opt = SequenceOptimizer(build_model(ocfg), states[0], states[1], ocfg,
                            device=device)
    # the harness's spans around two public methods of the optimizer; a
    # runtime that stops calling them leaves their metrics silent
    opt.stage = spans.wrap("stage", opt.stage)
    opt.optimize_chunks_batched = spans.wrap("dispatch",
                                             opt.optimize_chunks_batched)
    service = StreamingOptimizer(opt, max_in_flight=rt["max_in_flight"],
                                 guard=rt["guard"],
                                 stage_on_host=rt["stage_on_host"])
    common.mark(ctx, "program")
    warm = int(mix["warmup_requests"])
    keep = check_ids(mix, seed)
    kept_staged: dict = {}
    collector = Collector()
    pulls: dict = {}
    stop = threading.Event()

    def source():
        rid = 0
        while not stop.is_set():
            order = traffic.request_order(mix, seed, rid)
            pulls[rid] = time.perf_counter()
            yield [chunks[i] for i in order]
            rid += 1

    prefetcher = StagePrefetcher(opt, source(), depth=rt["prefetch_depth"],
                                 on_host=rt["stage_on_host"],
                                 guard=rt["guard"])
    tracer = (Tracer(torch, float(mix["trace_seconds"]),
                     float(mix["trace_lead_seconds"]))
              if ctx.trace and cuda else None)
    t_start = t_end = None
    submitted = 0
    # host annotations name what the dispatching thread waits on in a
    # trace's idle gaps
    note = torch.profiler.record_function
    staged_batches = iter(prefetcher)
    try:
        for rid in itertools.count():
            with note("egobench.wait_for_staging"):
                staged = next(staged_batches, None)
            if staged is None:
                break
            if stop.is_set():
                continue                 # the window has closed: drain
            with note("egobench.submit"):
                service.submit_batch(staged, mode=rt["mode"])
            submitted += 1
            event = None
            if cuda:
                # after the solve's work on this stream; a blocking event,
                # so that the collector's wait sleeps, not spins
                event = torch.cuda.Event(blocking=True)
                event.record()
            if rid in keep:
                kept_staged[rid] = staged
            collector.q.put((rid, event))
            now = time.perf_counter()
            if t_start is None and len(collector.done) >= warm:
                t_start = now
                t_end = t_start + ctx.seconds
                common.mark(ctx, "warm-up")
            if tracer is not None and t_start is not None:
                tracer.due(now, t_end)
            if t_end is not None and now >= t_end:
                stop.set()
                if tracer is not None and tracer.started:
                    tracer.end()
        # every result, in submission order, through the runtime's own
        # drain
        results = service.drain()
    finally:
        stop.set()
        collector.close()
    if len(results) != submitted:
        raise RuntimeError(f"the runtime drained {len(results)} results "
                           f"of {submitted} submissions")
    if tracer is not None and tracer.span is not None:
        rec.trace = tracer.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the window's requests: completed in (t_start, t_end]; the host's
    # per-layer readings end where the profiler starts
    done = collector.done
    t_end = min(t_end, max(done.values())) if t_end is not None \
        else max(done.values())
    in_win = [r for r, t in done.items() if t_start < t <= t_end]
    ok = [r for r in in_win
          if bool(torch.isfinite(results[r].optimized).all())]
    lat = sorted(1e3 * (done[r] - pulls[r]) for r in ok)
    span = t_end - t_start
    per_req = ((mix["frames_per_chunk"] - ocfg.window.seq_len)
               // ocfg.window.stride + 1) * int(mix["chunks_per_request"])
    wps = per_req * len(ok) / span
    host_end = tracer.began if tracer is not None and tracer.started \
        else t_end
    untraced = [r for r in ok if done[r] <= host_end]
    bins = np.histogram([done[r] - t_start for r in ok],
                        bins=np.arange(0.0, span + 5.0, 5.0))[0]
    # float32 holds every answer exactly, at the tiers that give bfloat16
    kept = {rid: {"optimized": results[rid].optimized.float().cpu().numpy(),
                  "mid_local": results[rid].mid_local.float().cpu(),
                  "crops": kept_staged[rid].heat.cpu(),
                  "origins": kept_staged[rid].origins.cpu(),
                  "coverage": kept_staged[rid].crop_coverage}
            for rid in sorted(kept_staged)}
    coverage = kept[0]["coverage"]
    robust = (coverage is not None
              and coverage < cfg["optimize"]["heatmap_crop_min_mass"])
    s1, s2 = ref.solver_of(cfg["optimize"], robust)
    rec.window = (t_start, host_end)
    rec.facts = {
        "windows_per_request": per_req,
        "windows_per_s": per_req * len(untraced) / (host_end - t_start),
        "latency_ms": sorted(1e3 * (done[r] - pulls[r]) for r in untraced),
        "stage1": s1, "stage2": s2,
        "k": cfg["optimize"]["guard_crop"] if robust
        else cfg["optimize"]["heatmap_crop"],
        "crop_bytes": 2 if cfg["optimize"]["heatmap_dtype"] == "bfloat16"
        else 4, "seq_len": ocfg.window.seq_len,
        "flops_per_window": flops.solve_flops_per_window(prior, s1, s2)}
    print(f"egobench: {len(in_win)} requests in {span:.3f} s, "
          f"{len(in_win) - len(ok)} failed; latency median "
          f"{np.median(lat) if lat else float('nan'):.3f} ms; guard "
          f"coverage {coverage!r} robust {robust}; completed a 5 s "
          f"bin {bins.tolist()}", flush=True)

    # the program's state goes before the reference runs
    del service, prefetcher, opt, states, results, kept_staged
    if cuda:
        torch.cuda.empty_cache()
    checks = check(torch, ctx, pool, kept, seed, device)
    metrics = {"windows_per_s": wps, "setup_s": t_start - ctx.t0}
    return rec, {"attempted": len(in_win), "failed": len(in_win) - len(ok),
                 "metrics": metrics, "peak": peak}, checks


def controls(torch, ctx) -> dict:
    """The reference's own control: the reference put in the program's
    place with the objective's decodes one precision below the
    configuration's bfloat16, in float8, against the reference over the
    requests a run of `ctx.seed` checks; {"float8_evals": numbers}."""
    cfg, mix, seed, device = ctx.cfg, ctx.mix, ctx.seed, ctx.device
    pool = traffic.solve_pool(mix, cfg["camera"], seed)
    states = [draw_state(torch, cfg["optimize"]["prior"], s, device)
              for s in prior_seeds(seed)]
    worst = dict.fromkeys(COMPARED[1:], 0.0)
    first = None
    for rid in sorted(check_ids(mix, seed)):
        chunks = [pool[i] for i in traffic.request_order(mix, seed, rid)]
        staged = ref.stage_request(chunks, cfg["optimize"], cfg["camera"],
                                   coverage=first)
        first = staged["coverage"] if first is None else first
        want, got, still = (
            ref.solve_request(chunks, staged, *states, o, cfg["camera"],
                              device, eval_dtype=dt)
            for o, dt in ((cfg["optimize"], "bf16"),
                          (cfg["optimize"], "fp8"),
                          (ref.unchanged(cfg["optimize"]), "bf16")))
        gaps = pose_gaps(got, want, still)
        for k in worst:
            worst[k] = max(worst[k], gaps[k])
    return {"float8_evals": worst}


def check(torch, ctx, pool, kept, seed, device) -> dict:
    """The sampled requests against the plain reference: each number
    with its limit (ctx.limits), the worst over the sample."""
    cfg = ctx.cfg
    states = [draw_state(torch, cfg["optimize"]["prior"], s, device)
              for s in prior_seeds(seed)]
    bar = cfg["optimize"]["heatmap_crop_min_mass"]
    first = None
    worst = dict.fromkeys(COMPARED, 0.0)
    for rid in sorted(kept):
        got = kept[rid]
        chunks = [pool[i] for i in traffic.request_order(ctx.mix, seed, rid)]
        staged = ref.stage_request(chunks, cfg["optimize"], cfg["camera"],
                                   coverage=first)
        # the guard's decision, resolved on the first request
        mismatch = int((got["coverage"] < bar) != staged["tripped"])
        first = staged["coverage"] if first is None else first
        for key in ("crops", "origins"):
            a, b = got[key], staged[key]
            mismatch += int((a != b).sum()) if a.shape == b.shape \
                else a.numel()
        want, still = (ref.solve_request(chunks, staged, states[0],
                                         states[1], o, cfg["camera"],
                                         device)
                       for o in (cfg["optimize"],
                                 ref.unchanged(cfg["optimize"])))
        gaps = pose_gaps(got, want, still)
        print(f"egobench: request {rid} against the reference: staging "
              f"mismatches {mismatch}, " + ", ".join(
                  f"{k} {v!r}" for k, v in gaps.items()), flush=True)
        worst["staging_mismatch"] = max(worst["staging_mismatch"], mismatch)
        for k in COMPARED[1:]:
            worst[k] = max(worst[k], gaps[k])
    return {k: {"value": float(v), "limit": ctx.limits[k]}
            for k, v in worst.items()}


# the numbers compared, each with a limit in egobench/limits/<cell>.json
COMPARED = ("staging_mismatch", "progress_gap", "chunk_median_gap_m",
            "median_frame_gap_m")
OFF_M = 0.01


def frame_gaps(a, b) -> np.ndarray:
    """Each frame's worst joint distance (C, frames) between two merged
    pose fields (C, frames, 15, 3); inf where `a` is not finite or not of
    `b`'s shape."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        return np.full(b.shape[:2], np.inf)
    return np.linalg.norm(a - b, axis=-1).max(-1)


def pose_gaps(got: dict, want: dict, still: dict) -> dict:
    """A request's merged final poses against the reference's, measured
    against how far the reference's solve moved them from where its
    state started (`still`, the answer of a solve whose state is left
    unchanged): the sum over frames of each frame's worst joint distance
    to the reference over the sum of the reference's own such moves
    ('progress_gap': 0 is the reference's answer, 1 the unchanged
    state's), the largest over the chunks of a chunk's median frame
    gap (metres; 'chunk_median_gap_m': one chunk's answer gone wrong),
    and the median frame gap over the request (metres;
    'median_frame_gap_m': every answer a little off, as a lower
    precision leaves it).
    Beside them, for the log: the share of frames more than OFF_M off
    (final and stage-1 poses), the 99th percentile and the largest frame
    gap, and the reference's mean move."""
    gap = frame_gaps(got["optimized"], want["optimized"].numpy())
    move = frame_gaps(still["optimized"].numpy(), want["optimized"].numpy())
    return {
        "progress_gap": float(gap.sum() / max(move.sum(), 1e-12)),
        "chunk_median_gap_m": float(np.median(gap, 1).max()),
        "median_frame_gap_m": float(np.median(gap)),
        "frames_off_share": float((gap > OFF_M).mean()),
        "mid_frames_off_share": float((frame_gaps(
            got["mid_local"], want["mid_local"].numpy()) > OFF_M).mean()),
        "p99_m": float(np.quantile(gap, 0.99)),
        "max_m": float(gap.max()),
        "mean_move_m": float(move.mean())}
