"""The harness: names found in BENCHMARK.json and their files, the
traffic drawn from the seed, the frozen counts, the import guard and the
result line."""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from egobench.counts import flops
from egobench.harness import common, synthetic, traffic
from egobench.harness.main import result_line
from egobench.tests import tiny

BENCH = common.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell, cfg, mix = common.cell_files(BENCH, workload)
    assert cfg["name"] == cell["config"]
    loop = common.loop(mix["kind"])
    assert callable(loop.run) and callable(loop.controls)
    assert isinstance(loop.PROGRAM_CONTROLS, dict)
    limits = common.limits(workload)
    assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_reader_found_by_name(name):
    assert callable(common.metric_reader(name))


def test_unknown_names_refused():
    with pytest.raises(KeyError):
        common.cell_files(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        common.metric_reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        common.loop("no_such_kind")
    bad = dict(BENCH, workloads=[dict(BENCH["workloads"][0],
                                      config="no-such-config")])
    with pytest.raises(KeyError):
        common.cell_files(bad, BENCH["workloads"][0]["name"])


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for entry in BENCH["configs"] + BENCH["workloads"] + \
            BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert len(entry.get("why", "x")) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", CELLS), (m["name"], w)
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(common.ROOT, c["file"]))


def _pool(workload, seed):
    _, cfg, mix, _ = tiny.cell(workload)
    return traffic.solve_pool(mix, cfg["camera"], seed), mix


@pytest.mark.parametrize("workload", ["solve-seq32-clean"])
def test_solve_mix_follows_the_seed(workload):
    a, mix = _pool(workload, 2 ** 31 + 11)
    b, _ = _pool(workload, 2 ** 31 + 11)
    c, _ = _pool(workload, 2 ** 31 + 12)
    for x, y, z in zip(a, b, c):
        for key in x:
            assert np.array_equal(x[key], y[key])
        assert not np.array_equal(x["heatmaps"], z["heatmaps"])
    assert np.array_equal(traffic.request_order(mix, 5, 3),
                          traffic.request_order(mix, 5, 3))
    full = common.load_json(os.path.join(
        common.BENCH, "traffic", tiny.cell(workload)[0]["traffic"] + ".json"))
    orders = {tuple(traffic.request_order(full, 5, r)) for r in range(4)}
    assert len(orders) == 4            # a new order each request


def test_train_mix_follows_the_seed():
    _, _, mix, _ = tiny.cell("train-b2048")
    a = traffic.training_corpus(mix, 7)
    assert np.array_equal(a, traffic.training_corpus(mix, 7))
    assert not np.array_equal(a, traffic.training_corpus(mix, 8))
    assert a.shape == (3 * (40 - 10), 10, 45) and a.dtype == np.float32


def test_frozen_chunks_equal_the_programs():
    """The frozen generators make the chunks the program's make."""
    from globalegomocap_tpu_torch.data import synthetic as prog
    cam = common.cell_files(BENCH, "solve-seq32-clean")[1]["camera"]
    cases = [
        (synthetic.synthetic_chunk(cam, 20, 9), prog.synthetic_chunk(20, 9)),
        (synthetic.synthetic_chunk(cam, 20, 9, cam_noise={}, degrade={},
                                   motion_scale=0.10,
                                   freq_range=(0.5, 2.5)),
         prog.synthetic_chunk_v2(20, 9)),
        (synthetic.synthetic_chunk(
            cam, 20, 9, contacts={}, dropout={},
            cam_noise={"drift_rot": 0.0, "drift_trans": 0.0,
                       "jitter_rot": 0.008, "jitter_trans": 0.008}),
         prog.synthetic_chunk_v3(20, 9))]
    for mine, theirs in cases:
        for key in mine:
            np.testing.assert_array_equal(mine[key], getattr(theirs, key))


def test_training_windows_equal_the_programs():
    from globalegomocap_tpu_torch.data import amass
    from globalegomocap_tpu_torch.data import synthetic as prog
    want = amass.window_sequences(prog.synthetic_amass(2, 30, seed=4))
    got = synthetic.training_windows(2, 30, 4)
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_counts_by_hand():
    prior = {"in_channels": 45, "latent_dim": 8, "seq_len": 10,
             "hidden_dims": [4, 4]}
    # decoder_input 2*8*40, ConvT 4->4, ConvT 4->4, Conv 4->45 (k=3, T=10)
    assert flops.decoder_flops(prior) == 640 + 960 + 960 + 10800
    # Conv 45->4, Conv 4->4, fc_mu and fc_var 40->8
    assert flops.encoder_flops(prior) == 10800 + 960 + 2 * 640
    # kernel 1, one probe row of 2 windows, k=8 bf16 crops: pose in,
    # g out, e out; anchor, bone, ox, oy; 4 taps a point
    nbytes = 2 * (150 * 3 * 4 * 2 + 4) + 2 * 6 * 150 * 4 + 2 * 150 * 4 * 2
    assert flops.energy_least_seconds(1, 2, 10, 8, 2, True) == \
        nbytes / 3.35e12
    one = {"iters": 2, "candidates": (1.0, 0.1)}
    assert flops.solve_flops_per_window(prior, one, one) == \
        2 * flops.encoder_flops(prior) + 10 * 2 * \
        flops.decoder_flops(prior) + 3 * flops.decoder_flops(prior)


def test_train_count_matches_the_modules():
    """chip_smoke.py's step_bound count, from the modules themselves."""
    from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
    prior = tiny.TINY_PRIOR
    model = ConvVAE(45, 45, prior["latent_dim"], prior["seq_len"],
                    tuple(prior["hidden_dims"]))
    fwd = 0
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            fwd += 2 * 16 * prior["seq_len"] * mod.weight.numel()
        elif isinstance(mod, torch.nn.Linear):
            fwd += 2 * 16 * mod.weight.numel()
    assert flops.train_step_flops(prior, 16) == 3 * fwd


def test_import_guard_compares_whole_names():
    assert common.forbidden_modules(
        ["globalegomocap_tpu_torch.ops", "numpy", "jaxtyping"]) == []
    assert common.forbidden_modules(
        ["globalegomocap_tpu.ops", "jax.numpy", "flax", "optax.x",
         "orbax.checkpoint", "jaxlib"]) == [
        "flax", "globalegomocap_tpu", "jax", "jaxlib", "optax", "orbax"]


def _python(code, cwd=common.ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_harness_imports_no_jax():
    out = _python(
        "import sys; sys.path.insert(0, '.');"
        "import egobench.harness.main, egobench.loops.solve_closed_loop, "
        "egobench.loops.train_steps, egobench.harness.control;"
        "from egobench.harness import common;"
        "import globalegomocap_tpu_torch.optimize.streaming, "
        "globalegomocap_tpu_torch.train.train_vae;"
        "print(common.forbidden_modules())")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    out = _python(
        "import sys; sys.path.insert(0, '.');"
        "import egobench.reference.solve, egobench.reference.train;"
        "print(sorted({m.split('.')[0] for m in sys.modules "
        "if m.startswith('globalegomocap')}))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "egobench/run.py", "--workload",
         "solve-seq32-clean", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=common.ROOT, capture_output=True, text=True,
        timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.BENCH, tmp_path / "egobench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run(
        [sys.executable, "egobench/run.py", "--workload",
         "solve-seq32-clean", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_result_line_keys(capsys):
    rec, parts, checks = tiny.run(torch, "solve-seq32-clean", 2 ** 31 + 21)
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": 1}
    e2e = common.cell_metrics(BENCH, "solve-seq32-clean", False)
    line = result_line(e2e, {}, rec, parts, checks, dict(device))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device"]
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    common.emit(line, checks)
    out, err = capsys.readouterr()
    printed = json.loads(out.strip().splitlines()[-1])
    assert list(printed)[-1] == "checks" and printed["correct"] is True
    assert err.strip().splitlines()[-1].startswith("check ")
    # a traced run: the per-layer metrics its readers find, the breakdown
    rec.trace = {"busy_s": 0.5, "window_s": 2.0, "kernels": {},
                 "device_ops": [["k", 0.5]], "idle_gaps": [["g", 1.5]]}
    per = common.cell_metrics(BENCH, "solve-seq32-clean", True)
    readers = {m["name"]: common.metric_reader(m["name"]) for m in per}
    line = result_line(per, readers, rec, parts, checks, dict(device))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown"]
    assert line["metrics"]["idle_share.solve"]["value"] == 75.0
    assert "fused_stage_energy_roofline" not in line["metrics"]
    assert line["device"]["busy_s"] == 0.5


def test_trace_reader_bounds_and_gaps():
    from egobench.harness.trace import Tracer, read
    ev = [  # ts and dur in microseconds, as the profiler writes them
        {"ph": "X", "cat": "user_annotation", "name": Tracer.START,
         "ts": 100, "dur": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 101, "dur": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "fused_energy_kernel<true, x>",
         "ts": 90, "dur": 20, "tid": 7},          # clipped to 100..110
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 150, "dur": 50,
         "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 120,
         "dur": 20, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": Tracer.END,
         "ts": 299, "dur": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k3", "ts": 400, "dur": 5,
         "tid": 7}]                                 # after the end
    got = read({"traceEvents": ev})
    assert got["window_s"] == pytest.approx(200e-6)
    assert got["busy_s"] == pytest.approx(60e-6)
    assert got["kernels"]["fused_energy_kernel<true, x>"][0] == 1
    assert "k3" not in got["kernels"]
    gaps = dict(got["idle_gaps"])
    assert gaps["no span: aten::mul"] == pytest.approx(40e-6)
    assert sum(gaps.values()) == pytest.approx(140e-6)
