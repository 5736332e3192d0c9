"""Prior-regime matching in the port (`optimize/prior_bank.py` and the
driver's selection) against the JAX package, on the tiny prior, two
seeded random prior pairs and the JAX package's own chunks: a smooth
`synthetic_chunk` and a jerky `synthetic_chunk_v2` (the regimes of JAX's
tests/test_prior_bank.py, whose bank statistics this file reuses).

Tolerances: the bank's selection is exact (the same names, the same
errors); the torch statistic against `motion_accel_stat_jax` 1e-5
relative (both are float32 FFTs of the same numbers; they agree to about
1e-7 here); device staging's statistic against host staging's 1e-5; a
selected solve's fields the fixed-iteration tolerance of
tests/test_torch_pipeline.py (rtol 1e-3, atol 2e-4 at 2 + 1
iterations)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from globalegomocap_tpu.data.synthetic import (
    synthetic_chunk, synthetic_chunk_v2, synthetic_motion)
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu.optimize import prior_bank as jbank
from globalegomocap_tpu_torch.optimize import driver as tdriver
from globalegomocap_tpu_torch.optimize import prior_bank as tbank
from tests.torch_port_helpers import (
    jax_variables, jcfg, port_chunk, port_state, slice_config, tcfg)

KNOBS = dict(max_iter=2, global_max_iter=1, robust_tier_on_guard=False)
SMOOTH = jbank.motion_accel_stat(
    synthetic_motion(100, seed=0), window=10)
JERKY = jbank.motion_accel_stat(
    synthetic_motion(100, seed=0, motion_scale=0.10, freq_range=(0.5, 2.5)),
    window=10)


# ---------------------------------------------------------------------------
# the bank and the statistic
# ---------------------------------------------------------------------------

BANK = (("smooth", 1e-3), ("mid", 8e-3), ("jerky", 3e-2))


def _banks():
    j, t = jbank.PriorBank(), tbank.PriorBank()
    for name, a in BANK:
        j.add(name, name + "L", name + "G", a)
        t.add(name, name + "L", name + "G", a)
    return j, t


def test_select_matches_jax_on_a_grid():
    """200 statistics from 1e-6 to 1, log-spaced, each named alike."""
    j, t = _banks()
    for a in np.logspace(-6, 0, 200):
        assert t.select(a).name == j.select(a).name, a


@pytest.mark.parametrize("lo,hi", [(0, 1), (1, 2)], ids=["low", "high"])
def test_select_at_the_log_midpoints_matches_jax(lo, hi):
    """At the log midpoint of two entries and a hair either side: JAX's
    choice, the first of equals at the midpoint itself."""
    j, t = _banks()
    mid = float(np.sqrt(BANK[lo][1] * BANK[hi][1]))
    for a in (mid * (1 - 1e-9), mid, mid * (1 + 1e-9)):
        assert t.select(a).name == j.select(a).name, a
    assert t.select(mid * 0.99).name == BANK[lo][0]
    assert t.select(mid * 1.01).name == BANK[hi][0]
    # JAX's test: the midpoint of 1e-3 and 8e-3 is about 2.83e-3
    two = (tbank.PriorBank().add("smooth", 0, 0, 1e-3)
           .add("jerky", 0, 0, 8e-3))
    assert two.select(2.5e-3).name == "smooth"
    assert two.select(3.2e-3).name == "jerky"


@pytest.mark.parametrize("case", ["empty", "zero", "negative"])
def test_bank_errors_match_jax(case):
    """The same ValueError from both packages."""
    msgs = []
    for pkg in (jbank, tbank):
        with pytest.raises(ValueError) as e:
            if case == "empty":
                pkg.PriorBank().select(1e-3)
            else:
                pkg.PriorBank().add("bad", None, None,
                                    0.0 if case == "zero" else -1e-3)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("window", [None, 10, 7], ids=["whole", "w10", "w7"])
@pytest.mark.parametrize("frames", [26, 100])
def test_torch_statistic_matches_jax(window, frames):
    """motion_accel_stat_torch of a (C, F, 15, 3) stack against JAX's
    motion_accel_stat_jax (1e-5) and the numpy statistic (1e-5); a 0-d
    tensor."""
    est = np.stack([synthetic_chunk_v2(frames, seed=s).estimated_local
                    for s in (1, 2)])
    want = float(jbank.motion_accel_stat_jax(jnp.asarray(est),
                                             window=window))
    got = tbank.motion_accel_stat_torch(torch.from_numpy(est),
                                        window=window)
    assert got.shape == () and got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert float(got) == pytest.approx(
        tbank.motion_accel_stat(est, window=window), rel=1e-5)


# ---------------------------------------------------------------------------
# the driver's selection
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    """Two random prior pairs (JAX variables and port state dicts) and
    the smooth and jerky chunks of JAX's test."""
    model = jdriver.build_model(slice_config(jcfg))
    va, vb = jax_variables(model, seed=0), jax_variables(model, seed=9)
    cs = {"smooth": synthetic_chunk(26, seed=3),
          "jerky": synthetic_chunk_v2(26, seed=3)}
    return (va, vb), (port_state(va), port_state(vb)), cs


def _bank(pkg, a, b, only=None):
    bank = pkg.PriorBank()
    for name, v, stat in (("smooth", a, SMOOTH), ("jerky", b, JERKY)):
        if only in (None, name):
            bank.add(name, v, v, stat)
    return bank


def _optimizers(pairs, **kw):
    (va, vb), (sa, sb), _ = pairs
    jc, tc = slice_config(jcfg, **KNOBS), slice_config(tcfg, **KNOBS)
    only = kw.pop("only", None)
    jopt = jdriver.SequenceOptimizer(
        jdriver.build_model(jc), va, va, jc,
        prior_bank=_bank(jbank, va, vb, only), **kw)
    topt = tdriver.SequenceOptimizer(
        tdriver.build_model(tc), sa, sa, tc, device="cpu",
        prior_bank=_bank(tbank, sa, sb, only), **kw)
    return jopt, topt


PATHS = ["host-flat", "host-vmap", "device-flat", "device-vmap", "chunk"]


@pytest.mark.parametrize("path", PATHS)
def test_driver_selects_the_jax_entry(pairs, path):
    """The smooth chunk gets 'smooth', the jerky one 'jerky', as JAX's
    driver names them (its selection of the same staging, without its
    solve), through host and device staging in both modes and through
    optimize_chunk; the port's solve runs and is finite.  Device
    staging's statistic equals host staging's within 1e-5."""
    jopt, topt = _optimizers(pairs)
    names = []
    for kind in ("smooth", "jerky"):
        c = pairs[2][kind]
        if path == "chunk":
            jopt._select_priors(jbank.motion_accel_stat(
                np.asarray(c.estimated_local), window=10))
            res = topt.optimize_chunk(port_chunk(c))
        else:
            where, mode = path.split("-")
            host = where == "host"
            jst = jopt.stage([c], on_host=host)
            tst = topt.stage([port_chunk(c)], on_host=host)
            assert tst.accel_mean == pytest.approx(jst.accel_mean, rel=1e-5)
            other = topt.stage([port_chunk(c)], on_host=not host)
            assert other.accel_mean == pytest.approx(tst.accel_mean,
                                                     rel=1e-5)
            jopt._select_priors(jst.accel_mean)
            res = topt.optimize_chunks_batched(tst, mode=mode)
        assert topt.last_prior_name == jopt.last_prior_name, kind
        names.append(topt.last_prior_name)
        assert torch.isfinite(res.optimized).all()
    assert names == ["smooth", "jerky"]


def test_selected_solve_matches_jax_and_selection_is_live(pairs):
    """The jerky batch through JAX's and the port's host-staged flat solve
    on the bank: 'jerky' in both, every ChunkResult field within the
    fixed-iteration tolerance.  With a bank of 'smooth' alone the same
    batch solves to other poses, as in JAX's test."""
    c = [pairs[2]["jerky"]]
    jopt, topt = _optimizers(pairs)
    jres = jopt.optimize_chunks_batched(jopt.stage(c, on_host=True),
                                        mode="flat")
    tres = topt.optimize_chunks_batched(
        topt.stage([port_chunk(x) for x in c], on_host=True), mode="flat")
    assert jopt.last_prior_name == topt.last_prior_name == "jerky"
    jres = jax.tree_util.tree_map(np.asarray, jres)
    for name in jres._fields:
        np.testing.assert_allclose(getattr(tres, name).numpy(),
                                   getattr(jres, name), rtol=1e-3,
                                   atol=2e-4, err_msg=name)
    _, alone = _optimizers(pairs, only="smooth")
    other = alone.optimize_chunks_batched(
        alone.stage([port_chunk(x) for x in c], on_host=True), mode="flat")
    assert alone.last_prior_name == "smooth"
    assert not np.allclose(other.optimized.numpy(), tres.optimized.numpy())


def test_bank_entries_are_staged_once(pairs, monkeypatch):
    """Each bank entry is folded and cast at construction
    (`pipeline.stage_models`, twice a pair); selecting and solving stage
    nothing more."""
    from globalegomocap_tpu_torch.optimize import pipeline
    calls = []
    real = pipeline.stage_models
    monkeypatch.setattr(pipeline, "stage_models",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, topt = _optimizers(pairs)
    assert len(calls) == 2 * 3                 # the held pair and two
    for kind in ("smooth", "jerky"):
        topt.optimize_chunks_batched(
            topt.stage([port_chunk(pairs[2][kind])], on_host=True),
            mode="flat")
    assert len(calls) == 6
    assert topt._select_priors(JERKY) is topt._bank[1][2]
    assert topt._select_priors(SMOOTH) is topt._bank[0][2]
    assert topt._select_priors(None) is topt._stages


def test_a_batch_without_a_statistic_solves_with_the_held_pair(pairs):
    """A batch staged by an optimizer with no bank carries no statistic;
    an optimizer with a bank solves it with its held pair and names no
    entry, as JAX's `_select_priors(None)` returns the held variables:
    the same poses as the optimizer without a bank, exactly."""
    jopt, topt = _optimizers(pairs)
    assert jopt._select_priors(None) == (jopt.local_variables,
                                         jopt.global_variables)
    assert jopt.last_prior_name is None
    sa = pairs[1][0]
    tc = slice_config(tcfg, **KNOBS)
    plain = tdriver.SequenceOptimizer(tdriver.build_model(tc), sa, sa, tc,
                                      device="cpu")
    staged = plain.stage([port_chunk(pairs[2]["jerky"])], on_host=True)
    assert staged.accel_mean is None
    got = topt.optimize_chunks_batched(staged, mode="flat")
    assert topt.last_prior_name is None
    want = plain.optimize_chunks_batched(staged, mode="flat")
    torch.testing.assert_close(got.optimized, want.optimized, rtol=0,
                               atol=0)


@pytest.mark.parametrize("kind,warns", [("jerky", True), ("smooth", False)])
def test_mismatch_warning_matches_jax(pairs, kind, warns):
    """Without a bank, prior_accel_mean = the smooth statistic: the jerky
    batch warns ('motion-regime mismatch') in both packages, once; the
    smooth one warns in neither."""
    (va, _), (sa, _), cs = pairs
    jc, tc = slice_config(jcfg, **KNOBS), slice_config(tcfg, **KNOBS)
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), va, va, jc,
                                     prior_accel_mean=SMOOTH)
    topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sa, sa, tc,
                                     device="cpu", prior_accel_mean=SMOOTH)
    c = cs[kind] if kind == "jerky" else synthetic_chunk(26, seed=5)
    seen = {}
    for name, opt, chunk in (("jax", jopt, c), ("port", topt,
                                                port_chunk(c))):
        staged = opt.stage([chunk], on_host=True)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if name == "jax":
                opt._select_priors(staged.accel_mean)
                opt._select_priors(staged.accel_mean)
            else:
                opt.optimize_chunks_batched(staged, mode="flat")
                opt.optimize_chunks_batched(staged, mode="flat")
        seen[name] = [str(w.message) for w in rec
                      if "motion-regime mismatch" in str(w.message)]
    assert len(seen["port"]) == len(seen["jax"]) == (1 if warns else 0)
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("on_host", [True, False], ids=["host", "device"])
def test_staging_skips_the_statistic_when_unconfigured(pairs, on_host):
    """No bank and no recorded statistic: staging leaves accel_mean None
    (no readback), as JAX's does, and solves with the held pair."""
    (va, _), (sa, _), cs = pairs
    jc, tc = slice_config(jcfg, **KNOBS), slice_config(tcfg, **KNOBS)
    jopt = jdriver.SequenceOptimizer(jdriver.build_model(jc), va, va, jc)
    topt = tdriver.SequenceOptimizer(tdriver.build_model(tc), sa, sa, tc,
                                     device="cpu")
    c = cs["jerky"]
    assert jopt.stage([c], on_host=on_host).accel_mean is None
    staged = topt.stage([port_chunk(c)], on_host=on_host)
    assert staged.accel_mean is None
    assert topt._select_priors(staged.accel_mean) is topt._stages
    assert topt.last_prior_name is None
