"""Host staging of the port against the JAX package's
`SequenceOptimizer.stage(on_host=True)`: the staged crops (after the bf16
cast) and their origins are bit-exact, the crop-mass guard's coverage
agrees (rtol 1e-6), and a tripped guard re-crops at k=16 around the
projected estimate identically."""

import numpy as np
import pytest
import jax
import torch

from globalegomocap_tpu.data.synthetic import synthetic_chunk, \
    synthetic_chunk_v2
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.optimize import driver as tdriver
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_chunk, port_state, slice_config,
    tcfg)


@pytest.fixture(scope="module")
def optimizers():
    out = {}
    for dtype in ("bfloat16", "float32"):
        jc = slice_config(jcfg, heatmap_dtype=dtype)
        tc = slice_config(tcfg, heatmap_dtype=dtype)
        jm = jdriver.build_model(jc)
        v = jax_variables(jm, seed=0)
        sd = port_state(v)
        out[dtype] = (jdriver.SequenceOptimizer(jm, v, v, jc),
                      tdriver.SequenceOptimizer(tdriver.build_model(tc), sd,
                                                sd, tc, device="cpu"))
    return out


def _f32(x):
    """Staged heat as float32 numpy (bf16 upcasts exactly)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jax.numpy.asarray(x).astype(jax.numpy.float32))


def _stage_both(optimizers, dtype, cs, coverage=None):
    jopt, topt = optimizers[dtype]
    js = jopt.stage(cs, coverage=coverage, on_host=True)
    ts = topt.stage([port_chunk(c) for c in cs], coverage=coverage,
                    on_host=True)
    return js, ts


def _assert_same_staging(js, ts, n_chunks):
    assert ts.n_chunks == n_chunks
    c = n_chunks                      # the JAX side pads to its device count
    np.testing.assert_array_equal(_f32(ts.heat), _f32(js.heat)[:c])
    np.testing.assert_array_equal(ts.origins.numpy(),
                                  np.asarray(js.origins)[:c])
    assert ts.full_hw == tuple(js.full_hw)
    for name in ("est", "cams", "gt"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name))[:c])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_peak_staging_bit_exact(optimizers, dtype):
    cs = chunks()
    js, ts = _stage_both(optimizers, dtype, cs)
    assert ts.heat.dtype == (torch.bfloat16 if dtype == "bfloat16"
                             else torch.float32)
    assert ts.heat.shape == (2, 26, 8 * 8 * 15)
    _assert_same_staging(js, ts, len(cs))
    np.testing.assert_allclose(ts.crop_coverage, js.crop_coverage,
                               rtol=1e-6)
    assert ts.crop_coverage >= 0.9         # clean maps keep the fast tier


def test_guard_trip_recrop_bit_exact(optimizers):
    """Injected coverage 0.1: k=16 crops centred at the projected
    estimate, and the robust solver tier."""
    cs = chunks()
    js, ts = _stage_both(optimizers, "bfloat16", cs, coverage=0.1)
    assert ts.heat.shape == (2, 26, 16 * 16 * 15)
    _assert_same_staging(js, ts, len(cs))
    jopt, topt = optimizers["bfloat16"]
    jeff, teff = jopt._cfg_for_coverage(0.1), topt._cfg_for_coverage(0.1)
    assert (teff.heatmap_crop, teff.crop_center) == (16, "estimate")
    assert (teff.heatmap_crop, teff.crop_center) == (jeff.heatmap_crop,
                                                     jeff.crop_center)
    for f in ("max_iter", "history_size", "step_candidates",
              "global_max_iter"):
        assert getattr(teff.solver, f) == getattr(jeff.solver, f), f
    assert (teff.solver.max_iter, teff.solver.history_size) == (15, 10)


def test_degraded_maps_trip_the_guard(optimizers):
    """Maps with a background floor and distractors lower the measured
    coverage below 0.90: both packages trip and re-crop the same way."""
    cs = [synthetic_chunk_v2(26, seed=5), synthetic_chunk(26, seed=6)]
    js, ts = _stage_both(optimizers, "bfloat16", cs)
    np.testing.assert_allclose(ts.crop_coverage, js.crop_coverage,
                               rtol=1e-6)
    assert ts.crop_coverage < 0.9
    assert ts.heat.shape[-1] == 16 * 16 * 15
    _assert_same_staging(js, ts, len(cs))


def _stage_device_and_host(opt, cs, coverage=None):
    return (opt.stage(cs, coverage=coverage, on_host=False),
            opt.stage(cs, coverage=coverage, on_host=True))


@pytest.mark.parametrize("case", ["peak", "guard_trip", "degraded",
                                  "full_maps"])
def test_device_staging_equals_host_staging(optimizers, case):
    """stage(on_host=False) cuts the crops on the device from the full
    maps: the same crops, origins and fields as host staging bit for bit
    (the crop is a gather; the JAX package's stage_crop_impl='onehot' is
    a TPU matmul for the same selection), the coverage within 1e-6, at
    the peak crops, at the estimate-centred crops of a tripped guard
    (injected or measured) and at the guard_crop 0 full-map fallback;
    and against the JAX package's own device staging."""
    from dataclasses import replace
    jopt, topt = optimizers["bfloat16"]
    cs = chunks()
    cov = {"guard_trip": 0.1, "full_maps": 0.1}.get(case)
    if case == "degraded":
        cs = [synthetic_chunk_v2(26, seed=5), synthetic_chunk(26, seed=6)]
    if case == "full_maps":
        jc = replace(jopt.cfg, guard_crop=0)
        tc = replace(topt.cfg, guard_crop=0)
        jopt = jdriver.SequenceOptimizer(jopt.model, jopt.local_variables,
                                         jopt.global_variables, jc)
        sd = topt.local_model.state_dict()
        topt = tdriver.SequenceOptimizer(tdriver.build_model(
            replace(tc, fold_bn=False)), sd, sd, tc, device="cpu")
    dev, host = _stage_device_and_host(topt, [port_chunk(c) for c in cs],
                                       cov)
    assert dev.ready is None and dev.n_chunks == host.n_chunks
    assert len(dev.tensors()) == len(host.tensors())
    for a, b in zip(dev.tensors(), host.tensors()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert dev.full_hw == host.full_hw
    # the native crop sums each map's 4,096 cells one after another in
    # float32; on maps with a background floor that order alone moves the
    # mean by up to 4096 * 2**-24 relative (the JAX package's device sums,
    # below, are held at 1e-6)
    np.testing.assert_allclose(dev.crop_coverage, host.crop_coverage,
                               rtol=1e-6 if case != "degraded"
                               else 4096 * 2.0 ** -24)
    width = {"peak": 8 * 8 * 15, "guard_trip": 16 * 16 * 15,
             "degraded": 16 * 16 * 15}.get(case)
    if width is None:
        assert dev.origins is None and dev.heat.shape == (2, 26, 64, 64, 15)
    else:
        assert dev.heat.shape == (2, 26, width)
    js = jopt.stage(cs, coverage=cov, on_host=False)
    c = len(cs)
    np.testing.assert_array_equal(_f32(dev.heat), _f32(js.heat)[:c])
    if dev.origins is not None:
        np.testing.assert_array_equal(dev.origins.numpy(),
                                      np.asarray(js.origins)[:c])
    if cov is None:
        np.testing.assert_allclose(dev.crop_coverage, js.crop_coverage,
                                   rtol=1e-6)
        np.testing.assert_allclose(host.crop_coverage,
                                   jopt.stage(cs, on_host=True).crop_coverage,
                                   rtol=1e-6)


def test_device_staging_segments_as_one(optimizers):
    """stage_segment_chunks=1 crops chunk by chunk: the same batch as one
    segment, the coverage recombined within float32 rounding."""
    from dataclasses import replace
    _, topt = optimizers["bfloat16"]
    cs = [port_chunk(c) for c in chunks(26, (1, 2, 3))]
    whole = topt.stage(cs, on_host=False)
    seg = tdriver.SequenceOptimizer.__new__(tdriver.SequenceOptimizer)
    seg.__dict__.update(topt.__dict__)
    seg.cfg = replace(topt.cfg, stage_segment_chunks=1)
    parts = seg.stage(cs, on_host=False)
    for a, b in zip(whole.tensors(), parts.tensors()):
        assert torch.equal(a, b)
    np.testing.assert_allclose(parts.crop_coverage, whole.crop_coverage,
                               rtol=1e-6)


def test_staging_defaults_to_the_device(optimizers):
    """JAX's default: `stage` and a chunk list given to
    `optimize_chunks_batched` stage on the device."""
    import inspect
    _, topt = optimizers["bfloat16"]
    assert inspect.signature(topt.stage).parameters["on_host"].default \
        is False


def _layout(maps, layout):
    """The same (F, H, W, J) float32 maps in another memory layout."""
    maps = np.asarray(maps, dtype=np.float32)
    if layout == "channels_last":
        return np.ascontiguousarray(maps)
    if layout == "channels_first_view":      # how the generators hand over
        return np.ascontiguousarray(maps.transpose(0, 3, 1, 2)) \
            .transpose(0, 2, 3, 1)
    if layout == "strided_slice":            # no permutation of a buffer
        return np.repeat(maps, 2, axis=0)[::2]
    return maps.astype(np.float64)


LAYOUTS = ("channels_last", "channels_first_view", "strided_slice",
           "float64")


@pytest.mark.parametrize("coverage", [None, 0.1])
@pytest.mark.parametrize("layout", LAYOUTS + ("mixed",))
def test_device_staging_equals_host_staging_over_map_layouts(
        optimizers, layout, coverage):
    """Device staging moves each chunk's maps in their own memory order
    and reorders them on the device: whatever the source's layout, the
    crops, origins, fields and coverage are those of contiguous maps bit
    for bit, the same as host staging's (the coverage within host
    staging's float32 rounding), with the same guard decision, at the
    peak crops and at a tripped guard's estimate-centred crops."""
    _, topt = optimizers["bfloat16"]
    base = [port_chunk(c) for c in chunks(26, (1, 2, 3))]

    def laid_out(name):
        return [c._replace(heatmaps=_layout(
            c.heatmaps, LAYOUTS[i % len(LAYOUTS)] if name == "mixed"
            else name)) for i, c in enumerate(base)]

    cs = laid_out(layout)
    before = [c.heatmaps.copy() for c in cs]
    dev = topt.stage(cs, coverage=coverage, on_host=False)
    ref = topt.stage(laid_out("channels_last"), coverage=coverage,
                     on_host=False)
    host = topt.stage(cs, coverage=coverage, on_host=True)
    for a, b, h in zip(dev.tensors(), ref.tensors(), host.tensors()):
        assert a.dtype == b.dtype == h.dtype
        assert torch.equal(a, b) and torch.equal(a, h)
    assert dev.crop_coverage == ref.crop_coverage
    np.testing.assert_allclose(dev.crop_coverage, host.crop_coverage,
                               rtol=1e-6)
    assert topt._cfg_for_coverage(dev.crop_coverage) == \
        topt._cfg_for_coverage(host.crop_coverage)
    for c, m in zip(cs, before):             # the sources are only read
        np.testing.assert_array_equal(c.heatmaps, m)


def test_memory_order_views_without_a_copy():
    """`memory_order` gives a C-contiguous view of the array's own memory
    and the permutation back to its axes; an array that is no permutation
    of a contiguous float32 buffer falls back to the identity and no
    view, and `fill` copies it in its logical order with the cast."""
    from globalegomocap_tpu_torch.optimize.transfer import (
        fill, memory_order)
    rng = np.random.default_rng(0)
    maps = rng.random((5, 6, 7, 3), dtype=np.float32)
    view, perm = memory_order(maps)
    assert perm == (0, 1, 2, 3) and view.flags.c_contiguous
    assert view.ctypes.data == maps.ctypes.data
    cf = _layout(maps, "channels_first_view")
    view, perm = memory_order(cf)
    assert perm == (0, 2, 3, 1) and view.shape == (5, 3, 6, 7)
    assert view.flags.c_contiguous and view.ctypes.data == cf.ctypes.data
    assert view.transpose(perm).strides == cf.strides
    np.testing.assert_array_equal(view.transpose(perm), maps)
    for layout in ("strided_slice", "float64"):
        x = _layout(maps, layout)
        assert memory_order(x) == (None, (0, 1, 2, 3))
        dst = torch.empty(x.shape, dtype=torch.float32)
        fill(dst, x)
        np.testing.assert_array_equal(dst.numpy(), maps)
    for x in (maps[::-1], maps.astype(">f4")):   # numpy's copy
        assert memory_order(x)[0] is None
        dst = torch.empty(x.shape, dtype=torch.float32)
        fill(dst, x)
        np.testing.assert_array_equal(dst.numpy(), x)
