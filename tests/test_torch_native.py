"""The port's native host crop (`native/hostcrop.c` through
`native/hostcrop.py`) against its plain version, the port's numpy crop
(`energy/terms.py::crop_heatmaps_channels_last_np`), and against the JAX
package's `crop_peak_native` on the same maps: crops and origins bit for
bit, the guard's box and total sums within 1e-6 relative.  Also:
`SequenceOptimizer.stage` stages the batch the numpy crop staged, and a
failed build or an input outside the kernel's range raises."""

import numpy as np
import pytest

from globalegomocap_tpu.data.synthetic import synthetic_chunk_v2
from globalegomocap_tpu.native import hostcrop as jhostcrop
from globalegomocap_tpu_torch.energy.terms import (
    crop_heatmaps_channels_last_np)
from globalegomocap_tpu_torch.native import hostcrop
from globalegomocap_tpu_torch.optimize import driver as tdriver
from tests.torch_port_helpers import chunks, port_chunk, slice_config, tcfg


def _maps(kind):
    """(F, H, W, J) float32 maps of each kind the staging meets."""
    rng = np.random.default_rng(3)
    if kind == "random":
        return rng.normal(size=(9, 64, 64, 15)).astype(np.float32)
    if kind == "synthetic":
        return np.asarray(chunks(26, seeds=(1,))[0].heatmaps)
    if kind == "degraded":      # background floor and distractors
        return np.asarray(synthetic_chunk_v2(26, seed=5).heatmaps)
    if kind == "edges":         # peaks on the border and in the corners
        m = rng.uniform(0.0, 0.5, size=(4, 40, 48, 15)).astype(np.float32)
        ys = [0, 39, 0, 39, 1, 38, 20, 0, 39, 5, 0, 39, 17, 2, 37]
        xs = [0, 47, 47, 0, 1, 46, 0, 20, 30, 47, 3, 44, 0, 47, 2]
        for j, (y, x) in enumerate(zip(ys, xs)):
            m[:, y, x, j] = 2.0
        return m
    if kind == "ties":          # equal maxima: the first in row-major order
        m = np.zeros((3, 32, 32, 15), np.float32)
        m[:, 5, 7, :] = 1.0
        m[:, 5, 20, :] = 1.0
        m[:, 30, 1, ::2] = 1.0
        m[1] = 0.0              # all-zero maps: the peak is (0, 0)
        return m
    if kind == "negative":      # negative mass, and maps with none positive
        m = rng.normal(size=(5, 32, 32, 15)).astype(np.float32) - 1.5
        m[2] = -np.abs(m[2])
        return m
    raise ValueError(kind)


KINDS = ["random", "synthetic", "degraded", "edges", "ties", "negative"]


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_native_crop_matches_numpy_and_jax(kind, k):
    maps = _maps(kind)
    crops, origins, hw, box, total = hostcrop.crop_peak_native(maps, k)
    ncrops, norg, nhw, nbox, ntotal = crop_heatmaps_channels_last_np(maps,
                                                                     k)
    np.testing.assert_array_equal(crops, ncrops.reshape(len(maps), -1))
    np.testing.assert_array_equal(origins, norg)
    assert hw == nhw == maps.shape[1:3]
    np.testing.assert_allclose(box, nbox, rtol=1e-6, atol=0)
    np.testing.assert_allclose(total, ntotal, rtol=1e-6, atol=0)
    ref = jhostcrop.crop_peak_native(maps, k)
    assert ref is not None, "the JAX package's native crop did not build"
    for got, want in zip((crops, origins, box, total),
                         (ref[0], ref[1], ref[3], ref[4])):
        np.testing.assert_array_equal(got, want)


def test_k_larger_than_the_map_is_clipped():
    maps = _maps("edges")[:, :6, :5]
    crops, origins, _, _, _ = hostcrop.crop_peak_native(maps, 8)
    ncrops, norg, *_ = crop_heatmaps_channels_last_np(maps, 8)
    assert crops.shape == (4, 5 * 5 * 15)
    np.testing.assert_array_equal(crops, ncrops.reshape(4, -1))
    np.testing.assert_array_equal(origins, norg)


@pytest.mark.parametrize("shape,k", [((2, 8, 8, 65), 4), ((8, 8, 15), 4),
                                     ((2, 8, 8, 15), 0)])
def test_inputs_outside_the_kernel_raise(shape, k):
    with pytest.raises(ValueError, match="crop_peak_native"):
        hostcrop.crop_peak_native(np.zeros(shape, np.float32), k)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails leaves no library and raises; nothing falls
    back to the numpy crop."""
    monkeypatch.setattr(hostcrop, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(hostcrop, "CC", ("false",))
    monkeypatch.setattr(hostcrop, "_lib", None)
    with pytest.raises(RuntimeError, match="building hostcrop.c failed"):
        hostcrop.crop_peak_native(_maps("ties"), 8)
    assert not any((tmp_path / "native").glob("*.so"))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stage_matches_the_numpy_crop(monkeypatch, dtype):
    """`SequenceOptimizer.stage` through the native crop stages the batch
    its numpy crop staged, field by field, coverage included."""
    cfg = slice_config(tcfg, heatmap_dtype=dtype)
    model = tdriver.build_model(cfg)      # staging reads no weight
    sd = model.state_dict()
    opt = tdriver.SequenceOptimizer(model, sd, sd, cfg, device="cpu")
    cs = [port_chunk(c) for c in chunks(26, seeds=(1, 2))]
    native = opt.stage(cs, on_host=True)

    def numpy_crop(heat, k):
        cr, org, hw, box, total = crop_heatmaps_channels_last_np(heat, k)
        return cr.reshape(cr.shape[0], -1), org, hw, box, total
    monkeypatch.setattr(tdriver, "crop_peak_native", numpy_crop)
    plain = opt.stage(cs, on_host=True)
    for name in ("est", "cams", "heat", "gt", "origins"):
        np.testing.assert_array_equal(
            getattr(native, name).float().numpy(),
            getattr(plain, name).float().numpy(), err_msg=name)
    assert native.heat.dtype == plain.heat.dtype
    assert (native.full_hw, native.n_chunks) == (plain.full_hw, 2)
    assert native.crop_coverage == pytest.approx(plain.crop_coverage,
                                                 rel=1e-6)

