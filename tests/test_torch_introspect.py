"""The port's prior introspection against the JAX package on the CPU:
`tools/prior_tools.py` (sampling from a seed, and on latents the test
hands both packages, interpolation, latent statistics) on the tiny prior of
tests/test_golden.py with BatchNorm statistics of its own, and
`cli/introspect.py`'s three subcommands against JAX's CLI on one
msgpack prior (the CLIs build the reference's hidden widths, 64-512;
latent 32 here): printed lines, PLY trees and the decoded vertices.

Tolerances: the decoder and encoder in eval mode run in float32 on both
sides; their outputs agree to 1e-5 (rtol and atol), as the port's
ConvVAE tests hold them; the printed statistics to their 4 decimals
(1e-4); PLY vertices (float32 joints moved by a fixed mesh) to 1e-5."""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from globalegomocap_tpu.cli import introspect as jcli
from globalegomocap_tpu.models.checkpoint import save_msgpack
from globalegomocap_tpu.models.conv_vae import ConvVAE as JaxVAE
from globalegomocap_tpu.tools import prior_tools as jpt
from globalegomocap_tpu_torch.cli import introspect as tcli
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE, sample_prior
from globalegomocap_tpu_torch.tools import prior_tools as tpt
from tests.torch_port_helpers import TINY_PRIOR, jax_variables, port_state

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its variables, the port's model of the same weights,
    eval mode)."""
    model = JaxVAE(**TINY_PRIOR)
    v = jax_variables(model, 5)
    port = ConvVAE(**TINY_PRIOR)
    port.load_state_dict(port_state(v))
    return model, v, port.eval()


def windows(n, seed):
    return np.random.default_rng(seed).normal(
        scale=0.3, size=(n, 10, 45)).astype(np.float32)


def test_sample_motions_on_jax_latents(tiny):
    """JAX's sample_motions against the port's from the same seed: the
    port draws JAX's own N(0, I) latents (threefry, `PRNGKey(seed)`);
    the decoder alone on JAX's latents, handed in, as well."""
    model, v, port = tiny
    for n, seed in ((4, 0), (7, 3)):
        want = jpt.sample_motions(model, v, n, seed)
        np.testing.assert_allclose(tpt.sample_motions(port, n, seed), want,
                                   **TOL)
        z = jax.random.normal(jax.random.PRNGKey(seed),
                              (n, model.latent_dim))
        with torch.no_grad():
            got = sample_prior(port, n, z=torch.tensor(np.asarray(z)))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    a, b = tpt.sample_motions(port, 4, 0), tpt.sample_motions(port, 4, 0)
    assert a.shape == (4, 10, 15, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - tpt.sample_motions(port, 4, 1)).max() > 1e-3


def test_interpolate_latents_matches_jax(tiny):
    model, v, port = tiny
    wa, wb = windows(2, 1)
    for steps in (4, 1):
        want = jpt.interpolate_latents(model, v, wa, wb, steps)
        got = tpt.interpolate_latents(port, wa, wb, steps)
        assert got.shape == (steps + 2, 10, 15, 3)
        np.testing.assert_allclose(got, want, **TOL)


def test_latent_statistics_matches_jax(tiny):
    model, v, port = tiny
    w = windows(8, 2)
    want = jpt.latent_statistics(model, v, w)
    got = tpt.latent_statistics(port, w)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)
    assert isinstance(got["mean_std_dist"], float)


def test_export_sample_meshes_layout(tiny, tmp_path):
    _, _, port = tiny
    out = tmp_path / "s"
    motions = tpt.export_sample_meshes(port, str(out), 3, seed=2)
    assert sorted(os.listdir(out)) == ["sample_0", "sample_1", "sample_2"]
    assert sorted(os.listdir(out / "sample_1")) == [
        f"out_{i:04d}.ply" for i in range(10)]
    np.testing.assert_array_equal(motions, tpt.sample_motions(port, 3, 2))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """A msgpack prior at the CLIs' widths (hidden 64-512, latent 32) with
    BatchNorm statistics, and a pickle of 12 windows."""
    root = tmp_path_factory.mktemp("introspect")
    model = JaxVAE(latent_dim=32, seq_len=10)
    ckpt = str(root / "prior.msgpack")
    save_msgpack(jax_variables(model, 7), ckpt)
    data = str(root / "windows.pkl")
    with open(data, "wb") as f:
        pickle.dump(windows(12, 3), f)
    return root, ["--ckpt", ckpt, "--latent_dim", "32"], data


def ply_tree(root):
    """{relative path: (header, vertices)} of the PLY files under root."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                head, body = f.read().split(b"end_header\n", 1)
            n = int(head.split(b"element vertex ")[1].split()[0])
            out[os.path.relpath(os.path.join(d, name), root)] = (
                head, np.frombuffer(body[:12 * n], "<f4"))
    return out


def run_both(capsys, argv_jax, argv_port):
    jcli.main(argv_jax)
    jax_lines = capsys.readouterr().out.splitlines()
    got = tcli.main(argv_port + ["--device", "cpu"])
    return jax_lines, capsys.readouterr().out.splitlines(), got


def test_cli_sample(cli_inputs, capsys):
    """The printed line and the PLY tree (10 windows of 10 frames) at
    --seed 4: the same motions, the port drawing JAX's latents of the
    same seed."""
    root, common, _ = cli_inputs
    seed = ["--seed", "4"]
    jl, tl, got = run_both(
        capsys, ["sample"] + common + seed + ["--out", str(root / "sj")],
        ["sample"] + common + seed + ["--out", str(root / "st")])
    assert jl == [f"wrote 10 sampled motions to {root / 'sj'}"]
    assert tl == [f"wrote 10 sampled motions to {root / 'st'}"]
    jt, tt = ply_tree(root / "sj"), ply_tree(root / "st")
    assert sorted(jt) == sorted(tt) and len(tt) == 100
    for k in jt:
        assert jt[k][0] == tt[k][0]
        np.testing.assert_allclose(tt[k][1], jt[k][1], **TOL, err_msg=k)
    assert got.shape == (10, 10, 15, 3)


def test_cli_interpolate(cli_inputs, capsys):
    root, common, data = cli_inputs
    args = ["--data", data, "--i", "2", "--j", "9", "--steps", "3"]
    jl, tl, got = run_both(
        capsys, ["interpolate"] + common + args + ["--out", str(root / "ij")],
        ["interpolate"] + common + args + ["--out", str(root / "it")])
    assert jl == [f"wrote 5 interpolated motions to {root / 'ij'}"]
    assert tl == [f"wrote 5 interpolated motions to {root / 'it'}"]
    jt, tt = ply_tree(root / "ij"), ply_tree(root / "it")
    assert sorted(jt) == sorted(tt) and sorted(os.listdir(root / "it")) == [
        "0", "1", "2", "3", "4"] and len(tt) == 50
    for k in jt:
        assert jt[k][0] == tt[k][0]
        np.testing.assert_allclose(tt[k][1], jt[k][1], **TOL, err_msg=k)
    assert got.shape == (5, 10, 15, 3)


def test_cli_latent_stats(cli_inputs, capsys):
    _, common, data = cli_inputs
    jl, tl, got = run_both(capsys, ["latent-stats"] + common + [
        "--data", data], ["latent-stats"] + common + ["--data", data])
    assert [ln.split(":")[0] for ln in tl] == [
        ln.split(":")[0] for ln in jl] == ["mean ||mu||^2",
                                           "mean ||std - 1||^2"]
    for a, b in zip(tl, jl):
        assert float(a.split()[-1]) == pytest.approx(float(b.split()[-1]),
                                                     abs=1e-4)
    assert tl == [f"mean ||mu||^2: {got['mean_mu_sq_norm']:.4f}",
                  f"mean ||std - 1||^2: {got['mean_std_dist']:.4f}"]


def test_cli_flags_and_prior_errors(cli_inputs, tmp_path):
    """JAX's subcommands, flags and defaults, plus --device (default
    cuda); a prior of another latent width raises naming the file; an
    empty directory raises the port's own error naming its missing
    manifest.ocdbt, where JAX's orbax raises too."""
    _, common, data = cli_inputs
    parser = tcli.build_parser()
    for argv in (["sample", "--ckpt", "c", "--out", "o"],
                 ["interpolate", "--ckpt", "c", "--data", "d", "--i", "0",
                  "--j", "1", "--out", "o"],
                 ["latent-stats", "--ckpt", "c", "--data", "d"]):
        got = vars(parser.parse_args(argv))
        want = vars(jcli.build_parser().parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want
    with pytest.raises(ValueError, match="prior.msgpack"):
        tcli.main(["latent-stats", "--ckpt", common[1], "--latent_dim",
                   "16", "--data", data, "--device", "cpu"])
    (tmp_path / "orbax").mkdir()
    with pytest.raises(FileNotFoundError, match="manifest.ocdbt"):
        tcli.main(["latent-stats", "--ckpt", str(tmp_path / "orbax"),
                   "--data", data, "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        jcli.main(["latent-stats", "--ckpt", str(tmp_path / "orbax"),
                   "--data", data])


def test_cli_latent_stats_on_an_orbax_prior(cli_inputs, capsys, tmp_path):
    """The CLI prior saved by JAX's save_orbax: latent-stats in the port
    equal to it on the same prior's msgpack file, and JAX's printed lines
    on the directory."""
    from globalegomocap_tpu.models.checkpoint import load_msgpack, save_orbax
    _, common, data = cli_inputs
    orbax_dir = str(tmp_path / "prior.orbax")
    save_orbax(load_msgpack(common[1]), orbax_dir)
    on_file = tcli.main(["latent-stats"] + common + ["--data", data,
                                                     "--device", "cpu"])
    file_lines = capsys.readouterr().out.splitlines()
    argv = ["latent-stats", "--ckpt", orbax_dir, "--latent_dim", "32",
            "--data", data]
    jl, tl, on_dir = run_both(capsys, argv, argv)
    assert sorted(on_dir) == sorted(on_file)
    for k in on_file:
        np.testing.assert_array_equal(on_dir[k], on_file[k], err_msg=k)
    assert tl == file_lines and len(tl) == 2
    for a, b in zip(tl, jl):
        assert float(a.split()[-1]) == pytest.approx(float(b.split()[-1]),
                                                     abs=1e-4)
