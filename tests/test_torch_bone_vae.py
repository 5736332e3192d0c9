"""The port's ConvVAE with the bone-length encoder branch
(`with_bone_length=True`) against the Flax model at the tiny width: the
weights carried across by `models/convert.py` both ways (fusion_dense's
(T, C) rows permuted, fc_mu / fc_var not), eval-mode encode and decode
within 1e-5, one train-mode forward held against JAX's float32 and
float64 runs (`hold`, rtol 1e-5) with the running statistics after it,
the inverse conversion bit for bit, a JAX-written msgpack file, the
port's Orbax and .pth.tar loaders, and BN folding (the conv blocks
only)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.models import checkpoint as jckpt
from globalegomocap_tpu.models.conv_vae import ConvVAE as JVAE
from globalegomocap_tpu_torch.cli.optimize_sequence import load_variables
from globalegomocap_tpu_torch.data.synthetic import synthetic_motion
from globalegomocap_tpu_torch.models.checkpoint import (
    load_prior_variables, save_orbax)
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE as TVAE
from globalegomocap_tpu_torch.models.convert import (
    params_from_flax, params_to_flax)
from globalegomocap_tpu_torch.models.fold_bn import fold_batchnorm
from tests.torch_port_helpers import TINY_PRIOR, hold

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _apply(model, variables, x, train, **kw):
    """model.apply under one jit (op-by-op dispatch costs seconds here)."""
    return jax.jit(lambda v, x: model.apply(v, x, train, **kw))(variables, x)


def _random_stats(v, seed):
    """Every BatchNorm's running statistics drawn from numpy, so that
    eval mode and folding have work to do."""
    rng = np.random.default_rng(seed)

    def draw(tree):
        if set(tree) == {"mean", "var"}:
            return {"mean": rng.uniform(-0.1, 0.1, np.shape(tree["mean"]))
                    .astype(np.float32),
                    "var": rng.uniform(0.8, 1.2, np.shape(tree["var"]))
                    .astype(np.float32)}
        return {k: draw(tree[k]) for k in sorted(tree)}

    return {"params": _np(v["params"]), "batch_stats": draw(v["batch_stats"])}


@pytest.fixture(scope="module")
def case():
    jm = JVAE(**TINY_PRIOR, with_bone_length=True)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 10, 45)), False))(
        jax.random.PRNGKey(4))
    v = _random_stats(v, 4)
    motion = synthetic_motion(120, seed=3)
    pose = np.stack([motion[i:i + 10].reshape(10, 45)
                     for i in range(0, 110, 5)]).astype(np.float32)
    return jm, v, pose


def _port(v, **kw):
    m = TVAE(**TINY_PRIOR, with_bone_length=True, **kw)
    m.load_state_dict(params_from_flax(v))
    return m.eval()


def test_state_dict_layout(case):
    _, v, _ = case
    state = params_from_flax(v)
    c_t = TINY_PRIOR["hidden_dims"][-1] * 10
    assert state["bone_dense.weight"].shape == (512, 150)
    assert state["fusion_dense.weight"].shape == (c_t, c_t + 512)
    assert state["fc_mu.weight"].shape == (32, c_t)
    assert set(state) == set(TVAE(**TINY_PRIOR,
                                  with_bone_length=True).state_dict())


def test_eval_encode_decode_match_jax(case):
    jm, v, pose = case
    tm = _port(v)
    mu_j, lv_j = _apply(jm, v, jnp.asarray(pose), False, method=JVAE.encode)
    z = np.random.default_rng(1).normal(size=(pose.shape[0], 32)).astype(
        np.float32)
    dec_j = _apply(jm, v, jnp.asarray(z), False, method=JVAE.decode)
    with torch.no_grad():
        mu_t, lv_t = tm.encode(torch.from_numpy(pose))
        dec_t = tm.decode(torch.from_numpy(z))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), **TOL)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), **TOL)


def test_without_the_permutation_the_encode_differs(case):
    """fc_mu's rows permuted as for the plain model (the mistake the
    converter must not make) moves mu far beyond the tolerance."""
    jm, v, pose = case
    state = params_from_flax(v)
    c, t = TINY_PRIOR["hidden_dims"][-1], 10
    perm = np.arange(c * t).reshape(c, t).T.reshape(-1)
    state["fc_mu.weight"] = state["fc_mu.weight"][:, np.argsort(perm)]
    tm = TVAE(**TINY_PRIOR, with_bone_length=True)
    tm.load_state_dict(state)
    mu_j, _ = _apply(jm, v, jnp.asarray(pose), False, method=JVAE.encode)
    with torch.no_grad():
        mu_t, _ = tm.eval().encode(torch.from_numpy(pose))
    assert np.abs(mu_t.numpy() - np.asarray(mu_j)).max() > 1e-2


def test_train_mode_forward_matches_jax(case):
    """One train-mode forward (encode, then decode at z = mu) in JAX at
    float32 and at float64: the port held to both (`hold`, rtol 1e-5),
    and every running statistic after it (the bone and fusion BNs over
    the batch axis) within 1e-5 relative of Flax's batch_stats."""
    _, v, pose = case
    out = {}
    for dt in (jnp.float32, jnp.float64):
        with jax.enable_x64(dt == jnp.float64):
            m = JVAE(**TINY_PRIOR, with_bone_length=True, dtype=dt)
            w = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), v)
            (mu, lv), upd = _apply(m, w, jnp.asarray(pose, dt), True,
                                   mutable=["batch_stats"],
                                   method=JVAE.encode)
            recon, upd2 = _apply(m, {"params": w["params"],
                                     "batch_stats": upd["batch_stats"]},
                                 mu, True, mutable=["batch_stats"],
                                 method=JVAE.decode)
            stats = dict(upd["batch_stats"], **{
                k: s for k, s in upd2["batch_stats"].items()
                if k.startswith(("dec_", "final"))})
            out[np.dtype(dt).name] = (_np((recon, mu, lv)), _np(stats))
    (r32, s32), (r64, s64) = out["float32"], out["float64"]
    tm = TVAE(**TINY_PRIOR, with_bone_length=True)
    tm.load_state_dict(params_from_flax(v))
    got = [x.detach().numpy() for x in tm(torch.from_numpy(pose),
                                          train=True)[:3]]
    for name, g, w32, w64 in zip(("recon", "mu", "log_var"), got, r32, r64):
        hold(g, w32, w64, 1e-5, 1e-6, name)
    state = tm.state_dict()
    new32, new64 = (params_from_flax({"params": v["params"],
                                      "batch_stats": s}) for s in (s32, s64))
    for k in new32:
        if "running" in k:
            hold(state[k], new32[k], new64[k], 1e-5, 1e-7, k)
    for bn in ("bone_bn", "fusion_bn", "encoder.0.1", "decoder.0.1"):
        assert not np.allclose(state[f"{bn}.running_mean"].numpy(),
                               params_from_flax(v)[f"{bn}.running_mean"])


def test_orbax_and_pth_priors_load(case, tmp_path):
    """The port's Orbax writer and `load_prior_variables` (an Orbax
    directory, a .pth.tar training checkpoint) carry the bone-length
    prior bit for bit."""
    _, v, _ = case
    state = params_from_flax(v)
    save_orbax(params_to_flax(state), str(tmp_path / "bone.orbax"))
    pth = str(tmp_path / "bone.pth.tar")
    torch.save({"epoch": 0, "state_dict": state}, pth)
    for path in (str(tmp_path / "bone.orbax"), pth):
        back = params_from_flax(load_prior_variables(
            path, 10, TINY_PRIOR["hidden_dims"]))
        assert set(back) == set(state)
        for k in state:
            np.testing.assert_array_equal(back[k].numpy(),
                                          state[k].numpy(), err_msg=k)


def test_params_to_flax_round_trip_is_exact(case):
    _, v, _ = case
    back = params_to_flax(params_from_flax(v))
    flat_a = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_jax_written_msgpack_loads_into_the_port(case, tmp_path):
    jm, v, pose = case
    path = str(tmp_path / "bone.msgpack")
    jckpt.save_msgpack(v, path)
    tm = TVAE(**TINY_PRIOR, with_bone_length=True)
    tm.load_state_dict(load_variables(path, tm))
    mu_j, _ = _apply(jm, v, jnp.asarray(pose), False, method=JVAE.encode)
    with torch.no_grad():
        mu_t, _ = tm.eval().encode(torch.from_numpy(pose))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **TOL)


def test_folding_keeps_the_bone_branch(case):
    """fold_batchnorm folds the conv blocks and keeps bone_bn and
    fusion_bn: the folded model (use_bn=False) encodes as the unfolded
    one, and a bf16 clone casts the new dense layers and keeps the BNs'
    float32."""
    _, v, pose = case
    tm = _port(v)
    folded = TVAE(**TINY_PRIOR, with_bone_length=True, use_bn=False)
    folded.load_state_dict(fold_batchnorm(tm.state_dict()))
    x = torch.from_numpy(pose)
    with torch.no_grad():
        np.testing.assert_allclose(folded.eval().encode(x)[0].numpy(),
                                   tm.encode(x)[0].numpy(), **TOL)
        b = tm.clone(dtype=torch.bfloat16)
        assert b.fusion_dense.weight.dtype == torch.bfloat16
        assert b.bone_bn.weight.dtype == torch.float32
        assert torch.isfinite(b.encode(x)[0].float()).all()
