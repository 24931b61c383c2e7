"""gsrt_torch trainer (`models/trainer.py`) against the JAX package on the
same NumPy parameters (CPU; JAX Pallas kernels in interpret mode).

Tolerances:
  * to_cloud: rtol 1e-6 (atol 1e-7 for entries of Σ near zero) — the same
    elementwise f32 formulas;
  * _ssim and render_loss_tiled: rtol 1e-5 — the port's mean filter is
    avg_pool2d where the JAX package convolves with a constant kernel, so
    the window sums associate differently;
  * Adam: three steps on identical NumPy gradients, atol 1e-6 against
    optax's multi_transform of adam at the same learning rates;
  * three train_step_tiled steps from the same start: losses at rtol 1e-3
    and strictly lower after the steps. Parameters after the steps are not
    compared: Adam's first step is lr·g/(|g| + 1e-8), so a gradient of 1e-9
    whose sign differs between the packages moves a parameter by 2·lr.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models import tiled_diff as j_td
from gsrt.models import trainer as j_tr
from gsrt.scene.catalog import random_cloud as j_random_cloud

from gsrt_torch import RenderConfig
from gsrt_torch.interop import (camera_from_numpy, cloud_from_numpy,
                                params_from_numpy, params_to_numpy)
from gsrt_torch.models import trainer as t_tr

W, H, MP = 64, 48, 1 << 13
FIELDS = ("means", "log_scales", "quats", "opacity_logit", "sh")


def _numpy_params(seed: int, n: int = 150, sh_degree: int = 1):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    means = rng.uniform(-2.5, 2.5, (n, 3))
    means[:, 2] += 5.0
    return (f32(means), f32(np.log(rng.uniform(0.08, 0.4, (n, 3)))),
            f32(rng.normal(size=(n, 4))), f32(rng.normal(0, 1.5, n)),
            f32(rng.normal(0, 0.3, (n, (sh_degree + 1) ** 2, 3))))


def _cameras():
    _, jcam = j_random_cloud(1, seed=0, width=W, height=H)
    cam = camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                            np.asarray(jcam.fy), np.asarray(jcam.cx),
                            np.asarray(jcam.cy), W, H, device="cpu")
    return jcam, cam


def test_params_round_trip_and_to_cloud():
    arrays = _numpy_params(0)
    params = params_from_numpy(*arrays, device="cpu")
    assert [n for n, _ in params.named_parameters()] == list(FIELDS)
    for got, want in zip(params_to_numpy(params), arrays):
        np.testing.assert_array_equal(got, want)
    jp = j_tr.GaussianParams(*(jnp.asarray(a) for a in arrays))
    for got, want in zip(params.to_cloud(), jp.to_cloud()):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_init_params_matches_jax():
    jc, _ = j_random_cloud(120, seed=4, width=W, height=H)
    c = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    for got, want in zip(params_to_numpy(t_tr.init_params(c)),
                         j_tr.init_params(jc)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_random_init_shapes_and_seed():
    gen = lambda: torch.Generator().manual_seed(3)
    a = t_tr.random_init(gen(), 64, sh_degree=2, device="cpu")
    b = t_tr.random_init(gen(), 64, sh_degree=2, device="cpu")
    j = j_tr.random_init(jax.random.PRNGKey(3), 64, sh_degree=2)
    for x, y, z in zip(params_to_numpy(a), params_to_numpy(b), j):
        assert x.shape == z.shape and x.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    means, log_scales, quats, logit, sh = params_to_numpy(a)
    assert np.abs(means[:, :2]).max() <= 3.0 and means[:, 2].min() >= 1.0
    np.testing.assert_allclose(log_scales, np.log(np.float32(0.3)))
    np.testing.assert_array_equal(quats, np.asarray(j.quats))
    assert not logit.any() and 0.05 < sh.std() < 0.2


def test_ssim_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got = t_tr._ssim(torch.as_tensor(a), torch.as_tensor(b))
    want = j_tr._ssim(jnp.asarray(a), jnp.asarray(b))
    assert 0.1 < float(want) < 0.99
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(t_tr._ssim(torch.as_tensor(a), torch.as_tensor(a))) == \
        pytest.approx(1.0, abs=1e-6)


def test_adam_groups_match_optax():
    arrays = _numpy_params(2, n=40)
    params = params_from_numpy(*arrays, device="cpu")
    opt = t_tr.make_optimizer(params)
    assert [g["lr"] for g in opt.param_groups] == \
        [1.6e-4, 5e-3, 1e-3, 5e-2, 2.5e-3]
    jp = j_tr.GaussianParams(*(jnp.asarray(a) for a in arrays))
    jopt = j_tr.make_optimizer()
    state = jopt.init(jp)
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = [rng.normal(0, 10.0 ** rng.uniform(-6, 0), a.shape)
                 .astype(np.float32) for a in arrays]
        for name, g in zip(FIELDS, grads):
            getattr(params, name).grad = torch.as_tensor(g)
        opt.step()
        updates, state = jopt.update(
            j_tr.GaussianParams(*(jnp.asarray(g) for g in grads)), state, jp)
        jp = optax.apply_updates(jp, updates)
    for got, want, start in zip(params_to_numpy(params), jp, arrays):
        assert np.abs(got - start).max() > 0
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def fit_setup():
    """A target rendered by the JAX package from one parameter set and a
    start moved off it, shared by the tests that fit it."""
    jcam, cam = _cameras()
    arrays = _numpy_params(5)
    kw = dict(width=W, height=H, conic_mode="standard", tile_w=16, tile_h=16,
              pair_chunk=128)
    jcfg, cfg = JCfg(**kw), RenderConfig(**kw)
    target, _ = j_td.render_tiled_diff(
        j_tr.GaussianParams(*(jnp.asarray(a) for a in arrays)).to_cloud(),
        jcam, jcfg, max_pairs=MP, interpret=True)
    rng = np.random.default_rng(6)
    start = list(arrays)
    start[0] = start[0] + rng.normal(0, 0.05, start[0].shape).astype(
        np.float32)
    start[3] = start[3] - np.float32(0.5)
    return jcam, cam, jcfg, cfg, np.array(target), start


def test_render_loss_tiled_matches_jax(fit_setup):
    jcam, cam, jcfg, cfg, target, start = fit_setup
    want = j_tr.render_loss_tiled(
        j_tr.GaussianParams(*(jnp.asarray(a) for a in start)),
        jnp.asarray(target), jcam, jcfg, MP, 0.2, True)
    params = params_from_numpy(*start, device="cpu")
    got = t_tr.render_loss_tiled(params, torch.as_tensor(target), cam, cfg,
                                 MP, 0.2)
    assert float(want) > 1e-3
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


def test_train_step_tiled_losses_match_jax_and_fall(fit_setup):
    jcam, cam, jcfg, cfg, target, start = fit_setup
    jp = j_tr.GaussianParams(*(jnp.asarray(a) for a in start))
    jopt = j_tr.make_optimizer()
    state = jopt.init(jp)
    j_losses = []
    for _ in range(3):
        jp, state, loss = j_tr.train_step_tiled(
            jp, state, jnp.asarray(target), jcam, jcfg, jopt, MP, 0.2, True)
        j_losses.append(float(loss))
    params = params_from_numpy(*start, device="cpu")
    opt = t_tr.make_optimizer(params)
    tgt = torch.as_tensor(target)
    t_losses = [float(t_tr.train_step_tiled(params, opt, tgt, cam, cfg, MP))
                for _ in range(3)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)
    after = float(t_tr.render_loss_tiled(params, tgt, cam, cfg,
                                         MP).detach())
    assert after < t_losses[2] < t_losses[1] < t_losses[0]
    for p in params.parameters():
        assert torch.isfinite(p).all() and torch.isfinite(p.grad).all()


def test_train_step_matches_tiled_step(fit_setup):
    # the render_fast step and the tiled step start from the same loss
    _, cam, _, cfg, target, start = fit_setup
    tgt = torch.as_tensor(target)
    losses = []
    for step in (t_tr.train_step,
                 lambda *a: t_tr.train_step_tiled(*a, MP)):
        params = params_from_numpy(*start, device="cpu")
        losses.append(float(step(params, t_tr.make_optimizer(params), tgt,
                                 cam, cfg)))
    np.testing.assert_allclose(losses[0], losses[1], rtol=2e-3)


def test_trainer_entry_points_default_to_cuda():
    arrays = _numpy_params(0, n=8)
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert params_from_numpy(*arrays).means.is_cuda
        assert t_tr.random_init(gen, 8).means.is_cuda
        assert t_tr.GaussianParams(
            *(torch.as_tensor(a) for a in arrays)).sh.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(*arrays)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_tr.random_init(gen, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_tr.GaussianParams(*(torch.as_tensor(a) for a in arrays))
    # init_params follows its cloud's device
    jc, _ = j_random_cloud(8, seed=0)
    c = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    assert t_tr.init_params(c).means.device.type == "cpu"
