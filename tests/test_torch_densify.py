"""gsrt_torch adaptive density control (`models/densify.py`) against the
JAX package's on the same NumPy parameters, statistics and optax moments
(CPU).

Tolerances:
  * densify_and_prune: the same N′ and report; every row of every field
    bit for bit (kept, cloned and padding rows are copies or constants,
    split children's log-scales one f32 subtraction), except the split
    children's means, 1e-6 (A·n is summed in another order); the Adam
    moments bit for bit, rows past the survivors zero, step counts kept;
  * one optimiser step after the surgery: parameters at rtol 1e-3, the
    moments at rtol 1e-5 (Adam's arithmetic, done in another order);
  * accumulate_stats: rtol 1e-6 (the norm is summed in another order),
    counts equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.core.types import look_at as j_look_at, make_camera as j_camera
from gsrt.models import densify as j_dn
from gsrt.models import trainer as j_tr

from gsrt_torch import RenderConfig
from gsrt_torch.interop import (camera_from_numpy, opt_state_from_numpy,
                                opt_state_to_numpy, params_from_numpy,
                                params_to_numpy, stats_from_numpy,
                                stats_to_numpy)
from gsrt_torch.models import densify as t_dn
from gsrt_torch.models import trainer as t_tr

FIELDS = t_dn.FIELDS
LABELS = ("means", "scales", "quats", "opacity", "sh")
N = 300


def _case(seed: int = 0, n: int = N):
    """Parameters, statistics and Adam moments as NumPy: about a tenth of
    the splats transparent (pruned), a third hot, half of the hot ones
    above the scale threshold (split) and half below (cloned)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    means = rng.uniform(-2, 2, (n, 3))
    means[:, 2] += 5
    log_scales = np.log(rng.uniform(0.02, 0.3, (n, 3)))
    logit = rng.normal(1.0, 1.5, n)
    logit[rng.random(n) < 0.1] = -8.0
    params = [f32(means), f32(log_scales), f32(rng.normal(size=(n, 4))),
              f32(logit), f32(rng.normal(0, 0.3, (n, 4, 3)))]
    count = rng.integers(0, 20, n).astype(np.int32)
    grad = f32(rng.uniform(0, 1.0, n) * np.maximum(count, 1)
               * 10.0 ** rng.uniform(-5, -2, n))
    moments = [[f32(rng.normal(0, 1e-2, p.shape)) for p in params],
               [f32(rng.uniform(0, 1e-4, p.shape)) for p in params]]
    steps = [7, 7, 7, 7, 7]
    return params, (grad, count), moments, steps


def _jax_state(params, moments, steps):
    jp = j_tr.GaussianParams(*(jnp.asarray(a) for a in params))
    jopt = j_tr.make_optimizer()
    state = jopt.init(jp)
    inner = dict(state.inner_states)
    for label, field, mu, nu, c in zip(LABELS, FIELDS, *moments, steps):
        masked = inner[label]
        adam = masked.inner_state[0]
        adam = adam._replace(
            count=jnp.asarray(c, jnp.int32),
            mu=adam.mu._replace(**{field: jnp.asarray(mu)}),
            nu=adam.nu._replace(**{field: jnp.asarray(nu)}))
        inner[label] = masked._replace(
            inner_state=(adam,) + tuple(masked.inner_state[1:]))
    return jp, jopt, state._replace(inner_states=inner)


def _jax_moments(state):
    out = ([], [], [])
    for label, field in zip(LABELS, FIELDS):
        adam = state.inner_states[label].inner_state[0]
        out[0].append(np.asarray(getattr(adam.mu, field)))
        out[1].append(np.asarray(getattr(adam.nu, field)))
        out[2].append(int(adam.count))
    return out


def _torch_state(params, moments, steps):
    tp = params_from_numpy(*params, device="cpu")
    opt = t_tr.make_optimizer(tp)
    opt_state_from_numpy(opt, *moments, steps)
    return tp, opt


KW = dict(grad_threshold=2e-4, scale_threshold=0.15, seed=3)
# max_splats binds: the budget admits part of the growth only
BUDGETS = {"free": dict(bucket=64), "budget": dict(bucket=64,
                                                   max_splats=N - 10),
           "no_bucket": dict(bucket=0, max_splats=N + 40)}


def _both(budget: str):
    params, stats, moments, steps = _case()
    kw = {**KW, **BUDGETS[budget]}
    jp, jopt, jstate = _jax_state(params, moments, steps)
    jstats = j_dn.DensifyStats(*(jnp.asarray(a) for a in stats))
    want = j_dn.densify_and_prune(jp, jstate, jstats, **kw)
    tp, opt = _torch_state(params, moments, steps)
    got = t_dn.densify_and_prune(tp, opt, stats_from_numpy(
        *stats, device="cpu"), **kw)
    return (tp, opt, got), (jp, jopt, want), params


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_densify_and_prune_matches_jax(budget):
    (_, _, (tp, opt, tstats, trep)), (_, _, (jp, jstate, jstats, jrep)), \
        _ = _both(budget)
    assert trep == jrep
    assert jrep.n_cloned > 0 and jrep.n_split > 0 and jrep.n_pruned > 0
    if budget == "budget":   # the budget held growth back
        free = _both("free")[1][2][3]
        assert jrep.n_after <= N - 10 < free.n_after
    n_new = jp.means.shape[0]
    assert n_new == (t_dn.round_up_to(jrep.n_after, 64)
                     if BUDGETS[budget]["bucket"] else jrep.n_after)
    child = slice(jrep.n_after - 2 * jrep.n_split, jrep.n_after)
    for f, got, want in zip(FIELDS, params_to_numpy(tp), jp):
        want = np.asarray(want)
        assert got.shape == want.shape
        if f == "means":
            np.testing.assert_allclose(got[child], want[child], atol=1e-6,
                                       rtol=0)
            got[child] = want[child]
        np.testing.assert_array_equal(got, want, err_msg=f)
    # padding rows are inert: dead opacity, unit quaternion
    logit, quats = params_to_numpy(tp)[3], params_to_numpy(tp)[2]
    assert (logit[jrep.n_after:] == -12.0).all()
    np.testing.assert_array_equal(quats[jrep.n_after:, 0], 1.0)
    # moments: survivors' rows moved, the rest zero; step counts kept
    keep = jrep.n_after - jrep.n_cloned - 2 * jrep.n_split
    for got, want in zip(opt_state_to_numpy(opt), _jax_moments(jstate)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for mom in opt_state_to_numpy(opt)[:2]:
        for m in mom:
            assert m.shape[0] == n_new and not m[keep:].any()
            assert np.abs(m[:keep]).max() > 0
    assert opt_state_to_numpy(opt)[2] == [7] * 5
    for got, want in zip(stats_to_numpy(tstats), jstats):
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got.shape == (n_new,) and not got.any()


def test_surgery_optimizer_holds_new_parameters_and_steps_like_optax():
    (tp, opt, (tp2, opt2, _, _)), (jp, jopt, (jp2, jstate2, _, rep)), \
        _ = _both("budget")
    assert opt2 is opt
    groups = opt.param_groups
    assert [g["lr"] for g in groups] == [1.6e-4, 5e-3, 1e-3, 5e-2, 2.5e-3]
    new = [getattr(tp2, f) for f in FIELDS]
    for g, p in zip(groups, new):
        assert len(g["params"]) == 1 and g["params"][0] is p
    assert set(map(id, opt.state)) == set(map(id, new))
    old = {id(getattr(tp, f)) for f in FIELDS}
    assert not old & {id(p) for g in groups for p in g["params"]}
    # a second event handed the stale parameters refuses them
    with pytest.raises(ValueError, match="stale"):
        t_dn.densify_and_prune(tp, opt, t_dn.init_stats(N, "cpu"), **KW)
    # one more step on the same gradients
    rng = np.random.default_rng(8)
    grads = [rng.normal(0, 1e-3, p.shape).astype(np.float32) for p in new]
    for p, g in zip(new, grads):
        p.grad = torch.as_tensor(g)
    opt.step()
    updates, jstate3 = jopt.update(
        j_tr.GaussianParams(*(jnp.asarray(g) for g in grads)), jstate2, jp2)
    jp3 = optax.apply_updates(jp2, updates)
    for got, want in zip(params_to_numpy(tp2), jp3):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3,
                                   atol=1e-6)
    got_m, want_m = opt_state_to_numpy(opt), _jax_moments(jstate3)
    for g, w in zip(got_m[0] + got_m[1], want_m[0] + want_m[1]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-12)
    assert got_m[2] == want_m[2] == [8] * 5


def test_accumulate_stats_matches_jax():
    params, _, _, _ = _case(1)
    rng = np.random.default_rng(2)
    tp = params_from_numpy(*params, device="cpu")
    tstats = t_dn.init_stats(N, device="cpu")
    jstats = j_dn.init_stats(N)
    for _ in range(3):
        g = rng.normal(0, 10.0 ** rng.uniform(-7, -2, (N, 1)), (N, 3))
        g[rng.random(N) < 0.3] = 0.0       # splats that were not visible
        g = g.astype(np.float32)
        tp.means.grad = torch.as_tensor(g)
        tstats = t_dn.accumulate_stats(tstats, tp)
        jstats = j_dn.accumulate_stats(jstats, j_tr.GaussianParams(
            jnp.asarray(g), *(jnp.zeros(p.shape) for p in params[1:])))
    got, want = stats_to_numpy(tstats), jstats
    np.testing.assert_allclose(got[0], np.asarray(want.grad_accum),
                               rtol=1e-6)
    np.testing.assert_array_equal(got[1], np.asarray(want.count))
    assert got[1].dtype == np.int32 and 0 < got[1].mean() < 3


def test_reset_opacity_and_round_up_match_jax():
    params, _, _, _ = _case(2)
    tp = params_from_numpy(*params, device="cpu")
    assert t_dn.reset_opacity(tp, 0.02) is tp
    want = j_dn.reset_opacity(
        j_tr.GaussianParams(*(jnp.asarray(a) for a in params)), 0.02)
    np.testing.assert_array_equal(params_to_numpy(tp)[3],
                                  np.asarray(want.opacity_logit))
    for n, b in [(1, 8), (8, 8), (9, 8), (5000, 4096), (0, 4096)]:
        assert t_dn.round_up_to(n, b) == j_dn.round_up_to(n, b)


def test_train_step_adaptive_matches_jax():
    W, H = 32, 24
    params, _, _, _ = _case(3, n=40)
    params[0][:, :2] *= 0.5
    kw = dict(width=W, height=H, conic_mode="standard")
    view = j_look_at((0, 0, 0), (0, 0, 5))
    jcam = j_camera(view, 60.0, W, H)
    cam = camera_from_numpy(view, np.asarray(jcam.fx), np.asarray(jcam.fy),
                            np.asarray(jcam.cx), np.asarray(jcam.cy), W, H,
                            device="cpu")
    target = np.random.default_rng(4).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    jp = j_tr.GaussianParams(*(jnp.asarray(a) for a in params))
    jopt = j_tr.make_optimizer()
    jstep = j_dn.make_train_step_adaptive(JCfg(**kw), jopt)
    jstate, jstats, jl = jopt.init(jp), j_dn.init_stats(40), []
    tp = params_from_numpy(*params, device="cpu")
    opt, tstats, tl = t_tr.make_optimizer(tp), t_dn.init_stats(40, "cpu"), []
    step = t_dn.make_train_step_adaptive(RenderConfig(**kw))
    for _ in range(2):
        jp, jstate, jstats, loss = jstep(jp, jstate, jstats,
                                         jnp.asarray(target), jcam)
        jl.append(float(loss))
        tstats, loss = step(tp, opt, tstats, torch.as_tensor(target), cam)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    got = stats_to_numpy(tstats)
    assert got[1].max() == 2
    np.testing.assert_array_equal(got[1], np.asarray(jstats.count))
    np.testing.assert_allclose(got[0], np.asarray(jstats.grad_accum),
                               rtol=1e-3, atol=1e-3 * got[0].max())


def test_densify_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert t_dn.init_stats(4).count.is_cuda
        assert stats_from_numpy(np.zeros(4), np.zeros(4)).count.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_dn.init_stats(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stats_from_numpy(np.zeros(4), np.zeros(4))
