"""Adaptive density control for 3DGS training: clone, split and prune
(counterpart of `gsrt.models.densify`).

Semantics follow the INRIA schedule: ||∂L/∂mean|| is accumulated over
steps and averaged by visibility count; above `grad_threshold` a splat is
cloned (max scale ≤ `scale_threshold`) or split into `split_n` children
drawn from its own Gaussian with scales shrunk by `split_factor` (the
parent removed); splats with opacity < `opacity_threshold` are pruned;
opacities are reset toward transparency now and then so pruning can act.

PyTorch idiom where it differs from the JAX package: the per-step
statistics read `params.means.grad` after `backward()`; the surgery runs
on the parameters' device with `index_select`/`cat` and builds new
`nn.Parameter`s, so it also rewrites the optimiser (one Adam with a group
per field) in place: each group then holds its new parameter, the Adam
moments are row-remapped as the JAX package remaps optax's (survivors keep
their rows, clones, split children and padding restart at zero), and each
group keeps its learning rate and step count. The new splat count is
bucketed by `round_up_to`, as in the JAX package (where the bucket limits
XLA re-traces), so both packages give the same N′; padding rows are inert
(opacity logit −12, identity rotation).

Two documented differences: the split children's normals are drawn on the
host from `np.random.default_rng(seed)` in the JAX package's order and
moved to the device, so both packages draw the same children; and the
budget's hottest-first order is a stable sort, where the JAX package's
`np.argsort` is not (they differ only among candidates of equal average
gradient).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gsrt_torch.core.types import resolve_device
from gsrt_torch.models.trainer import GaussianParams, _step, render_loss

FIELDS = ("means", "log_scales", "quats", "opacity_logit", "sh")


class DensifyStats(NamedTuple):
    """Per-splat accumulators carried across train steps."""

    grad_accum: torch.Tensor   # [N] f32: sum of ||dL/d mean||
    count: torch.Tensor        # [N] int32: steps the splat received gradient


def init_stats(n: int, device=None) -> DensifyStats:
    dev = resolve_device(device)
    return DensifyStats(
        grad_accum=torch.zeros((n,), dtype=torch.float32, device=dev),
        count=torch.zeros((n,), dtype=torch.int32, device=dev))


def accumulate_stats(stats: DensifyStats, params: GaussianParams
                     ) -> DensifyStats:
    """Fold one step's gradients (`params.means.grad`, after `backward()`)
    into the accumulators. A splat is visible this step when the norm of
    its mean's gradient is above 0 (culled and fully occluded splats get
    exact zeros through the masked blend, as INRIA's visibility_filter)."""
    g = torch.linalg.vector_norm(params.means.grad, dim=-1)
    return DensifyStats(grad_accum=stats.grad_accum + g,
                        count=stats.count + (g > 0).to(torch.int32))


def _cov_chol(log_scales: torch.Tensor, quats: torch.Tensor
              ) -> torch.Tensor:
    """[N, 3, 3] factor A with Σ = A Aᵀ: A = R(q)·diag(exp(log_scales)),
    so mean + A·n with n ~ N(0, I) draws from the splat's own Gaussian."""
    q = quats / torch.clamp_min(
        torch.linalg.vector_norm(quats, dim=-1, keepdim=True), 1e-12)
    w, x, y, z = q.unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)
    return R * torch.exp(log_scales)[:, None, :]


def round_up_to(n: int, bucket: int = 4096) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def _pad_rows(a: torch.Tensor, n_pad: int) -> torch.Tensor:
    if n_pad <= 0:
        return a
    return torch.cat([a, a.new_zeros((n_pad,) + tuple(a.shape[1:]))])


class DensifyReport(NamedTuple):
    n_before: int
    n_after: int       # live splats after surgery (≤ padded shape)
    n_cloned: int
    n_split: int
    n_pruned: int


# logit of a fully dead opacity: sigmoid(-12) ≈ 6e-6, far below any
# alpha_threshold, so padded rows never blend and receive no gradient
_DEAD_LOGIT = -12.0


def _remap_optimizer(optimizer: torch.optim.Optimizer, old: GaussianParams,
                     new: GaussianParams, idx_keep: torch.Tensor, n: int,
                     n_new: int) -> None:
    """Point each group of `optimizer` at the new parameter of its field
    and remap its state: a tensor whose first dimension is the old N is a
    per-splat moment, whose survivors keep their rows and whose other rows
    restart at zero; everything else (the step count) is kept."""
    fields = {id(getattr(old, f)): f for f in FIELDS}
    if any(id(p) not in fields
           for group in optimizer.param_groups for p in group["params"]):
        raise ValueError(
            "the optimizer holds a tensor that is not one of these "
            "parameters (a stale parameter from before an earlier densify "
            "event?)")
    keep = idx_keep.shape[0]
    for group in optimizer.param_groups:
        swapped = []
        for p in group["params"]:
            q = getattr(new, fields[id(p)])
            state = optimizer.state.pop(p, {})
            for k, v in state.items():
                if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == n \
                        and n != 0:
                    out = v.new_zeros((n_new,) + tuple(v.shape[1:]))
                    out[:keep] = v.index_select(0, idx_keep)
                    state[k] = out
            if state:
                optimizer.state[q] = state
            swapped.append(q)
        group["params"] = swapped


def densify_and_prune(
    params: GaussianParams,
    optimizer: torch.optim.Optimizer,
    stats: DensifyStats,
    *,
    grad_threshold: float,
    scale_threshold: float,
    opacity_threshold: float = 0.005,
    split_factor: float = 1.6,
    split_n: int = 2,
    max_splats: Optional[int] = None,
    bucket: int = 4096,
    seed: int = 0,
):
    """One adaptive-density event, between steps, on the parameters'
    device.

    Returns (params, optimizer, stats, report): new parameters with
    N′ = round_up_to(live count, bucket) rows (dead padding rows carry
    opacity logit −12 and an identity rotation), the same optimizer
    rewritten in place to hold them (see the module docstring), fresh
    statistics of N′ rows, and the report. `scale_threshold` is in world
    units (INRIA: 0.01 × scene extent); `grad_threshold` applies to the
    step-averaged ||dL/d mean||."""
    with torch.no_grad():
        return _densify(params, optimizer, stats, grad_threshold,
                        scale_threshold, opacity_threshold, split_factor,
                        split_n, max_splats, bucket, seed)


def _densify(params, optimizer, stats, grad_threshold, scale_threshold,
             opacity_threshold, split_factor, split_n, max_splats, bucket,
             seed):
    p = {f: getattr(params, f).detach() for f in FIELDS}
    n = p["means"].shape[0]
    dev = p["means"].device
    rng = np.random.default_rng(seed)

    cnt = stats.count
    # float64, as NumPy divides f32 by int32: the same averages and tests
    avg = stats.grad_accum.double() / torch.clamp_min(cnt, 1).double()
    opac = 1.0 / (1.0 + torch.exp(-p["opacity_logit"]))
    smax = torch.exp(p["log_scales"]).amax(-1)

    alive = opac >= opacity_threshold
    hot = (avg >= grad_threshold) & alive & (cnt > 0)
    clone = hot & (smax <= scale_threshold)
    split = hot & (smax > scale_threshold)

    if max_splats is not None:
        # keep the hottest candidates only, so growth respects the budget
        budget = max(max_splats - int(alive.sum()), 0)
        grow = clone.long() + split.long() * (split_n - 1)
        if int(grow.sum()) > budget:
            order = torch.sort(avg, descending=True, stable=True).indices
            cum = torch.cumsum(grow[order], 0)
            allowed = torch.zeros(n, dtype=torch.bool, device=dev)
            allowed[order[cum <= budget]] = True
            clone &= allowed
            split &= allowed

    idx_keep = torch.nonzero(alive & ~split).flatten()
    idx_clone = torch.nonzero(clone & ~split).flatten()
    idx_split = torch.nonzero(split).flatten()
    n_split = idx_split.shape[0]

    # split children: drawn from the parent's own Gaussian, scales shrunk
    # so split_n children tile the parent's footprint
    if n_split:
        A = _cov_chol(p["log_scales"][idx_split], p["quats"][idx_split])
        parent = p["means"][idx_split]
        shrunk = p["log_scales"][idx_split] - np.float32(
            np.log(split_factor))
        child_means = torch.cat([
            parent + torch.einsum("nij,nj->ni", A, torch.as_tensor(
                rng.standard_normal((n_split, 3)).astype(np.float32),
                device=dev))
            for _ in range(split_n)])
        child_ls = shrunk.repeat(split_n, 1)
    idx_children = idx_split.repeat(split_n)

    src = torch.cat([idx_keep, idx_clone, idx_children])
    n_live = src.shape[0]
    n_new = round_up_to(n_live, bucket) if bucket else n_live
    n_pad = n_new - n_live
    first_child = idx_keep.shape[0] + idx_clone.shape[0]

    def remap(a, override=None):
        out = a.index_select(0, src)
        if override is not None:
            out[first_child:] = override
        return _pad_rows(out, n_pad)

    means = remap(p["means"], child_means if n_split else None)
    log_scales = remap(p["log_scales"], child_ls if n_split else None)
    quats = remap(p["quats"])
    quats[n_live:, 0] = 1.0                 # identity rotation on padding
    logit = remap(p["opacity_logit"])
    logit[n_live:] = _DEAD_LOGIT
    sh = remap(p["sh"])
    new_params = GaussianParams(means, log_scales, quats, logit, sh,
                                device=dev)
    _remap_optimizer(optimizer, params, new_params, idx_keep, n, n_new)

    # prune counts only rows that were meaningfully alive: padding rows of
    # an earlier event sit at sigmoid(_DEAD_LOGIT) ≈ 6e-6 and would be
    # counted again at every event
    was_real = opac.double() > 2.0 / (1.0 + np.exp(-_DEAD_LOGIT))
    report = DensifyReport(
        n_before=n, n_after=n_live, n_cloned=int(idx_clone.shape[0]),
        n_split=int(n_split), n_pruned=int((was_real & ~alive).sum()))
    return new_params, optimizer, init_stats(n_new, dev), report


def reset_opacity(params: GaussianParams,
                  max_opacity: float = 0.01) -> GaussianParams:
    """Clamp every opacity to ≤ max_opacity, in place (INRIA's periodic
    reset: the optimiser re-earns opacity, so stale floaters fall below
    the prune threshold); returns params. Dead padding rows stay dead
    (the clamp only lowers) and the optimiser's state is untouched."""
    cap = float(np.log(max_opacity / (1.0 - max_opacity)))
    with torch.no_grad():
        params.opacity_logit.clamp_(max=cap)
    return params


def make_train_step_adaptive(cfg, lambda_ssim: float = 0.2):
    """A train step that also folds the densification statistics:
    step(params, optimizer, stats, target, camera) → (stats, loss) on
    `render_loss`; params and optimizer are updated in place."""

    def step(params: GaussianParams, optimizer, stats: DensifyStats,
             target, camera):
        loss = _step(lambda _: render_loss(params, target, camera, cfg,
                                           lambda_ssim), optimizer)
        return accumulate_stats(stats, params), loss

    return step
