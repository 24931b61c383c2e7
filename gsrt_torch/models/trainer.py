"""Differentiable 3DGS rendering and optimisation (scene fitting).

Counterpart of `gsrt.models.trainer`. `render_loss` differentiates
`render_fast` (plain tensor code, O(splats × pixels));
`render_loss_tiled` differentiates the tiled path through its forward and
backward kernels (`gsrt_torch.models.tiled_diff`). The sort and cull
indices are constants of a step, as in the standard CUDA trainer.

PyTorch idiom where it differs from the JAX package: the parameters are
an `nn.Module`, the optimiser is one `torch.optim.Adam` that owns its
state, and a training step updates both in place and returns the loss.
`make_train_step_dp` takes the step over a mesh's row slabs
(`gsrt_torch.parallel`), averaging the slabs' gradients.
"""

from __future__ import annotations

import torch
from torch import nn

from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import Camera, GaussianCloud, resolve_device
from gsrt_torch.models.gaussian_rt import render_fast
from gsrt_torch.models.tiled_diff import render_tiled_diff
from gsrt_torch.ops.gaussian import quat_scale_to_cov3d
from gsrt_torch.utils.profiling import TRACER


class GaussianParams(nn.Module):
    """Trainable parameterisation (the standard 3DGS activations: exp for
    scales, sigmoid for opacity, normalised quaternions). The tensors are
    moved to `device` (CUDA unless named) and become the parameters."""

    def __init__(self, means, log_scales, quats, opacity_logit, sh,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        par = lambda t: nn.Parameter(
            t.detach().to(device=dev, dtype=torch.float32).clone())
        self.means = par(means)                  # [N, 3]
        self.log_scales = par(log_scales)        # [N, 3]
        self.quats = par(quats)                  # [N, 4]
        self.opacity_logit = par(opacity_logit)  # [N]
        self.sh = par(sh)                        # [N, K, 3]

    def to_cloud(self, stages=None) -> GaussianCloud:
        """The activated cloud. With `stages` (a traced step's
        `BackwardStages`) the leaves and the cloud's fields are marked, so
        that the backward of the activations is the stage
        `train.activate_bwd`."""
        means, log_scales, quats, opacity_logit, sh = (
            self.means, self.log_scales, self.quats, self.opacity_logit,
            self.sh)
        if stages is not None:
            means, log_scales, quats, opacity_logit, sh = stages.mark(
                None, means, log_scales, quats, opacity_logit, sh)
        cloud = GaussianCloud(
            means=means, cov3d=quat_scale_to_cov3d(quats,
                                                   torch.exp(log_scales)),
            opacity=torch.sigmoid(opacity_logit), sh=sh)
        if stages is not None:
            cloud = GaussianCloud(*stages.mark("train.activate_bwd", *cloud))
        return cloud


def init_params(cloud: GaussianCloud) -> GaussianParams:
    """Initialise from an existing cloud, on its device (isotropic scale
    estimate from the covariance trace; rotation reset to identity)."""
    tr = (cloud.cov3d[:, 0] + cloud.cov3d[:, 3] + cloud.cov3d[:, 5]) / 3.0
    s = torch.sqrt(torch.clamp_min(tr, 1e-12))
    quats = torch.zeros((cloud.n, 4), device=cloud.device)
    quats[:, 0] = 1.0
    op = torch.clamp(cloud.opacity, 1e-4, 1 - 1e-4)
    return GaussianParams(
        means=cloud.means, log_scales=torch.log(torch.stack([s, s, s], -1)),
        quats=quats, opacity_logit=torch.log(op / (1 - op)), sh=cloud.sh,
        device=cloud.device)


def random_init(generator: torch.Generator, n: int, extent: float = 3.0,
                z_offset: float = 4.0, sh_degree: int = 0, device=None
                ) -> GaussianParams:
    """n splats drawn from `generator` (on its device, then moved):
    uniform centers in ±extent pushed z_offset forward, scale 0.3, identity
    rotation, opacity ½, small normal SH."""
    dev = resolve_device(device)
    gdev = generator.device
    means = (torch.rand((n, 3), generator=generator, device=gdev) * 2.0
             - 1.0) * extent
    means[:, 2] += z_offset
    K = (sh_degree + 1) ** 2
    quats = torch.zeros((n, 4))
    quats[:, 0] = 1.0
    return GaussianParams(
        means=means,
        log_scales=torch.full((n, 3), 0.3).log(),
        quats=quats, opacity_logit=torch.zeros(n),
        sh=0.1 * torch.randn((n, K, 3), generator=generator, device=gdev),
        device=dev)


def _ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0
          ) -> torch.Tensor:
    """11×11 mean-window SSIM over [H, W, 3] images, windows inside the
    image only. The mean filter is `avg_pool2d`, which sums in float32 on
    every device (a float32 convolution would run in TF32 on the card)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def filt(x):
        y = nn.functional.avg_pool2d(x.permute(2, 0, 1)[None], 11, stride=1)
        return y[0].permute(1, 2, 0)

    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a ** 2
    var_b = filt(b * b) - mu_b ** 2
    cov = filt(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return s.mean()


def image_loss(img: torch.Tensor, target: torch.Tensor,
               lambda_ssim: float = 0.2) -> torch.Tensor:
    """The standard 3DGS loss: (1 − λ)·L1 + λ·(1 − SSIM); L1 alone for
    images narrower than the SSIM window."""
    l1 = (img - target).abs().mean()
    if lambda_ssim > 0 and min(img.shape[0], img.shape[1]) >= 11:
        return (1 - lambda_ssim) * l1 + lambda_ssim * (1 - _ssim(img, target))
    return l1


def render_loss(params: GaussianParams, target, camera: Camera,
                cfg: RenderConfig, lambda_ssim: float = 0.2):
    """`image_loss` of `render_fast` (white background, if any, already
    composited)."""
    with TRACER.span("train.activate"):
        cloud = params.to_cloud()
    out = render_fast(cloud, camera, cfg)
    with TRACER.span("train.loss"):
        return image_loss(out.color, target, lambda_ssim)


def render_loss_tiled(params: GaussianParams, target, camera: Camera,
                      cfg: RenderConfig, max_pairs: int,
                      lambda_ssim: float = 0.2, stages=None):
    """`render_loss` on the tiled path: scales to resolutions and splat
    counts whose residuals `render_fast` cannot hold. With `stages` (a
    traced step's `BackwardStages`) the backward runs as the stages
    `train.loss_bwd`, `train.blend_bwd` (the blend's own span),
    `train.project_bwd` and `train.activate_bwd`."""
    with TRACER.span("train.activate"):
        cloud = params.to_cloud(stages)
    img, _ = render_tiled_diff(cloud, camera, cfg, max_pairs, stages=stages)
    with TRACER.span("train.loss"):
        loss = image_loss(img, target, lambda_ssim)
    if stages is not None:
        loss, = stages.mark("train.loss_bwd", loss)
    return loss


def make_optimizer(params: GaussianParams, lr_means=1.6e-4, lr_scales=5e-3,
                   lr_quats=1e-3, lr_opacity=5e-2, lr_sh=2.5e-3
                   ) -> torch.optim.Adam:
    """One Adam with a parameter group per field (the INRIA learning-rate
    split); b1 = 0.9, b2 = 0.999, eps = 1e-8 added outside the root, as
    optax's adam."""
    groups = [(params.means, lr_means), (params.log_scales, lr_scales),
              (params.quats, lr_quats), (params.opacity_logit, lr_opacity),
              (params.sh, lr_sh)]
    return torch.optim.Adam([dict(params=[p], lr=lr) for p, lr in groups],
                            betas=(0.9, 0.999), eps=1e-8)


def _step(loss_fn, optimizer) -> torch.Tensor:
    """One step of loss_fn(stages): `stages` is the traced step's
    `BackwardStages` (None untraced), which the loss may mark."""
    with TRACER.span("train.step", root=True):
        optimizer.zero_grad(set_to_none=True)
        stages = TRACER.backward_stages()
        loss = loss_fn(stages)
        with TRACER.span("train.backward"):
            try:
                loss.backward()
            finally:
                if stages is not None:     # a backward that raised
                    stages.enter(None)
        with TRACER.span("train.optim"):
            optimizer.step()
    return loss.detach()


def train_step(params: GaussianParams, optimizer, target, camera: Camera,
               cfg: RenderConfig, lambda_ssim: float = 0.2) -> torch.Tensor:
    """One optimiser step on `render_loss`; updates params and the
    optimiser in place and returns the loss before the step."""
    return _step(lambda _: render_loss(params, target, camera, cfg,
                                       lambda_ssim), optimizer)


def train_step_tiled(params: GaussianParams, optimizer, target,
                     camera: Camera, cfg: RenderConfig, max_pairs: int,
                     lambda_ssim: float = 0.2) -> torch.Tensor:
    """One optimiser step on `render_loss_tiled`; updates params and the
    optimiser in place and returns the loss before the step. Raises when
    the view needs more than max_pairs pairs."""
    return _step(lambda stages: render_loss_tiled(
        params, target, camera, cfg, max_pairs, lambda_ssim, stages),
        optimizer)


def make_train_step_dp(cfg: RenderConfig, optimizer, mesh,
                       lambda_ssim: float = 0.2):
    """Data-parallel training step over the mesh's 'tiles' axis
    (`gsrt_torch.parallel.make_render_mesh`): each row slab renders
    through `render_fast` on its row's first device with a shifted camera
    and is differentiated alone (SSIM windows stay inside a slab, and
    only where the slab is at least 11 pixels each way); the slabs'
    gradients and losses are averaged, written to the parameters' .grad,
    and the optimiser steps.

    Returns step(params, target [H, W, 3], camera) → the mean loss before
    the step; params and the optimiser are updated in place."""
    from gsrt_torch.parallel.tiles import _slab_camera
    if mesh.spans_processes:
        raise ValueError("make_train_step_dp runs on a mesh of this "
                         "process's devices")
    n_tiles = mesh.shape["tiles"]

    def step(params: GaussianParams, target, camera: Camera):
        if camera.height % n_tiles:
            raise ValueError("the image height must divide the tile axis")
        slab_h = camera.height // n_tiles
        slab_cfg = cfg.replace(height=slab_h)
        leaves = list(params.parameters())
        home = leaves[0].device
        loss_sum, grad_sum = None, None
        for i in range(n_tiles):
            dev = mesh.devices[i][0]
            cam = _slab_camera(camera, i * slab_h, slab_h).to(dev)
            out = render_fast(params.to_cloud().to(dev), cam, slab_cfg)
            loss = image_loss(out.color,
                              target[i * slab_h:(i + 1) * slab_h].to(dev),
                              lambda_ssim)
            grads = [g.to(home) for g in torch.autograd.grad(loss, leaves)]
            loss = loss.detach().to(home)
            if grad_sum is None:
                loss_sum, grad_sum = loss, grads
            else:
                loss_sum = loss_sum + loss
                grad_sum = [a + b for a, b in zip(grad_sum, grads)]
        for p, g in zip(leaves, grad_sum):
            p.grad = g / n_tiles
        optimizer.step()
        return loss_sum / n_tiles

    return step
