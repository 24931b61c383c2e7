"""Plain PyTorch reference of the 3DGS training step: the render of
`splats.py` differentiated by hand in blocks of tiles, the 3DGS loss and
Adam. Imports nothing of the program.

Parameters are the standard 3DGS activations: Σ from normalised
quaternions and exp(log-scales), opacity = sigmoid(logit), colour from
SH. The loss is (1 − λ)·L1 + λ·(1 − SSIM) with SSIM over 11×11 mean
windows inside the image (the configuration's loss). Adam: β = (0.9,
0.999), ε = 1e-8 added outside the root, one learning rate per field.
The pairs' depth order, the footprints and the stop are constants of a
step, as in the 3DGS trainer.
"""

from __future__ import annotations

import torch

from benchmark.reference import splats
from benchmark.scene import cov3d

LEAVES = ("means", "log_scales", "quats", "opacity_logit", "sh")
SHAPE_LEAVES = LEAVES[:4]     # what a work count reads
BETAS, EPS = (0.9, 0.999), 1e-8


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c1, c2 = 0.01 ** 2, 0.03 ** 2

    def filt(x):
        y = torch.nn.functional.avg_pool2d(x.permute(2, 0, 1)[None], 11,
                                           stride=1)
        return y[0].permute(1, 2, 0)

    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a * mu_a
    var_b = filt(b * b) - mu_b * mu_b
    cov = filt(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return s.mean()


def image_loss(img, target, lambda_ssim: float) -> torch.Tensor:
    l1 = (img - target).abs().mean()
    return (1 - lambda_ssim) * l1 + lambda_ssim * (1 - ssim(img, target))


def loss_and_grads(params: dict, view, target, lambda_ssim: float, *,
                   dtype=torch.float32, consts=splats.CONSTS,
                   loss_rows: slice | None = None):
    """(loss, {leaf: gradient}) of one view; `loss_rows` takes the loss
    over those image rows only (a fault the check must catch)."""
    leaves = {k: params[k].detach().to(dtype).requires_grad_(True)
              for k in LEAVES}
    cov = cov3d(leaves["quats"], torch.exp(leaves["log_scales"]))
    p = splats.project(leaves["means"], cov,
                       torch.sigmoid(leaves["opacity_logit"]), leaves["sh"],
                       view, dtype=dtype, consts=consts)
    feat = splats.features(p)
    W, H = view.width, view.height
    with torch.no_grad():
        start, splat = splats.bin_pairs(
            {k: (v.detach() if torch.is_tensor(v) else v)
             for k, v in p.items()}, W, H, consts)
        img = splats.composite(feat.detach(), start, splat, W, H,
                               consts=consts)["color"]
    img = img.detach().requires_grad_(True)
    rows = loss_rows or slice(None)
    loss = image_loss(img[rows], target.to(dtype)[rows], lambda_ssim)
    dimg, = torch.autograd.grad(loss, img)
    gfeat = splats.composite(feat.detach(), start, splat, W, H,
                             consts=consts, dcolor=dimg)["grad"]
    torch.autograd.backward(feat, gfeat)
    return loss.detach(), {k: leaves[k].grad for k in LEAVES}


def train(params: dict, views, targets, lrs: dict, lambda_ssim: float,
          steps: int, *, dtype=torch.float32, consts=splats.CONSTS,
          loss_rows: slice | None = None):
    """`steps` Adam steps from `params`, one view a step. Returns (losses
    [steps], the first step's gradients, params after the last step)."""
    p = {k: params[k].detach().to(dtype).clone() for k in LEAVES}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    b1, b2 = BETAS
    for i in range(steps):
        loss, g = loss_and_grads(p, views[i], targets[i], lambda_ssim,
                                 dtype=dtype, consts=consts,
                                 loss_rows=loss_rows)
        losses.append(float(loss))
        if first is None:
            first = g
        t = i + 1
        with torch.no_grad():
            for k in LEAVES:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
                mh = m[k] / (1 - b1 ** t)
                vh = v2[k] / (1 - b2 ** t)
                p[k] = p[k] - lrs[k] * mh / (torch.sqrt(vh) + EPS)
    return losses, first, p


def counts(params: dict, view, consts=splats.CONSTS) -> dict:
    """The forward's work counts of one view at `params` (the
    SHAPE_LEAVES; `splats.composite`'s pairs_read and accepted, summed)."""
    with torch.no_grad():
        means = params["means"]
        cov = cov3d(params["quats"], torch.exp(params["log_scales"]))
        no_sh = torch.zeros((means.shape[0], 1, 3), device=means.device)
        p = splats.project(means, cov,
                           torch.sigmoid(params["opacity_logit"]), no_sh,
                           view, consts=consts, sh_degree=0)
        start, splat = splats.bin_pairs(p, view.width, view.height, consts)
        r = splats.composite(splats.features(p), start, splat, view.width,
                             view.height, consts=consts, count=True)
    return {k: int(r[k].sum()) for k in ("accepted", "pairs_read")}
