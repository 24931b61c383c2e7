"""The numbers that decide `correct`: the program's outputs against the
reference's, each reduced to one number that a limit holds."""

from __future__ import annotations

import statistics

import torch

from benchmark.reference import splats


def frame_numbers(color, trans, ref_color, ref_trans,
                  consts=splats.CONSTS) -> dict:
    """color_mae: the frame's mean |Δ colour|; tile_mae_max: the largest
    mean |Δ colour| of one tile (an answer altered in one place shows
    there); trans_mae: the mean |Δ transmittance|."""
    d = (color.float() - ref_color.float()).abs()
    H, W = d.shape[:2]
    tw, th = consts["tile_w"], consts["tile_h"]
    ntx, nty = splats.tile_grid(W, H, consts)
    pad = torch.zeros((nty * th, ntx * tw), device=d.device)
    cnt = torch.zeros_like(pad)
    pad[:H, :W] = d.mean(-1)
    cnt[:H, :W] = 1.0
    tiles = pad.reshape(nty, th, ntx, tw).sum((1, 3)) / \
        cnt.reshape(nty, th, ntx, tw).sum((1, 3))
    return dict(color_mae=float(d.mean()), tile_mae_max=float(tiles.max()),
                trans_mae=float((trans.float() - ref_trans.float())
                                .abs().mean()))


def worst(numbers: list[dict]) -> dict:
    """The largest of each number over several frames."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def left_out(ref_grads: dict) -> list:
    """Leaves whose reference gradient is nought to rounding: its norm
    under a thousandth of the median leaf's. Adam moves them by round-off
    alone, so the change compares the others."""
    norms = {k: float(v.double().norm()) for k, v in ref_grads.items()}
    med = statistics.median(norms.values())
    return [k for k, r in norms.items() if r < 1e-3 * med]


def leaf_gap(prog: dict, ref: dict, skip=()) -> float:
    """Worst leaf's |‖prog‖ − ‖ref‖| over max(‖ref leaf‖, the median
    leaf's ‖ref‖), over the leaves not in `skip`."""
    norms = {k: float(v.double().norm()) for k, v in ref.items()
             if k not in skip}
    med = statistics.median(norms.values())
    return max(abs(float(prog[k].double().norm()) - r) / max(r, med)
               for k, r in norms.items())


def with_limits(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number that has a limit."""
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in numbers.items() if k in limits}


def train_numbers(prog, ref, params0: dict) -> dict:
    """loss_gap: the largest relative gap of a step's loss; grad_gap and
    change_gap: `leaf_gaps` of the first gradient and of the parameters'
    change over the steps. prog and ref are (losses, first gradients,
    parameters after the steps)."""
    (lp, gp, pp), (lr, gr, pr) = prog, ref
    skip = left_out(gr)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
    grad_gap = leaf_gap(gp, gr, skip)
    change_gap = leaf_gap({k: pp[k].float() - params0[k] for k in gr},
                          {k: pr[k].float() - params0[k] for k in gr}, skip)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap)
