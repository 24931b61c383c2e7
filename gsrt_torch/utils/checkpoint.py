"""Checkpoint / resume (counterpart of `gsrt.utils.checkpoint`).

* scene checkpoints — a GaussianCloud's arrays (+ an optional prebuilt
  `ops.bvh.LBVH`) as one .npz with `gsrt`'s keys (`cloud_<field>`,
  `bvh_<field>`), so a scene saved by either package loads in the other;
* training checkpoints — the five `GaussianParams` arrays, the Adam state
  of `make_optimizer`'s groups (moments and step counts, through
  `interop.params_to_numpy` / `opt_state_to_numpy`), the groups' learning
  rates and the step, so a resumed run continues exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from gsrt_torch.core.types import GaussianCloud, resolve_device


def _npz(path: str) -> str:
    """np.savez appends '.npz' when missing but np.load does not — keep
    the round trip symmetric."""
    return path if path.endswith(".npz") else path + ".npz"


def save_scene(path: str, cloud: GaussianCloud, bvh=None) -> None:
    arrays = {f"cloud_{k}": v.detach().cpu().numpy()
              for k, v in cloud._asdict().items()}
    if bvh is not None:
        arrays.update({f"bvh_{k}": v.detach().cpu().numpy()
                       for k, v in bvh._asdict().items()})
    np.savez_compressed(path, **arrays)


def load_scene(path: str, device=None):
    """(cloud, bvh or None) on `device` (CUDA unless named)."""
    from gsrt_torch.ops.bvh import LBVH
    dev = resolve_device(device)
    with np.load(_npz(path)) as data:
        t = lambda k: torch.as_tensor(data[k], device=dev)  # noqa: E731
        cloud = GaussianCloud(**{k: t(f"cloud_{k}")
                                 for k in GaussianCloud._fields})
        bvh = (LBVH(**{k: t(f"bvh_{k}") for k in LBVH._fields})
               if "bvh_left" in data else None)
    return cloud, bvh


_PARAMS = ("means", "log_scales", "quats", "opacity_logit", "sh")


def save_training(path: str, params, optimizer, step: int) -> None:
    """GaussianParams + the `make_optimizer` Adam's state → npz."""
    from gsrt_torch.interop import opt_state_to_numpy, params_to_numpy
    arrays = {f"param_{k}": a for k, a in
              zip(_PARAMS, params_to_numpy(params))}
    mu, nu, count = opt_state_to_numpy(optimizer)
    for g, (m, v) in enumerate(zip(mu, nu)):
        arrays[f"adam_mu_{g}"], arrays[f"adam_nu_{g}"] = m, v
    arrays["adam_count"] = np.asarray(count, np.int64)
    arrays["lr"] = np.asarray([g["lr"] for g in optimizer.param_groups],
                              np.float64)
    arrays["step"] = np.asarray(step)
    np.savez_compressed(path, **arrays)


def load_training(path: str, device=None):
    """(params, optimizer, step) on `device` (CUDA unless named): the
    parameters and a `make_optimizer` Adam with the saved learning rates
    and state."""
    from gsrt_torch.interop import opt_state_from_numpy, params_from_numpy
    from gsrt_torch.models.trainer import make_optimizer
    with np.load(_npz(path)) as data:
        params = params_from_numpy(*(data[f"param_{k}"] for k in _PARAMS),
                                   device=device)
        lr = [float(x) for x in data["lr"]]
        optimizer = make_optimizer(
            params, lr_means=lr[0], lr_scales=lr[1], lr_quats=lr[2],
            lr_opacity=lr[3], lr_sh=lr[4])
        n = len(lr)
        opt_state_from_numpy(optimizer,
                             [data[f"adam_mu_{g}"] for g in range(n)],
                             [data[f"adam_nu_{g}"] for g in range(n)],
                             [int(c) for c in data["adam_count"]])
        step = int(data["step"])
    return params, optimizer, step
