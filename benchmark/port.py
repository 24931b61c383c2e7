"""The benchmark's inputs in the port's types. The tensors are the
benchmark's own (made in `scene.py`); only the containers are the
port's."""

from __future__ import annotations

import numpy as np
import torch


def cloud(c, cov6):
    from gsrt_torch.core.types import GaussianCloud
    return GaussianCloud(means=c.means, cov3d=cov6, opacity=c.opacity,
                         sh=c.sh)


def camera(v, device):
    from gsrt_torch.core.types import Camera
    f32 = lambda x: torch.tensor(np.float32(x), device=device)
    return Camera(view=torch.as_tensor(v.view, device=device), fx=f32(v.fx),
                  fy=f32(v.fy), cx=f32(v.cx), cy=f32(v.cy), width=v.width,
                  height=v.height)


def render_config(config: dict):
    from gsrt_torch.core.config import RenderConfig
    return RenderConfig(width=config["width"], height=config["height"],
                        sh_degree=config["sh_degree"],
                        **config.get("render", {}))
