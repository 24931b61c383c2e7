from gsrt_torch.models.gaussian_rt import (GaussianRayTracer, RenderOutput,
                                           render_fast, render_tiled)
from gsrt_torch.models.tiled_diff import render_tiled_diff
from gsrt_torch.models.trainer import (GaussianParams, init_params,
                                       make_optimizer, random_init,
                                       train_step, train_step_tiled)

__all__ = ["GaussianRayTracer", "RenderOutput", "render_fast",
           "render_tiled", "render_tiled_diff", "GaussianParams",
           "init_params", "random_init", "make_optimizer", "train_step",
           "train_step_tiled"]
