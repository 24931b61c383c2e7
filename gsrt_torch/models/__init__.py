from gsrt_torch.models.gaussian_rt import (GaussianRayTracer, RenderOutput,
                                           render_fast, render_tiled)

__all__ = ["GaussianRayTracer", "RenderOutput", "render_fast",
           "render_tiled"]
