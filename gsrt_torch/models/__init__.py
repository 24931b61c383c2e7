from gsrt_torch.models.densify import (DensifyStats, densify_and_prune,
                                       init_stats, reset_opacity)
from gsrt_torch.models.gaussian_rt import (GaussianRayTracer, RenderOutput,
                                           render_fast, render_tiled)
from gsrt_torch.models.multiview import (ViewSet, fit_views,
                                         make_train_step_mv,
                                         viewset_from_cameras,
                                         viewset_from_colmap)
from gsrt_torch.models.path_tracer import (
    PrimitiveScene, render_ambient_occlusion, render_foveated,
    render_path_traced, render_path_traced_calibrated, render_shadow_rays,
    with_texture_mips, with_tri_clusters, with_tri_table)
from gsrt_torch.models.tiled_diff import render_tiled_diff
from gsrt_torch.models.trainer import (GaussianParams, init_params,
                                       make_optimizer,
                                       make_train_step_dp, random_init,
                                       train_step, train_step_tiled)

__all__ = ["GaussianRayTracer", "RenderOutput", "render_fast",
           "render_tiled", "render_tiled_diff", "GaussianParams",
           "init_params", "random_init", "make_optimizer", "train_step",
           "make_train_step_dp",
           "train_step_tiled", "PrimitiveScene", "with_tri_table",
           "with_tri_clusters", "with_texture_mips", "render_foveated",
           "render_path_traced", "render_path_traced_calibrated",
           "render_shadow_rays", "render_ambient_occlusion",
           "DensifyStats", "init_stats", "densify_and_prune",
           "reset_opacity", "ViewSet", "viewset_from_cameras",
           "viewset_from_colmap", "make_train_step_mv", "fit_views"]
