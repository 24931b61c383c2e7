"""gsrt_torch — the PyTorch / CUDA port of gsrt for NVIDIA Hopper (H100).

A second package beside the JAX reference `gsrt`, with the same module
paths and public names. It imports torch and numpy only, never jax or
gsrt. Plain tensor code is PyTorch; each TPU Pallas kernel the ported
path runs is a hand-written CUDA kernel under `csrc/`, built at first use
by `_kernels` and launched on CUDA tensors, with a plain PyTorch version
beside it that CPU tensors take.

Ported so far: the tiled main path — projection and SH, group-stream
binning (the pair-expansion kernel), the packed group-stream blend
kernel, `render_tiled`, `render_fast` and `GaussianRayTracer` in "fast"
and "tiled" modes; training on the tiled path — the f32 tile stream,
the subtile blend and its backward kernel, `render_tiled_diff` and the
trainer (`GaussianParams`, `make_optimizer`, `train_step_tiled`), with
densification (`models.densify`), the multi-view fit
(`models.multiview.fit_views`) and COLMAP models (`scene.colmap`); and
serving — the compact tile stream, the packed blend's tile mode with
saturation tracking and exact hits, the exp LUT in every blend, the
(128, 8)-tile blend, the cutoff cull, `gsrt_torch.serving.ServingRenderer`
and `gsrt_torch.scene.campath`; and triangle ray tracing — the path
tracer's shadow (SH), ambient-occlusion (AO) and path-traced (PT) renders
over sphere, box and triangle scenes, the binned primary cast kernel and
the packed-cluster traversal kernel; and the paper's k-buffer path —
`GaussianRayTracer` in "reference" mode, free-ray and clustered splat
tracing (`models.gaussian_rt.trace_gaussian_rays`, `ops.splat_clusters`)
and splats inside path-traced scenes — with ellipse spans on the tiled
path; and the rest of the triangle and scene stack — cylinders,
Mandelbulbs, textures with mip pyramids, alpha cutouts, the tri-cluster
traversal, foveated PT, the catalog's scenes, OBJ / MTL and splat `.ply`
loaders (`scene.obj`, `scene.ply`, with the host library `native`),
instancing (`scene.instancing`), the LBVH (`ops.bvh`) and the reference
scenes (`scene.reference_scenes`). ROADMAP.md lists what remains.

Entry points run on CUDA unless the caller passes device="cpu".
"""

from gsrt_torch.core.config import REFERENCE_DEMO, RenderConfig
from gsrt_torch.core.types import Camera, GaussianCloud, look_at, make_camera

__version__ = "0.1.0"

__all__ = ["RenderConfig", "REFERENCE_DEMO", "GaussianCloud", "Camera",
           "make_camera", "look_at"]
