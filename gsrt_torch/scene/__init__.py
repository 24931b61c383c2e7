from gsrt_torch.scene.campath import dolly_path, interpolate_path, orbit_path
from gsrt_torch.scene.catalog import demo_gauss_splat, random_cloud
from gsrt_torch.scene.primitives_catalog import (cornell_box,
                                                  mirror_in_gaussians)

__all__ = ["demo_gauss_splat", "random_cloud", "orbit_path", "dolly_path",
           "interpolate_path", "cornell_box", "mirror_in_gaussians"]
