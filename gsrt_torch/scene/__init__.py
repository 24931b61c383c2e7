from gsrt_torch.scene.campath import dolly_path, interpolate_path, orbit_path
from gsrt_torch.scene.catalog import demo_gauss_splat, random_cloud
from gsrt_torch.scene.primitives_catalog import (
    cornell_box, cube_and_spheres, cubes_and_common_scene,
    cylinder_cubes_common_scene, mandelbulb_scene, mirror_in_gaussians,
    planets_in_one_weekend, ray_tracing_in_one_weekend, simple_test)

__all__ = ["demo_gauss_splat", "random_cloud", "orbit_path", "dolly_path",
           "interpolate_path", "cornell_box", "mirror_in_gaussians",
           "ray_tracing_in_one_weekend", "planets_in_one_weekend",
           "cube_and_spheres", "cubes_and_common_scene",
           "cylinder_cubes_common_scene", "mandelbulb_scene", "simple_test"]
