from gsrt_torch.scene.catalog import demo_gauss_splat, random_cloud

__all__ = ["demo_gauss_splat", "random_cloud"]
