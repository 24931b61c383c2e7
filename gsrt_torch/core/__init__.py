from gsrt_torch.core.config import REFERENCE_DEMO, RenderConfig
from gsrt_torch.core.types import (Camera, GaussianCloud, look_at,
                                   make_camera, resolve_device)

__all__ = ["RenderConfig", "REFERENCE_DEMO", "GaussianCloud", "Camera",
           "make_camera", "look_at", "resolve_device"]
