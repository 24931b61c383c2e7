"""Interactive viewer: camera controller + HTTP frame server
(counterpart of `gsrt.viewer`)."""

from gsrt_torch.viewer.controller import CameraController
from gsrt_torch.viewer.server import ViewerServer

__all__ = ["CameraController", "ViewerServer"]
