"""Model zoo (PyTorch model builders for the torch-cuda filter backend)."""
from . import zoo
from .zoo import build, register_model
from . import vit  # noqa: F401,E402 — registers zoo://vit
from . import mobilenet  # noqa: F401,E402 — registers zoo://mobilenet_v2
from . import detection  # noqa: F401,E402 — ssd_mobilenet_v2, posenet, deeplab_v3
from . import transformer  # noqa: F401,E402 — registers zoo://gpt

__all__ = ["zoo", "build", "register_model", "vit", "mobilenet", "detection",
           "transformer"]
