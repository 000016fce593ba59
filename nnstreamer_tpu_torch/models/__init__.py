"""Model zoo (PyTorch model builders for the torch-cuda filter backend)."""
from . import zoo
from .zoo import build, register_model
from . import vit  # noqa: F401,E402 — registers zoo://vit

__all__ = ["zoo", "build", "register_model", "vit"]
