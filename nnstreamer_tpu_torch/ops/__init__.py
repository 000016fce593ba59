"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (the version a CPU tensor takes)."""
from .attention import attention_plain, dot_product_attention, fused_attention

__all__ = ["attention_plain", "dot_product_attention", "fused_attention"]
