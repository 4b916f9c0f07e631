"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""

from .jk import LAUNCHES, fused_jk, fused_jk_reference

__all__ = ["LAUNCHES", "fused_jk", "fused_jk_reference"]
