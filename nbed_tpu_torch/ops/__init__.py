"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""

from .jk import LAUNCHES, FusedJK, fused_jk, fused_jk_reference, prepare_jk

__all__ = ["LAUNCHES", "FusedJK", "fused_jk", "fused_jk_reference", "prepare_jk"]
