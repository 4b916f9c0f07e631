"""nbed_tpu_torch: projection-based embedding on PyTorch and CUDA.

The port of the JAX package ``nbed_tpu`` (which stays as the reference) to
PyTorch on an NVIDIA H100. Each module mirrors the ``nbed_tpu`` module at
the same relative path; the fused J/K Fock build, the reference's one
Pallas kernel, is a hand-written CUDA kernel (``csrc/fused_jk.cu``). Every
entry point takes a ``device`` ("cuda" by default, "cpu" for tests) and
every tensor is float64 on the main path. The package imports neither JAX
nor the reference's config-validation library.
"""

from .config import NbedConfig
from .embed import nbed

__all__ = ["nbed", "NbedConfig"]

__version__ = "0.1.0"
