"""Device and dtype policy shared by every entry point of the port."""

import numpy as np
import torch

__all__ = ["DTYPE", "resolve_device", "to_host"]

# nbed_tpu runs with jax_enable_x64: quantum chemistry needs ~1e-10 in the
# intermediate linear algebra to reach 1e-6 Ha end to end.
DTYPE = torch.float64


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises where CUDA is asked for and
    absent (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU."
            )
        # a float32 product must stay full float32 (TF32 keeps ~3 decimal
        # digits); the main path is float64, but the f32 kernel comparisons
        # and any f32 caller rely on this
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def to_host(a) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array (the
    host solvers' input)."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
