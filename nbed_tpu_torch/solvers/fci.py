"""Exact diagonalisation in a fixed (n_alpha, n_beta) sector.

The solver is ``nbed_tpu/solvers/fci.py`` itself (numpy/scipy, host), read
by path: it imports nothing of JAX or of its package. Tensors given here
are copied to host numpy first.
"""

import numpy as np
import torch

from .._reference_files import load_module

__all__ = ["run_fci"]

_ref = load_module("solvers/fci.py")


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def run_fci(constant, h1, h2, n_spinorb: int, nelec: tuple, k: int = 1):
    """Lowest-k eigenvalues of the sector Hamiltonian and the basis
    bitstrings; ``h2`` is the HamiltonianBuilder's ``0.5*h2`` coefficient tensor."""
    return _ref.run_fci(float(constant), _host(h1), _host(h2), n_spinorb, nelec, k=k)
