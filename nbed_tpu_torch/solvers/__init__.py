"""Solvers: spin-orbital CCSD and FCI on the main path, MP2 and the PT2 term
of double hybrids, and the statevector VQE of the quantum outputs."""

from .ccsd import run_ccsd
from .fci import run_fci
from .mp2 import run_double_hybrid, run_mp2, run_pt2
from .vqe import (AdaptVQEResult, VQEResult, run_adapt_vqe, run_vqe,
                  uccsd_excitations, vqe_statevector)

__all__ = ["run_ccsd", "run_fci", "run_mp2", "run_pt2", "run_double_hybrid",
           "run_vqe", "run_adapt_vqe", "uccsd_excitations", "vqe_statevector",
           "VQEResult", "AdaptVQEResult"]
