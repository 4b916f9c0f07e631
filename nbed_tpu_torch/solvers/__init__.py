"""Solvers: spin-orbital CCSD and FCI on the main path, CIS/RPA excited
states with oscillator strengths and polarizabilities, MP2 and the PT2 term
of double hybrids, and the statevector VQE of the quantum outputs."""

from .ccsd import run_ccsd
from .cis import (CISResult, RPAResult, oscillator_strengths, polarizability, run_cis,
                  run_rpa, spin_labels)
from .fci import run_fci, sector_hamiltonian
from .mp2 import run_double_hybrid, run_mp2, run_pt2
from .vqe import (AdaptVQEResult, VQEResult, run_adapt_vqe, run_vqe,
                  uccsd_excitations, vqe_statevector)

__all__ = ["run_ccsd", "run_fci", "sector_hamiltonian", "run_cis", "run_rpa",
           "oscillator_strengths", "polarizability", "spin_labels", "CISResult",
           "RPAResult", "run_mp2", "run_pt2", "run_double_hybrid",
           "run_vqe", "run_adapt_vqe", "uccsd_excitations", "vqe_statevector",
           "VQEResult", "AdaptVQEResult"]
