"""Solvers: spin-orbital CCSD(T) and FCI on the main path, CIS/RPA and
TDA/RPA-TDDFT excited states with oscillator strengths and polarizabilities,
SCF stability analysis, MP2 and the PT2 term of double hybrids, the
statevector VQE and quantum subspace expansion of the quantum outputs, and
the derivatives: analytic HF/KS nuclear gradients, geometry optimization,
finite-difference Hessians, IR intensities and RRHO thermochemistry."""

from .ccsd import run_ccsd
from .cis import (CISResult, RPAResult, oscillator_strengths, polarizability, run_cis,
                  run_rpa, spin_labels)
from .fci import run_fci, sector_hamiltonian
from .gradients import hf_gradient, ks_gradient, optimize_geometry
from .hessian import dipole_derivative_fd, harmonic_frequencies, hessian_fd, ir_intensities
from .mp2 import run_double_hybrid, run_mp2, run_pt2
from .qse import QSEResult, run_qse
from .stability import StabilityResult, rotate_towards, run_stability, stable_scf
from .tddft import run_tddft_rpa, run_tddft_tda
from .thermo import thermochemistry
from .vqe import (AdaptVQEResult, VQEResult, run_adapt_vqe, run_vqe,
                  uccsd_excitations, vqe_statevector)

__all__ = ["run_ccsd", "run_fci", "sector_hamiltonian", "run_cis", "run_rpa",
           "oscillator_strengths", "polarizability", "spin_labels", "CISResult",
           "RPAResult", "run_tddft_tda", "run_tddft_rpa", "run_mp2", "run_pt2",
           "run_double_hybrid", "run_vqe", "run_adapt_vqe", "uccsd_excitations",
           "vqe_statevector", "VQEResult", "AdaptVQEResult", "run_qse", "QSEResult",
           "run_stability", "rotate_towards", "stable_scf", "StabilityResult",
           "hf_gradient", "ks_gradient", "optimize_geometry", "harmonic_frequencies",
           "hessian_fd", "ir_intensities", "dipole_derivative_fd", "thermochemistry"]
