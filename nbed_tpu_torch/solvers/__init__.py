"""Reference solvers: spin-orbital CCSD and FCI on the main path, MP2 and the
PT2 term of double hybrids."""

from .ccsd import run_ccsd
from .fci import run_fci
from .mp2 import run_double_hybrid, run_mp2, run_pt2

__all__ = ["run_ccsd", "run_fci", "run_mp2", "run_pt2", "run_double_hybrid"]
