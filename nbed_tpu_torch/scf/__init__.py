"""SCF: the spin-generic DIIS solver and the per-molecule engine."""

from .engine import SCFEngine, SCFSolution, VeffResult
from .hf import SCFResult, huzinaga_operator, lowdin_x, make_rdm1, run_scf

__all__ = ["SCFEngine", "SCFSolution", "VeffResult", "SCFResult", "run_scf",
           "make_rdm1", "lowdin_x", "huzinaga_operator"]
