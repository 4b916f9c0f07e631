"""SCF: the spin-generic DIIS solver, the per-molecule engine and the
standalone Huzinaga SCF."""

from .engine import SCFEngine, SCFSolution, VeffResult
from .hf import SCFResult, huzinaga_operator, lowdin_x, make_rdm1, run_scf
from .huzinaga import huzinaga_scf

__all__ = ["SCFEngine", "SCFSolution", "VeffResult", "SCFResult", "run_scf",
           "make_rdm1", "lowdin_x", "huzinaga_operator", "huzinaga_scf"]
