"""Reference solvers on the main path: spin-orbital CCSD and FCI."""

from .ccsd import run_ccsd
from .fci import run_fci

__all__ = ["run_ccsd", "run_fci"]
