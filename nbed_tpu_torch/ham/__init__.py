"""Second-quantised Hamiltonian construction."""

from .builder import EQ_TOLERANCE, HamiltonianBuilder

__all__ = ["HamiltonianBuilder", "EQ_TOLERANCE"]
