"""Second-quantised Hamiltonians, qubit mappings, Z2 tapering and qubit
resource counts."""

from .builder import EQ_TOLERANCE, HamiltonianBuilder, reduce_virtuals
from .qubit import (
    MAPPINGS,
    PauliSum,
    bravyi_kitaev,
    jordan_wigner,
    measurement_groups,
    parity_transform,
    pauli_ground_state,
    pauli_sum_to_sparse,
)
from .resources import embedding_reduction, hamiltonian_resources
from .taper import Z2Symmetry, find_z2_symmetries, taper, taper_auto

__all__ = [
    "HamiltonianBuilder", "reduce_virtuals", "EQ_TOLERANCE",
    "jordan_wigner", "bravyi_kitaev", "parity_transform", "MAPPINGS",
    "PauliSum", "pauli_sum_to_sparse", "pauli_ground_state", "measurement_groups",
    "Z2Symmetry", "find_z2_symmetries", "taper", "taper_auto",
    "hamiltonian_resources", "embedding_reduction",
]
