"""Integrals: torch integrals differentiable in the coordinates (``core``:
S, T, V, point charges, dipoles, cross overlap; ``eri``: the ERI tensor,
full range and long range), the host C++ engine (``native``: S, T, V,
ERIs, DF), which the SCF engine uses for its operators, and AO->MO
transforms."""

from .core import (dipole_integrals, kinetic, nuclear_attraction, overlap, overlap_cross,
                   point_charge_attraction)
from .eri import eri_tensor
from .transform import ao_to_mo_1e, ao_to_mo_eri

__all__ = ["overlap", "overlap_cross", "kinetic", "nuclear_attraction",
           "point_charge_attraction", "dipole_integrals", "eri_tensor",
           "ao_to_mo_1e", "ao_to_mo_eri"]
