"""Integrals: torch one-electron integrals (``core``, S/T/dipoles/cross
overlap), the host C++ engine (``native``: S, T, V, ERIs, DF) and AO->MO
transforms."""

from .core import dipole_integrals, kinetic, overlap, overlap_cross
from .transform import ao_to_mo_1e, ao_to_mo_eri

__all__ = ["overlap", "overlap_cross", "kinetic", "dipole_integrals",
           "ao_to_mo_1e", "ao_to_mo_eri"]
