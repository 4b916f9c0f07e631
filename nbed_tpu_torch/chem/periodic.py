"""Periodic-table lookups (H through Kr), the port's copy of
``nbed_tpu/chem/periodic.py``."""

_SYMBOLS = [
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
]

SYMBOL_TO_Z = {s: i + 1 for i, s in enumerate(_SYMBOLS)}
SYMBOL_TO_Z.update({s.upper(): i + 1 for i, s in enumerate(_SYMBOLS)})
Z_TO_SYMBOL = {i + 1: s for i, s in enumerate(_SYMBOLS)}

# CODATA-2010 Bohr, the value that reproduces the reference's
# nuclear-repulsion oracle exactly
BOHR_IN_ANGSTROM = 0.52917721092
ANGSTROM_TO_BOHR = 1.0 / BOHR_IN_ANGSTROM

__all__ = ["SYMBOL_TO_Z", "Z_TO_SYMBOL", "BOHR_IN_ANGSTROM", "ANGSTROM_TO_BOHR"]
