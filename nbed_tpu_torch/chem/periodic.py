"""Periodic-table lookups, read from ``nbed_tpu/chem/periodic.py`` by path."""

from .._reference_files import load_module

_ref = load_module("chem/periodic.py")

SYMBOL_TO_Z = _ref.SYMBOL_TO_Z
Z_TO_SYMBOL = _ref.Z_TO_SYMBOL
BOHR_IN_ANGSTROM = _ref.BOHR_IN_ANGSTROM
ANGSTROM_TO_BOHR = _ref.ANGSTROM_TO_BOHR

__all__ = ["SYMBOL_TO_Z", "Z_TO_SYMBOL", "BOHR_IN_ANGSTROM", "ANGSTROM_TO_BOHR"]
