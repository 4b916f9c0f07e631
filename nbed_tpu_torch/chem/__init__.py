"""Molecule, basis-set and AO-metadata layer (host-side, static shapes)."""

from .molecule import Molecule, build_molecule, parse_xyz
from .periodic import SYMBOL_TO_Z, Z_TO_SYMBOL

__all__ = ["Molecule", "build_molecule", "parse_xyz", "SYMBOL_TO_Z", "Z_TO_SYMBOL"]
