"""Molecular quadrature grids for XC integration."""

from .grid import MolecularGrid, build_grid, eval_aos

__all__ = ["MolecularGrid", "build_grid", "eval_aos"]
