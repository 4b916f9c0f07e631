"""Orbital localization on the main path: SPADE (occupied) and concentric
localization (virtual)."""

from .occupied import OccupiedLocalizer, SPADELocalizer, check_values
from .system import LocalizedSystem
from .virtual import ConcentricLocalizer

__all__ = ["LocalizedSystem", "OccupiedLocalizer", "SPADELocalizer",
           "ConcentricLocalizer", "check_values"]
