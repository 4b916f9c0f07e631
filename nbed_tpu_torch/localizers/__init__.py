"""Orbital localization: occupied (SPADE, Pipek-Mezey, Boys, IBO), virtual
(concentric localization, PAO) and ACE-of-SPADE."""

from .ace import ACELocalizer
from .occupied import (BOYSLocalizer, IBOLocalizer, OccupiedLocalizer, PMLocalizer,
                       SPADELocalizer, check_values)
from .system import LocalizedSystem
from .virtual import ConcentricLocalizer, PAOLocalizer, VirtualLocalizer

__all__ = ["LocalizedSystem", "OccupiedLocalizer", "SPADELocalizer", "PMLocalizer",
           "BOYSLocalizer", "IBOLocalizer", "VirtualLocalizer", "ConcentricLocalizer",
           "PAOLocalizer",
           "ACELocalizer", "check_values"]
