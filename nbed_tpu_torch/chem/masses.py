"""Atomic masses (most-abundant isotope, in unified amu): the port's copy
of ``nbed_tpu/chem/masses.py``.

Used for mass-weighting vibrational Hessians (``solvers/hessian.py``) and
for the rigid-rotor moments of ``solvers/thermo.py``. Values are the
standard isotopic masses (CODATA/AME).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ISOTOPE_MASS_AMU", "AMU_TO_ME", "atom_masses_me"]

# most-abundant-isotope masses, amu
ISOTOPE_MASS_AMU = {
    "H": 1.00782503207,
    "He": 4.00260325415,
    "Li": 7.01600455,
    "Be": 9.0121822,
    "B": 11.0093054,
    "C": 12.0,
    "N": 14.0030740048,
    "O": 15.9949146196,
    "F": 18.99840322,
    "Ne": 19.9924401754,
    "Na": 22.9897692809,
    "Mg": 23.9850417,
    "Al": 26.98153863,
    "Si": 27.9769265325,
    "P": 30.97376163,
    "S": 31.97207100,
    "Cl": 34.96885268,
    "Ar": 39.9623831225,
}

AMU_TO_ME = 1822.888486209  # electron masses per amu


def atom_masses_me(mol) -> np.ndarray:
    """Per-atom masses in electron-mass units, shape (natm,)."""
    try:
        return np.array(
            [ISOTOPE_MASS_AMU[sym] * AMU_TO_ME for sym in mol.symbols]
        )
    except KeyError as exc:
        raise KeyError(
            f"No mass tabulated for element {exc}; extend "
            "nbed_tpu_torch.chem.masses.ISOTOPE_MASS_AMU."
        ) from exc
