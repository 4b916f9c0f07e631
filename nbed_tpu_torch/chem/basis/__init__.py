"""Gaussian basis-set registry (port of ``nbed_tpu/chem/basis/__init__.py``).

The STO-3G, 6-31G and cc-pVDZ tables are the port's copies of the
reference's data modules (``data_sto3g.py``, ``data_631g.py``,
``data_ccpvdz.py``). ``SHELLS = registry[basis][symbol]`` is a list of
``(l, [(exponent, coefficient), ...])`` contracted shells with published
coefficients; normalisation happens at molecule-build time. Any other basis
comes from a Basis Set Exchange JSON file on the local disk (:mod:`.bse`).
"""

import os
import warnings

from .data_631g import P631G
from .data_ccpvdz import CCPVDZ, CCPVDZ_GENERATED
from .data_sto3g import STO3G

__all__ = ["available_basis_sets", "get_element_shells"]

_REGISTRY = {
    "sto-3g": STO3G,
    "sto3g": STO3G,
    "6-31g": P631G,
    "631g": P631G,
    "cc-pvdz": CCPVDZ,
    "ccpvdz": CCPVDZ,
}


def available_basis_sets() -> list[str]:
    """Names accepted by :func:`get_element_shells`."""
    return ["6-31g", "cc-pvdz", "sto-3g"]


def get_element_shells(basis: str, symbol: str):
    """The contracted shells of ``symbol`` in basis ``basis``.

    ``basis`` may also be the path of a Basis Set Exchange JSON file, parsed
    on first use and registered under its path. Looking up a cc-pVDZ entry
    of ``CCPVDZ_GENERATED`` (F and the second row, re-derived by the
    construction rule) warns, as the reference does.

    Raises:
        KeyError: for unknown basis names or unsupported elements.
    """
    key = basis.strip().lower().replace("*", "(d)")
    if key not in _REGISTRY and key.endswith(".json") and os.path.exists(basis.strip()):
        from .bse import parse_bse_json

        _REGISTRY[key] = parse_bse_json(basis.strip())
    try:
        table = _REGISTRY[key]
    except KeyError as exc:
        raise KeyError(
            f"Basis set '{basis}' not available. Have: {available_basis_sets()} "
            f"(or pass a Basis Set Exchange JSON file path)."
        ) from exc
    sym = symbol.capitalize()
    if table is CCPVDZ and sym in CCPVDZ_GENERATED:
        warnings.warn(
            f"cc-pVDZ entry for {sym} is re-derived by the Dunning "
            "construction rule, NOT the published Woon-Dunning table; expect "
            "atomic energies 20-60 mHa above the published set (DZ quality "
            "preserved). Pass a Basis Set Exchange JSON path for the exact "
            "published data.",
            stacklevel=3,
        )
    try:
        return table[sym]
    except KeyError as exc:
        raise KeyError(f"Element '{symbol}' not available in basis '{basis}'.") from exc
