"""Gaussian basis-set registry (port of ``nbed_tpu/chem/basis/__init__.py``).

The STO-3G and 6-31G tables are the port's copies of the reference's data
modules (``data_sto3g.py``, ``data_631g.py``). ``SHELLS =
registry[basis][symbol]`` is a list of ``(l, [(exponent, coefficient),
...])`` contracted shells with published coefficients; normalisation
happens at molecule-build time.
"""

from .data_631g import P631G
from .data_sto3g import STO3G

__all__ = ["available_basis_sets", "get_element_shells"]

_TABLES = {"sto-3g": STO3G, "sto3g": STO3G, "6-31g": P631G, "631g": P631G}
_NOT_PORTED = "ROADMAP queue 1 item 14 (basis tables: cc-pVDZ, Basis Set Exchange JSON)"


def available_basis_sets() -> list[str]:
    """Names accepted by :func:`get_element_shells`."""
    return ["6-31g", "sto-3g"]


def get_element_shells(basis: str, symbol: str):
    """The contracted shells of ``symbol`` in basis ``basis``.

    Raises:
        NotImplementedError: for cc-pVDZ and Basis Set Exchange JSON files.
        KeyError: for other unknown basis names or unsupported elements.
    """
    key = basis.strip().lower().replace("*", "(d)")
    if key in ("cc-pvdz", "ccpvdz") or key.endswith(".json"):
        raise NotImplementedError(f"basis {basis!r} is not ported yet: {_NOT_PORTED}.")
    try:
        table = _TABLES[key]
    except KeyError as exc:
        raise KeyError(
            f"Basis set '{basis}' not available. Have: {available_basis_sets()}."
        ) from exc
    try:
        return table[symbol.capitalize()]
    except KeyError as exc:
        raise KeyError(f"Element '{symbol}' not available in basis '{basis}'.") from exc
