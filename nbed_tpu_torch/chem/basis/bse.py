"""Basis Set Exchange (BSE) JSON parser (port of
``nbed_tpu/chem/basis/bse.py``).

The port bundles tables for STO-3G, 6-31G and cc-pVDZ and accepts any other
basis as a BSE-format JSON file read from the local disk (the standard
download format of basissetexchange.org; nothing is fetched):
``build_molecule(xyz, "/path/to/basis.json")`` or
``register_bse_basis(name, path)`` followed by ``basis=name``.

Supported: ``electron_shells`` with general contractions (multiple
coefficient rows per exponent block) and Pople-style sp/spd fused shells
(``angular_momentum`` lists with one coefficient row per l). ECPs are not
supported.
"""

import json
from pathlib import Path

__all__ = ["parse_bse_json", "register_bse_basis"]

_SYMBOLS = (
    "X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe "
    "Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In "
    "Sn Sb Te I Xe"
).split()


def parse_bse_json(path) -> dict:
    """Parse a BSE JSON file into ``{symbol: [(l, [(exp, coef), ...]), ...]}``
    (the registry shell layout of :mod:`nbed_tpu_torch.chem.basis`)."""
    data = json.loads(Path(path).read_text())
    try:
        elements = data["elements"]
    except KeyError as exc:
        raise ValueError(f"{path}: not a BSE JSON basis (no 'elements')") from exc
    table = {}
    for z_str, el in elements.items():
        z = int(z_str)
        sym = _SYMBOLS[z] if z < len(_SYMBOLS) else f"Z{z}"
        shells = []
        for sh in el.get("electron_shells", []):
            ams = sh["angular_momentum"]
            exps = [float(x) for x in sh["exponents"]]
            rows = [[float(c) for c in row] for row in sh["coefficients"]]
            if len(ams) == 1:
                # general contraction: one contracted function per row
                l = ams[0]
                for row in rows:
                    prims = [(e, c) for e, c in zip(exps, row) if c != 0.0]
                    if prims:
                        shells.append((l, prims))
            else:
                # fused sp/spd shell: one coefficient row per l
                if len(rows) != len(ams):
                    raise ValueError(
                        f"{path}: fused shell with {len(ams)} l-values but "
                        f"{len(rows)} coefficient rows"
                    )
                for l, row in zip(ams, rows):
                    prims = [(e, c) for e, c in zip(exps, row) if c != 0.0]
                    if prims:
                        shells.append((l, prims))
        if shells:
            table[sym] = shells
    return table


def register_bse_basis(name: str, path) -> None:
    """Load a BSE JSON file and make it available as ``basis=name``."""
    from . import _REGISTRY

    _REGISTRY[name.strip().lower()] = parse_bse_json(path)
