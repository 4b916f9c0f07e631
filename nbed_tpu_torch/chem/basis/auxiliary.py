"""Automatic even-tempered auxiliary basis for density fitting (port of
``nbed_tpu/chem/basis/auxiliary.py``).

A per-element even-tempered expansion spanning the product space of the
orbital basis, the standard fallback when no optimised fitting set is
available. Host numpy, like the rest of the shell tables. The auxiliary
shells reach l = 4 (f and g functions about every atom with p orbitals);
their solid harmonics come from :func:`..molecule._solid_harmonic_table`.
"""

from dataclasses import replace

import numpy as np

from ..molecule import Molecule, Shell, _normalise_shell

__all__ = ["make_auxiliary_molecule"]


def make_auxiliary_molecule(mol: Molecule, beta: float = 1.8,
                            l_max_factor: int = 3,
                            scheme: str = "global") -> Molecule:
    """Even-tempered auxiliary molecule over the same geometry.

    ``scheme="global"`` (default): one global [2*zeta_min, 2*zeta_max]
    range per element with the high end tapered by beta^l_aux, auxiliary
    angular momenta up to ``min(l_max_factor*l_max + 1, 4)``.

    ``scheme="product"``: per-l ranges from the single-centre product pairs
    (l1, l2) with |l1-l2| <= l_aux <= l1+l2 (the reference keeps it for
    comparison; it fits worse).
    """
    if scheme not in ("global", "product"):
        raise ValueError(f"scheme must be 'global' or 'product', got {scheme!r}")
    shells = []
    ao_offset = 0
    for ia in range(mol.natm):
        atom_shells = [s for s in mol.shells if s.atom == ia]
        l_max = max(s.l for s in atom_shells)
        l_top = min(l_max_factor * l_max + 1, 4)
        # per-l orbital exponent extents
        ext = {}
        for s in atom_shells:
            e = np.asarray(s.exps)
            lo, hi = ext.get(s.l, (np.inf, 0.0))
            ext[s.l] = (min(lo, e.min()), max(hi, e.max()))
        exps_all = np.concatenate([np.asarray(s.exps) for s in atom_shells])
        glo, ghi = 2.0 * exps_all.min(), 2.0 * exps_all.max()
        for l_aux in range(l_top + 1):
            if scheme == "product":
                pairs = [(l1, l2) for l1 in ext for l2 in ext
                         if abs(l1 - l2) <= l_aux <= l1 + l2]
                if not pairs:
                    continue
                lo = min(ext[l1][0] + ext[l2][0] for l1, l2 in pairs)
                hi = max(ext[l1][1] + ext[l2][1] for l1, l2 in pairs)
            else:
                lo, hi = glo, ghi / (beta ** l_aux)
            n_fn = max(1, int(np.ceil(np.log(max(hi / lo, 1.0001))
                                      / np.log(beta))) + 1)
            for a in lo * beta ** np.arange(n_fn):
                c, c2s = _normalise_shell(l_aux, np.array([a]), np.array([1.0]))
                shells.append(Shell(atom=ia, l=l_aux, exps=(float(a),),
                                    coeffs=tuple(c.tolist()),
                                    ao_offset=ao_offset, cart2sph=c2s))
                ao_offset += 2 * l_aux + 1
    return replace(mol, shells=tuple(shells), basis=f"auto-aux({mol.basis})")
