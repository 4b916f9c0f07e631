"""Frozen-orbital reduction of spin-orbital Hamiltonians (port of
``nbed_tpu/solvers/frozen.py``), in torch on the integrals' device.

Frozen occupied spin orbitals contribute their mean-field energy and fold
their Coulomb/exchange field into the one-body integrals of the remaining
space; frozen virtuals are dropped. This serves the ``frozen=[...]``
arguments of the embedded solvers (``driver.run_emb_ccsd``, ``run_emb_fci``,
``run_emb_cis``, ``run_emb_rpa``).
"""

import numpy as np
import torch

from .ccsd import _antisymmetrized

__all__ = ["freeze_spinorbitals"]


def freeze_spinorbitals(constant, h1, h2, frozen, occ_mask):
    """Fold frozen spin orbitals into (constant, h1, h2).

    Args:
        constant, h1, h2: interaction-operator terms (h2 the coefficient of
            a+a+aa, the HamiltonianBuilder's 0.5-scaled tensor), h1 and h2
            float64 tensors.
        frozen: spin-orbital indices to freeze. Frozen occupied orbitals
            (per ``occ_mask``) are folded into the constant and one-body
            terms; frozen virtuals are dropped.
        occ_mask: boolean (M,) numpy occupied mask.

    Returns:
        (constant', h1', h2', occ_mask') over the reduced space; the masks
        stay numpy, the tensors on their device.
    """
    occ_mask = np.asarray(occ_mask, dtype=bool)
    m = h1.shape[0]
    frozen = sorted(set(int(i) for i in frozen))
    active = torch.tensor([i for i in range(m) if i not in frozen], dtype=torch.long,
                          device=h1.device)
    frozen_occ = torch.tensor([i for i in frozen if occ_mask[i]], dtype=torch.long,
                              device=h1.device)

    const = float(constant)
    if len(frozen_occ):
        w = _antisymmetrized(h2)  # <pq||rs>
        const += float(torch.sum(torch.diagonal(h1[frozen_occ][:, frozen_occ])))
        w_ff = w[frozen_occ][:, frozen_occ][:, :, frozen_occ][:, :, :, frozen_occ]
        const += 0.5 * float(torch.einsum("ijij->", w_ff))
        h1 = h1 + torch.einsum("piqi->pq", w[:, frozen_occ][:, :, :, frozen_occ])

    h1_red = h1[active][:, active]
    h2_red = h2[active][:, active][:, :, active][:, :, :, active]
    return const, h1_red, h2_red, occ_mask[active.cpu().numpy()]
