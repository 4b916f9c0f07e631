"""Second-quantised molecular Hamiltonian (port of the exact-ERI branch of
``nbed_tpu/ham/builder.py``).

``HamiltonianBuilder.build()`` returns ``(constant, h1, 0.5*h2)`` in
interleaved spin-orbital form (even = alpha, odd = beta), OpenFermion's
InteractionOperator convention:

    H = constant + sum_pq h1[p,q] a+_p a_q
               + sum_pqrs (0.5*h2)[p,q,r,s] a+_p a+_q a_r a_s.

``h1`` and ``h2`` are float64 tensors on the solution's device. Not ported:
the density-fitted branch and frozen-orbital reduction (ROADMAP queue 1
items 7 and 11).
"""

import torch

from ..exceptions import HamiltonianBuilderError
from ..integrals import ao_to_mo_eri

__all__ = ["HamiltonianBuilder", "EQ_TOLERANCE"]

# OpenFermion's default coefficient truncation threshold.
EQ_TOLERANCE = 1e-8


class HamiltonianBuilder:
    """Active-space spin-orbital Hamiltonian of an (embedded) SCF solution."""

    def __init__(self, scf_solution, constant_e_shift: float = 0.0):
        self.scf = scf_solution
        self.constant_e_shift = constant_e_shift

    def _one_body_integrals(self):
        """(2, k, k) per-spin MO one-body integrals, with the embedding
        potential through the solution's effective hcore."""
        c = self.scf.mo_coeff
        hcore = self.scf.get_hcore()
        if hcore.ndim == 2:
            hcore = torch.stack([hcore, hcore])
        return torch.stack([c[0].T @ hcore[0] @ c[0], c[1].T @ hcore[1] @ c[1]])

    def _two_body_integrals(self):
        """(4, k, k, k, k) physicist-notation blocks aaaa, bbbb, aabb, bbaa."""
        c = self.scf.mo_coeff
        if c[0].shape[1] != c[1].shape[1]:
            raise HamiltonianBuilderError(
                "Must localize the same number of alpha and beta orbitals.")
        ca, cb = c[0], c[1]
        eri_ao = self.scf.engine.eri
        blocks = []
        for c1, c2 in ((ca, ca), (cb, cb), (ca, cb), (cb, ca)):
            chem = ao_to_mo_eri(eri_ao, c1, c1, c2, c2)
            blocks.append(chem.permute(0, 2, 3, 1))  # chemist -> physicist
        return torch.stack(blocks)

    @staticmethod
    def _spinorb_from_spatial(one_body, two_body):
        """Interleave spatial spin blocks into spin-orbital tensors."""
        k = one_body[0].shape[0]
        nq = 2 * k
        h1 = one_body.new_zeros((nq, nq))
        h1[::2, ::2] = one_body[0]
        h1[1::2, 1::2] = one_body[1]
        h2 = one_body.new_zeros((nq, nq, nq, nq))
        h2[::2, ::2, ::2, ::2] = two_body[0]  # aaaa
        h2[1::2, 1::2, 1::2, 1::2] = two_body[1]  # bbbb
        h2[::2, 1::2, 1::2, ::2] = two_body[2]  # abba (physicist mixed)
        h2[1::2, ::2, ::2, 1::2] = two_body[3]  # baab
        h1[torch.abs(h1) < EQ_TOLERANCE] = 0.0
        h2[torch.abs(h2) < EQ_TOLERANCE] = 0.0
        return h1, h2

    def build(self):
        """``(constant, h1_spinorb, 0.5 * h2_spinorb)``."""
        h1, h2 = self._spinorb_from_spatial(self._one_body_integrals(),
                                            self._two_body_integrals())
        return self.constant_e_shift, h1, 0.5 * h2
