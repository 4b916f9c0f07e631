"""Second-quantised molecular Hamiltonian (port of ``nbed_tpu/ham/builder.py``).

``HamiltonianBuilder.build()`` returns ``(constant, h1, 0.5*h2)`` in
interleaved spin-orbital form (even = alpha, odd = beta), OpenFermion's
InteractionOperator convention:

    H = constant + sum_pq h1[p,q] a+_p a_q
               + sum_pqrs (0.5*h2)[p,q,r,s] a+_p a+_q a_r a_s.

``h1`` and ``h2`` are float64 tensors on the solution's device. With a
density-fitted engine the MO two-body blocks come from the DF factor, with
no O(nao^4) tensor. Not ported: the builder's ``n_frozen_core`` and
``n_frozen_virt`` arguments (ROADMAP queue 1 item 11); the reductions they
apply are ``solvers.frozen.freeze_spinorbitals`` and :func:`reduce_virtuals`.
"""

import torch

from ..exceptions import HamiltonianBuilderError
from ..integrals import ao_to_mo_eri

__all__ = ["HamiltonianBuilder", "EQ_TOLERANCE", "reduce_virtuals"]

# OpenFermion's default coefficient truncation threshold.
EQ_TOLERANCE = 1e-8


def _df_mo_factor(b, c):
    """MO DF factor as a (k*k, naux) matrix, row (i, j) = (C^T B_P C)[i, j]
    for the (nao, naux, nao) factor ``b`` and MO coefficients ``c``."""
    nao, naux, k = b.shape[0], b.shape[1], c.shape[1]
    x = (b.reshape(nao * naux, nao) @ c).reshape(nao, naux * k)  # [a, (P, j)]
    y = (c.T @ x).reshape(k, naux, k)  # [i, P, j]
    return y.permute(0, 2, 1).reshape(k * k, naux)


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
        engine = self.scf.engine
        if engine.density_fitting:
            b = engine.df_factor()
            ba, bb = _df_mo_factor(b, ca), _df_mo_factor(b, cb)
            chem = (x @ y.T for x, y in ((ba, ba), (bb, bb), (ba, bb), (bb, ba)))
        else:
            chem = (ao_to_mo_eri(engine.eri, c1, c1, c2, c2)
                    for c1, c2 in ((ca, ca), (cb, cb), (ca, cb), (cb, ca)))
        k = ca.shape[1]
        # chemist -> physicist
        return torch.stack([t.reshape(k, k, k, k).permute(0, 2, 3, 1) for t in chem])

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


def reduce_virtuals(scf_solution, n_frozen_virt: int):
    """A copy of the solution without its highest ``n_frozen_virt`` orbitals
    per spin (``nbed_tpu/ham/builder.py:161-179``)."""
    reduced = scf_solution.copy()
    if n_frozen_virt <= 0:
        return reduced
    if n_frozen_virt >= int(torch.count_nonzero(reduced.mo_occ)):
        raise ValueError("Atempting to reduce virtual space by more than exist.")
    reduced.mo_coeff = reduced.mo_coeff[:, :, :-n_frozen_virt]
    reduced.mo_occ = reduced.mo_occ[:, :-n_frozen_virt]
    reduced.mo_energy = reduced.mo_energy[:, :-n_frozen_virt]
    return reduced
