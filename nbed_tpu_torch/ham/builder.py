"""Second-quantised molecular Hamiltonian (port of ``nbed_tpu/ham/builder.py``).

``HamiltonianBuilder.build()`` returns ``(constant, h1, 0.5*h2)`` in
interleaved spin-orbital form (even = alpha, odd = beta), OpenFermion's
InteractionOperator convention:

    H = constant + sum_pq h1[p,q] a+_p a_q
               + sum_pqrs (0.5*h2)[p,q,r,s] a+_p a+_q a_r a_s.

``h1`` and ``h2`` are float64 tensors on the solution's device. With a
density-fitted engine the MO two-body blocks come from the DF factor, with
no O(nao^4) tensor. A restricted solution's (n, k) coefficients serve both
spins. ``n_frozen_virt`` drops the highest virtuals (:func:`reduce_virtuals`)
and ``n_frozen_core`` folds the lowest spatial orbitals in exactly
(``solvers.frozen.freeze_spinorbitals``).
"""

import numpy as np
import torch

from ..exceptions import HamiltonianBuilderError
from ..integrals import ao_to_mo_eri
from ..profiling import span

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
    """Active-space spin-orbital Hamiltonian of an (embedded) SCF solution,
    optionally with ``n_frozen_core`` spatial orbitals folded in and
    ``n_frozen_virt`` virtuals dropped (``nbed_tpu/ham/builder.py:28-158``)."""

    def __init__(self, scf_solution, constant_e_shift: float = 0.0,
                 n_frozen_core: int = 0, n_frozen_virt: int = 0):
        # reduced once here, so that build() may be called again
        self.scf = (reduce_virtuals(scf_solution, n_frozen_virt) if n_frozen_virt
                    else scf_solution)
        self.constant_e_shift = constant_e_shift
        self.n_frozen_core = n_frozen_core
        self.n_frozen_virt = n_frozen_virt

    def _one_body_integrals(self):
        """(2, k, k) per-spin MO one-body integrals, with the embedding
        potential through the solution's effective hcore."""
        c = self.scf.per_spin()[0]
        hcore = self.scf.get_hcore()
        if hcore.ndim == 2:
            hcore = torch.stack([hcore, hcore])
        return torch.stack([c[0].T @ hcore[0] @ c[0], c[1].T @ hcore[1] @ c[1]])

    def _two_body_integrals(self):
        """(4, k, k, k, k) physicist-notation blocks aaaa, bbbb, aabb, bbaa."""
        c = self.scf.per_spin()[0]
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
    def _spinorb_from_spatial(one_body, two_body, tolerance: float):
        """Interleave spatial spin blocks into spin-orbital tensors, with
        coefficients below ``tolerance`` zeroed."""
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
        h1[torch.abs(h1) < tolerance] = 0.0
        h2[torch.abs(h2) < tolerance] = 0.0
        return h1, h2

    def build(self):
        """``(constant, h1_spinorb, 0.5 * h2_spinorb)``, over the orbitals
        left after ``n_frozen_virt`` and ``n_frozen_core``."""
        with span("ham.build"):
            return self._build(EQ_TOLERANCE)

    def _build(self, tolerance: float):
        """:meth:`build` with coefficients below ``tolerance`` zeroed (0.0:
        the untruncated integrals)."""
        h1, h2 = self._spinorb_from_spatial(self._one_body_integrals(),
                                            self._two_body_integrals(), tolerance)
        constant, h2_half = self.constant_e_shift, 0.5 * h2
        if self.n_frozen_core:
            from ..solvers.frozen import freeze_spinorbitals

            # a restricted singly occupied orbital is alpha-only: the guard
            # below keeps it out of the frozen window
            occ = self.scf.per_spin()[1].cpu().numpy()
            m = h1.shape[0]
            occ_mask = np.zeros(m, dtype=bool)
            occ_mask[::2] = occ[0][: m // 2] > 0.5
            occ_mask[1::2] = occ[1][: m // 2] > 0.5
            nf = 2 * int(self.n_frozen_core)
            if nf > m or not occ_mask[:nf].all():
                raise HamiltonianBuilderError(
                    f"n_frozen_core={self.n_frozen_core} must select only "
                    "occupied spatial orbitals.")
            constant, h1, h2_half, _ = freeze_spinorbitals(
                constant, h1, h2_half, range(nf), occ_mask)
        return constant, h1, h2_half


def reduce_virtuals(scf_solution, n_frozen_virt: int):
    """A copy of the solution without its highest ``n_frozen_virt`` orbitals
    (per spin for an unrestricted one) (``nbed_tpu/ham/builder.py:161-179``)."""
    reduced = scf_solution.copy()
    if n_frozen_virt <= 0:
        return reduced
    if n_frozen_virt >= int(torch.count_nonzero(reduced.mo_occ)):
        raise ValueError("Atempting to reduce virtual space by more than exist.")
    reduced.mo_coeff = reduced.mo_coeff[..., :-n_frozen_virt]
    reduced.mo_occ = reduced.mo_occ[..., :-n_frozen_virt]
    reduced.mo_energy = reduced.mo_energy[..., :-n_frozen_virt]
    return reduced
