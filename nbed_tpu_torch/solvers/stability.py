"""SCF stability analysis and instability following (port of
``nbed_tpu/solvers/stability.py``).

The real internal orbital-rotation Hessian of a converged (possibly
embedded) SCF solution is ``A + B`` over the M_s-conserving singles,

    (A+B)[(ia),(jb)] = f_ab d_ij - f_ij d_ab + <aj||ib> + <ab||ij>,

assembled from the spin-orbital integrals as CIS assembles A, and
diagonalised on their device. A negative eigenvalue marks a saddle point:
:func:`rotate_towards` steps the orbitals along the unstable mode, and
:func:`stable_scf` re-converges downhill from there.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .._device import to_host
from .cis import _a_matrix, _pairs, _singles_frame

__all__ = ["run_stability", "rotate_towards", "stable_scf", "StabilityResult"]


@dataclass
class StabilityResult:
    """Orbital-rotation Hessian spectrum (ascending eigenvalues of A+B)."""

    eigenvalues: np.ndarray
    modes: np.ndarray  # (nroots, npairs) rotation directions
    pairs: np.ndarray  # (npairs, 2) (i, a) spin-orbital indices
    stable: bool

    @property
    def lowest(self) -> float:
        return float(self.eigenvalues[0])


def run_stability(so_h1, so_h2, occ_mask, nroots: int = 4,
                  tol: float = -1e-6) -> StabilityResult:
    """Internal (real) stability of the determinant behind the integrals.

    Args:
        so_h1, so_h2, occ_mask: as for :func:`run_cis` (the
            HamiltonianBuilder output and the interleaved occupation).
        nroots: how many lowest Hessian modes to return.
        tol: stable iff the lowest eigenvalue exceeds ``tol`` (slightly
            negative values are roundoff).
    """
    w, fock, _, i_idx, a_idx = _singles_frame(so_h1, so_h2, occ_mask)
    ab = _a_matrix(w, fock, i_idx, a_idx)
    ab = ab + w[a_idx[:, None], a_idx[None, :], i_idx[:, None], i_idx[None, :]]  # B
    vals, vecs = torch.linalg.eigh(ab)
    nroots = min(nroots, len(vals))
    return StabilityResult(
        eigenvalues=to_host(vals[:nroots]),
        modes=np.ascontiguousarray(to_host(vecs[:, :nroots]).T),
        pairs=_pairs(i_idx, a_idx),
        stable=bool(vals[0] > tol),
    )


def rotate_towards(scf_sol, result: StabilityResult, root: int = 0,
                   step: float = 0.3):
    """Per-spin (2, nao, nmo) coefficients ``C' = C exp(step * K)`` rotated
    along a Hessian mode (K antisymmetric from its amplitudes), on the
    solution's device. The solution's MOs must map 1:1 onto the spin
    orbitals of ``result``."""
    c = scf_sol.per_spin()[0]
    nmo = c.shape[-1]
    kappa = np.zeros((2, nmo, nmo))
    for (i, a), x in zip(result.pairs, result.modes[root]):
        s, p, q = int(i) % 2, int(i) // 2, int(a) // 2
        kappa[s, p, q] += x
        kappa[s, q, p] -= x
    expk = torch.linalg.matrix_exp(torch.as_tensor(step * kappa, dtype=c.dtype,
                                                   device=c.device))
    return c @ expk


def stable_scf(engine, sol=None, max_attempts: int = 3, step: float = 0.4,
               tol: float = -1e-6, **kernel_kwargs):
    """Converge to an internally stable SCF solution: check A+B stability
    and, while unstable, rotate along the lowest mode and re-converge from
    the rotated density (``engine.kernel(dm0=...)``), up to
    ``max_attempts`` times. The step doubles (up to pi/2) while the
    re-converged energy does not drop, since Roothaan+DIIS can flow back
    to the saddle. Returns ``(solution, stability_result)``."""
    from ..ham.builder import HamiltonianBuilder

    if sol is None:
        sol = engine.kernel(**kernel_kwargs)
    stab = None
    for _ in range(max_attempts):
        _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
        occ = sol.per_spin()[1]
        occ_h = to_host(occ)
        occ_mask = np.zeros(2 * occ_h.shape[-1], dtype=bool)
        occ_mask[::2] = occ_h[0] > 0
        occ_mask[1::2] = occ_h[1] > 0
        stab = run_stability(h1, h2, occ_mask, tol=tol)
        if stab.stable:
            return sol, stab
        improved = None
        s = step
        while s <= np.pi / 2 + 1e-12:
            c_new = rotate_towards(sol, stab, step=s)
            dm0 = torch.einsum("spk,sk,sqk->spq", c_new, occ, c_new)
            trial = engine.kernel(dm0=dm0, **kernel_kwargs)
            if trial.e_tot < sol.e_tot - 1e-10:
                improved = trial
                break
            s *= 2.0
        if improved is None:
            return sol, stab  # mode following failed to leave the saddle
        sol = improved
    return sol, stab
