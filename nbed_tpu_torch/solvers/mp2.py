"""Spin-orbital MP2 and the PT2 term of double hybrids (port of
``nbed_tpu/solvers/mp2.py``).

E(2) = 1/4 sum_{ijab} |<ij||ab>|^2 / (e_i + e_j - e_a - e_b) over the same
antisymmetrized spin-orbital integrals the CCSD solver reads, as torch ops
on the integrals' device. The contraction is a program, the counterpart of
the reference's ``@jax.jit _mp2_energy`` (``mp2.py:19-22``): <ij||ab> and
the orbital energies in buffers keyed by (no, nv, dtype, card), replayed as
a CUDA graph on the card (run uncaptured elsewhere), one host read.
"""

import numpy as np
import torch

from ..ops.programs import RUNS, Captured, cached_program, card, replay
from .ccsd import _antisymmetrized

__all__ = ["run_mp2", "run_pt2", "run_double_hybrid"]

# the programs of this process, keyed by (no, nv, dtype, card)
_PROGRAMS: dict = {}
_PROGRAMS_MAX = 8
# the private switch of the graph-against-eager holds: True runs the
# program (a CUDA graph on the card, uncaptured elsewhere), False the same
# contraction eager
_GRAPHED = True


def _ordered(so_h2, occ_mask):
    """(<pq||rs> with occupied spin orbitals first, n_occ, order)."""
    occ_mask = np.asarray(occ_mask, dtype=bool)
    order = np.concatenate([np.where(occ_mask)[0], np.where(~occ_mask)[0]])
    idx = torch.as_tensor(order, device=so_h2.device)
    w = _antisymmetrized(so_h2)[idx][:, idx][:, :, idx][:, :, :, idx]
    return w, int(occ_mask.sum()), idx


def _pt2_sum(w_oovv, eps, no: int):
    """E(2) as a device scalar from <ij||ab> and the orbital energies."""
    e_o, e_v = eps[:no], eps[no:]
    d2 = (e_o[:, None, None, None] + e_o[None, :, None, None]
          - e_v[None, None, :, None] - e_v[None, None, None, :])
    return 0.25 * torch.sum(w_oovv * w_oovv / d2)


class _PT2Program:
    """The E(2) contraction of one (no, nv, dtype, card): <ij||ab> and the
    orbital energies in buffers, one scalar output."""

    def __init__(self, no: int, nv: int, dtype, device):
        self.w = torch.zeros((no, no, nv, nv), dtype=dtype, device=device)
        self.eps = torch.zeros(no + nv, dtype=dtype, device=device)
        self.out = torch.zeros((), dtype=dtype, device=device)
        self.captured = Captured(lambda: self.out.copy_(_pt2_sum(self.w, self.eps, no)),
                                 device, [None])


def _pt2_energy(w, eps, no: int) -> float:
    w_oovv = w[:no, :no, no:, no:]
    if not _GRAPHED:
        return float(_pt2_sum(w_oovv.contiguous(), eps, no))
    nv = w_oovv.shape[-1]
    prog = cached_program(_PROGRAMS, _PROGRAMS_MAX, (no, nv, w.dtype, card(w.device)),
                          lambda: _PT2Program(no, nv, w.dtype, w.device))
    prog.w.copy_(w_oovv)
    prog.eps.copy_(eps)
    replay(prog.captured, "mp2")
    RUNS["host_reads"] += 1
    RUNS["mp2_host_reads"] += 1
    return float(prog.out)


def run_mp2(so_h1, so_h2, occ_mask):
    """MP2 correlation energy from spin-orbital integrals, with the
    canonical Fock rebuilt from them (exact for HF orbitals); arguments as
    :func:`nbed_tpu_torch.solvers.run_ccsd`. Returns (e_corr_mp2, e_hf_elec)."""
    w, no, idx = _ordered(so_h2, occ_mask)
    h1 = so_h1[idx][:, idx]
    o = slice(0, no)
    fock = h1 + torch.einsum("piqi->pq", w[:, o, :, o])
    e_ref = torch.trace(h1[o, o]) + 0.5 * torch.einsum("ijij->", w[o, o, o, o])
    return _pt2_energy(w, torch.diagonal(fock), no), float(e_ref)


def run_pt2(so_h2, eps_so, occ_mask):
    """PT2 correlation energy with given spin-orbital energies: the E(2) of
    :func:`run_mp2` with the converged KS eigenvalues in the denominators, as
    double hybrids take it (Grimme, JCP 124, 034108 (2006))."""
    w, no, idx = _ordered(so_h2, occ_mask)
    eps = torch.as_tensor(eps_so, dtype=so_h2.dtype, device=so_h2.device)[idx]
    return _pt2_energy(w, eps, no)


def run_double_hybrid(sol):
    """Total double-hybrid energy of a converged KS solution from
    ``SCFEngine(mol, xc=<double hybrid>)``: ``(e_tot, e_pt2)`` with
    ``e_tot = sol.e_tot + c_PT2 * e_pt2`` on the KS orbitals and
    eigenvalues; a restricted solution's one set serves both spins."""
    from ..dft.functionals import pt2_coefficient
    from ..ham import HamiltonianBuilder

    c2 = pt2_coefficient(getattr(sol.engine, "xc", None))
    if c2 == 0.0:
        raise ValueError(f"'{sol.engine.xc}' is not a double-hybrid functional.")
    _, _, h2 = HamiltonianBuilder(sol, 0).build()
    eps, occ = sol.mo_energy.expand(2, -1), sol.per_spin()[1].cpu().numpy()
    k = eps.shape[-1]
    eps_so = torch.empty(2 * k, dtype=eps.dtype, device=eps.device)
    eps_so[0::2], eps_so[1::2] = eps[0], eps[1]
    occ_mask = np.zeros(2 * k, dtype=bool)
    occ_mask[0::2] = occ[0] > 0
    occ_mask[1::2] = occ[1] > 0
    e_pt2 = run_pt2(h2, eps_so, occ_mask)
    return sol.e_tot + c2 * e_pt2, e_pt2
