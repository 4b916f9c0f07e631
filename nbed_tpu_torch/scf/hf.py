"""Spin-generic SCF with DIIS (port of ``nbed_tpu/scf/hf.py``).

Density matrices carry a leading spin axis ``(2, n, n)``; the DIIS history
is a fixed ring buffer, as in the reference. The reference's
``lax.while_loop`` becomes a Python loop whose convergence test reads two
scalars back to the host each cycle. One J/K build per cycle goes through
the ``jk_fn`` hook (the engine passes the fused J/K kernel of
:mod:`nbed_tpu_torch.ops.jk`).

Not ported: the TPU-only Newton refinement of ``eigh`` (a no-op off the TPU,
``hf.py:63-66``), the incremental/f32 mixed-precision branches, ROHF and
the forward-mode tangent polish (ROADMAP queue 1 items 8 and 9).
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch

__all__ = ["SCFResult", "run_scf", "make_rdm1", "lowdin_x", "huzinaga_operator"]

DIIS_SPACE = 8  # Pulay history length (the reference's default)


@dataclass
class SCFResult:
    """Converged SCF data (always spin-resolved)."""

    mo_coeff: torch.Tensor  # (2, n, n)
    mo_energy: torch.Tensor  # (2, n)
    mo_occ: torch.Tensor  # (2, n) of 0/1 (electrons per spin orbital)
    dm: torch.Tensor  # (2, n, n)
    e_elec: float  # electronic energy (add nuclear repulsion for e_tot)
    converged: bool
    fock: torch.Tensor  # (2, n, n) final Fock (incl. v_emb + huzinaga)
    huzinaga_op: torch.Tensor  # (2, n, n) final Huzinaga operator (zeros if off)
    n_iter: int


def make_rdm1(mo_coeff, mo_occ):
    """D_sigma = C diag(occ) C^T with 0/1 spin-orbital occupations."""
    return torch.einsum("spi,si,sqi->spq", mo_coeff, mo_occ, mo_coeff)


def lowdin_x(s):
    """S^{-1/2} via eigh."""
    w, v = torch.linalg.eigh(s)
    return (v * (1.0 / torch.sqrt(w))[None, :]) @ v.T


def huzinaga_operator(fock, dm_occ_s, dm_virt_s):
    """-(F D S + S D F) per spin, plus the virtual-space variant
    (``nbed_tpu/scf/hf.py:91-106``)."""
    fds_occ = torch.einsum("sij,sjk->sik", fock, dm_occ_s)
    huz = -(fds_occ + fds_occ.transpose(-1, -2))
    fds_virt = torch.einsum("sij,sjk->sik", fock, dm_virt_s)
    huz_virt = -(
        fds_virt
        + fds_virt.transpose(-1, -2)
        - 2.0 * torch.einsum("sij,sjk->sik", dm_virt_s.transpose(-1, -2), fds_virt)
    )
    return huz + huz_virt


def _diis_extrapolate(hist_f, hist_e, nfill: int):
    """Pulay extrapolation over the filled slots of the ring buffer, with the
    reference's eigh pseudo-inverse and relative cut (``hf.py:260-292``)."""
    m = hist_f.shape[0]
    dtype, device = hist_f.dtype, hist_f.device
    flat_e = hist_e.reshape(m, -1)
    b = flat_e @ flat_e.T
    filled = (torch.arange(m, device=device) < nfill).to(dtype)
    b = b * (filled[:, None] * filled[None, :]) + torch.diag(1.0 - filled)
    big = torch.zeros((m + 1, m + 1), dtype=dtype, device=device)
    big[:m, :m] = b
    big[:m, m] = filled
    big[m, :m] = filled
    rhs = torch.zeros(m + 1, dtype=dtype, device=device)
    rhs[m] = 1.0
    ew, ev = torch.linalg.eigh(big)
    cut = torch.max(torch.abs(ew)) * max(1e-12, (m + 1) * torch.finfo(dtype).eps)
    inv_ew = torch.where(torch.abs(ew) > cut, 1.0 / ew, torch.zeros_like(ew))
    coef = ((ev * inv_ew[None, :]) @ (ev.T @ rhs))[:m] * filled
    return torch.einsum("h,hsij->sij", coef, hist_f)


def run_scf(
    *,
    hcore,  # (n, n) or (2, n, n)
    s,  # (n, n)
    nelec,  # (n_alpha, n_beta)
    jk_fn: Callable,  # dm (2,n,n) -> (j (n,n), k (2,n,n))
    v_emb=None,  # (2, n, n) embedding potential added to hcore
    xc_fn: Optional[Callable] = None,  # dm -> (exc, vxc (2,n,n))
    hyb: float = 1.0,  # HF-exchange fraction (1.0 = HF, 0.2 = B3LYP)
    dm_env_occ=None,  # (2, n, n) Huzinaga occupied env density (per spin)
    dm_env_virt=None,  # (2, n, n) Huzinaga virtual env density (per spin)
    dm0=None,  # (2, n, n) initial guess
    conv_tol: float = 1e-6,
    dm_conv_tol: float = 1e-6,
    max_cycle: int = 50,
    level_shift: float = 0.0,  # virtual-orbital level shift (Ha)
    rohf: bool = False,
) -> SCFResult:
    """Run SCF to convergence.

    Fock matrix: ``F_s = hcore + v_emb + J(D_tot) + Vxc_s - hyb*K(D_s)
    + Huz(F)``; energies follow the reference's embedded conventions (the
    Huzinaga term enters the one-body energy in full, ``v_emb`` is part of
    the core Hamiltonian).
    """
    if rohf:
        raise NotImplementedError(
            "ROHF/ROKS is not ported yet: ROADMAP queue 1 item 8.")
    n = s.shape[-1]
    if hcore.ndim == 2:
        hcore = torch.stack([hcore, hcore])
    if v_emb is None:
        v_emb = torch.zeros((2, n, n), dtype=hcore.dtype, device=hcore.device)
    elif v_emb.ndim == 2:
        v_emb = torch.stack([v_emb, v_emb])
    v_emb = v_emb.to(hcore.dtype)
    x = lowdin_x(s)
    h_eff = hcore + v_emb

    use_huz = dm_env_occ is not None
    if use_huz:
        dm_occ_s = torch.einsum("sij,jk->sik", dm_env_occ, s)
        if dm_env_virt is None:
            dm_virt_s = torch.zeros_like(dm_occ_s)
        else:
            dm_virt_s = torch.einsum("sij,jk->sik", dm_env_virt, s)

    na, nb = int(nelec[0]), int(nelec[1])
    ar = torch.arange(n, device=s.device)
    occ = torch.stack([(ar < na).to(s.dtype), (ar < nb).to(s.dtype)])

    def fock_and_energy(dm):
        """One J/K (+XC) build -> (F incl. huz, huz, e_elec of dm)."""
        j, k = jk_fn(dm)
        vhf = j[None] - hyb * k
        if xc_fn is not None:
            exc, vxc = xc_fn(dm)
            vhf = vhf + vxc
        else:
            exc = 0.0
        f0 = h_eff + vhf
        if use_huz:
            huz = huzinaga_operator(f0, dm_occ_s, dm_virt_s)
            f = f0 + huz
        else:
            huz = torch.zeros_like(f0)
            f = f0
        e1 = torch.einsum("sij,sji->", h_eff + huz, dm)
        ecoul = 0.5 * torch.einsum("ij,ji->", j, dm[0] + dm[1])
        ex_hf = -0.5 * hyb * torch.einsum("sij,sji->", k, dm)
        return f, huz, e1 + ecoul + ex_hf + exc

    def eig_fock(f):
        f_ortho = torch.einsum("pi,spq,qj->sij", x, f, x)
        mo_e, c_ortho = torch.linalg.eigh(f_ortho)
        return mo_e, torch.einsum("pi,sij->spj", x, c_ortho)

    if dm0 is None:
        # core-Hamiltonian guess (+projectors), as the reference's
        # Huzinaga loop does
        f_init = h_eff
        if use_huz:
            f_init = f_init + huzinaga_operator(f_init, dm_occ_s, dm_virt_s)
        _, c0 = eig_fock(f_init)
        dm0 = make_rdm1(c0, occ)

    m = DIIS_SPACE
    dm = dm0.to(h_eff.dtype)
    hist_f = torch.zeros((m, 2, n, n), dtype=dm.dtype, device=dm.device)
    hist_e = torch.zeros_like(hist_f)
    nfill = 0
    e_prev = float("inf")
    c = torch.zeros((2, n, n), dtype=dm.dtype, device=dm.device)
    mo_e = torch.zeros((2, n), dtype=dm.dtype, device=dm.device)
    conv = False
    cycle = 0
    while cycle < max_cycle and not conv:
        f, _, e_cur = fock_and_energy(dm)
        fds = torch.einsum("sij,sjk,kl->sil", f, dm, s)
        err = torch.einsum("pi,spq,qj->sij", x, fds - fds.transpose(-1, -2), x)
        slot = cycle % m
        hist_f[slot] = f
        hist_e[slot] = err
        nfill = min(nfill + 1, m)
        f_use = f
        if cycle > 0:
            f_use = _diis_extrapolate(hist_f, hist_e, nfill)
        if level_shift:
            # F' = F + lambda (S - S D_s S) shifts only the virtual
            # eigenvalues, damping occupied<->virtual oscillation
            sds = torch.einsum("ij,sjk,kl->sil", s, dm, s)
            f_use = f_use + level_shift * (s[None] - sds)
        mo_e, c = eig_fock(f_use)
        dm_new = make_rdm1(c, occ)
        e_cur = float(e_cur)
        de = abs(e_cur - e_prev)
        ddm = float(torch.max(torch.linalg.matrix_norm(dm_new - dm)))
        conv = de < conv_tol and ddm < dm_conv_tol
        e_prev = e_cur
        dm = dm_new
        cycle += 1

    f_fin, huz_fin, e_fin = fock_and_energy(dm)
    return SCFResult(
        mo_coeff=c, mo_energy=mo_e, mo_occ=occ, dm=dm, e_elec=float(e_fin),
        converged=conv, fock=f_fin, huzinaga_op=huz_fin, n_iter=cycle,
    )
