"""Spin-orbital CCSD with Stanton-Gauss-Watts-Bartlett intermediates (port
of ``nbed_tpu/solvers/ccsd.py``, float64 only).

The amplitude equations run as torch einsums on the integrals' device; the
reference's on-device ``lax.while_loop`` becomes a Python loop with the
same Pulay-DIIS ring buffer and a host convergence test each cycle.

Not ported: the ``"f32"``/``"mixed"`` precision modes (TPU defaults, ROADMAP
queue 1 item 9) and the perturbative (T) correction (item 11).
"""

import logging

import torch

__all__ = ["run_ccsd"]

logger = logging.getLogger(__name__)

DIIS_DIM = 6  # amplitude-DIIS history length (the reference's default)


def _antisymmetrized(so_h2):
    """<pq||rs> from the HamiltonianBuilder's a+a+aa coefficient tensor:
    coeff[p,q,r,s] = 0.5 * <pq|sr>  =>  <pq|rs> = 2 * coeff[p,q,s,r]."""
    v = 2.0 * so_h2.permute(0, 1, 3, 2)
    return v - v.permute(0, 1, 3, 2)


def _ccsd_step(t1, t2, f, w, d1, d2, no: int, nv: int):
    """One amplitude update -> (t1_new, t2_new, e_corr)."""
    o = slice(0, no)
    v = slice(no, no + nv)
    es = torch.einsum

    tau_t = t2 + 0.5 * (es("ia,jb->ijab", t1, t1) - es("ib,ja->ijab", t1, t1))
    tau = t2 + (es("ia,jb->ijab", t1, t1) - es("ib,ja->ijab", t1, t1))

    fae = f[v, v] - torch.diag(torch.diag(f[v, v]))
    fae = fae - 0.5 * es("me,ma->ae", f[o, v], t1)
    fae = fae + es("mf,mafe->ae", t1, w[o, v, v, v])
    fae = fae - 0.5 * es("mnaf,mnef->ae", tau_t, w[o, o, v, v])

    fmi = f[o, o] - torch.diag(torch.diag(f[o, o]))
    fmi = fmi + 0.5 * es("ie,me->mi", t1, f[o, v])
    fmi = fmi + es("ne,mnie->mi", t1, w[o, o, o, v])
    fmi = fmi + 0.5 * es("inef,mnef->mi", tau_t, w[o, o, v, v])

    fme = f[o, v] + es("nf,mnef->me", t1, w[o, o, v, v])

    wmnij = w[o, o, o, o]
    wmnij = wmnij + es("je,mnie->mnij", t1, w[o, o, o, v])
    wmnij = wmnij - es("ie,mnje->mnij", t1, w[o, o, o, v])
    wmnij = wmnij + 0.25 * es("ijef,mnef->mnij", tau, w[o, o, v, v])

    wabef = w[v, v, v, v]
    wabef = wabef - es("mb,amef->abef", t1, w[v, o, v, v])
    wabef = wabef + es("ma,bmef->abef", t1, w[v, o, v, v])
    wabef = wabef + 0.25 * es("mnab,mnef->abef", tau, w[o, o, v, v])

    wmbej = w[o, v, v, o]
    wmbej = wmbej + es("jf,mbef->mbej", t1, w[o, v, v, v])
    wmbej = wmbej - es("nb,mnej->mbej", t1, w[o, o, v, o])
    wmbej = wmbej - es("jnfb,mnef->mbej",
                       0.5 * t2 + es("jf,nb->jnfb", t1, t1), w[o, o, v, v])

    # T1 equations
    rhs1 = f[o, v]
    rhs1 = rhs1 + es("ie,ae->ia", t1, fae)
    rhs1 = rhs1 - es("ma,mi->ia", t1, fmi)
    rhs1 = rhs1 + es("imae,me->ia", t2, fme)
    rhs1 = rhs1 - es("nf,naif->ia", t1, w[o, v, o, v])
    rhs1 = rhs1 - 0.5 * es("imef,maef->ia", t2, w[o, v, v, v])
    rhs1 = rhs1 - 0.5 * es("mnae,nmei->ia", t2, w[o, o, v, o])

    # T2 equations
    rhs2 = w[o, o, v, v]
    tmp_fae = fae - 0.5 * es("mb,me->be", t1, fme)
    term = es("ijae,be->ijab", t2, tmp_fae)
    rhs2 = rhs2 + term - es("ijbe,ae->ijab", t2, tmp_fae)
    tmp_fmi = fmi + 0.5 * es("je,me->mj", t1, fme)
    term = es("imab,mj->ijab", t2, tmp_fmi)
    rhs2 = rhs2 - term + es("jmab,mi->ijab", t2, tmp_fmi)
    rhs2 = rhs2 + 0.5 * es("mnab,mnij->ijab", tau, wmnij)
    rhs2 = rhs2 + 0.5 * es("ijef,abef->ijab", tau, wabef)
    perm = es("imae,mbej->ijab", t2, wmbej)
    perm = perm - es("ie,ma,mbej->ijab", t1, t1, w[o, v, v, o])
    perm = (perm - perm.permute(1, 0, 2, 3) - perm.permute(0, 1, 3, 2)
            + perm.permute(1, 0, 3, 2))
    rhs2 = rhs2 + perm
    tmp = es("ie,abej->ijab", t1, w[v, v, v, o])
    rhs2 = rhs2 + tmp - tmp.permute(1, 0, 2, 3)
    tmp = es("ma,mbij->ijab", t1, w[o, v, o, o])
    rhs2 = rhs2 - tmp + tmp.permute(0, 1, 3, 2)

    t1_new = rhs1 / d1
    t2_new = rhs2 / d2
    e_corr = (es("ia,ia->", f[o, v], t1_new)
              + 0.25 * es("ijab,ijab->", w[o, o, v, v], t2_new)
              + 0.5 * es("ijab,ia,jb->", w[o, o, v, v], t1_new, t1_new))
    return t1_new, t2_new, e_corr


def _diis_coefficients(hist_r, nfill: int):
    """Pulay weights from the residual ring buffer, via the reference's
    identity-padded B matrix and eigh pseudo-inverse (ccsd.py:139-166)."""
    m = hist_r.shape[0]
    dtype, device = hist_r.dtype, hist_r.device
    b = hist_r @ hist_r.T
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
    return ((ev * inv_ew[None, :]) @ (ev.T @ rhs))[:m] * filled


def run_ccsd(so_h1, so_h2, occ_mask, conv_tol: float = 1e-8,
             max_cycle: int = 100):
    """CCSD correlation energy from spin-orbital integrals.

    Args:
        so_h1: (M, M) spin-orbital one-body integrals (incl. any embedding
            potential), a float64 tensor.
        so_h2: (M, M, M, M) a+a+aa coefficient tensor (the
            HamiltonianBuilder's 0.5*h2).
        occ_mask: boolean (M,) numpy array, True for occupied spin orbitals.

    Returns:
        (e_corr, e_hf_elec): correlation energy and the mean-field
        electronic energy implied by the integrals.
    """
    device = so_h1.device
    occ_mask = torch.as_tensor(occ_mask, dtype=torch.bool, device=device)
    occ = torch.nonzero(occ_mask).flatten()
    vir = torch.nonzero(~occ_mask).flatten()
    order = torch.cat([occ, vir])
    no, nv = len(occ), len(vir)
    h1 = so_h1[order][:, order]
    w = _antisymmetrized(so_h2)[order][:, order][:, :, order][:, :, :, order]

    o = slice(0, no)
    fock = h1 + torch.einsum("piqi->pq", w[:, o, :, o])
    e_ref = float(torch.einsum("ii->", h1[o, o]) + 0.5 * torch.einsum("ijij->", w[o, o, o, o]))

    eps = torch.diag(fock)
    d1 = eps[o, None] - eps[None, no:]
    d2 = (eps[o, None, None, None] + eps[None, o, None, None]
          - eps[None, None, no:, None] - eps[None, None, None, no:])
    t1 = fock[o, no:] / d1
    t2 = w[o, o, no:, no:] / d2

    m = DIIS_DIM
    n1 = no * nv
    namp = n1 + no * no * nv * nv
    hist_t = torch.zeros((m, namp), dtype=w.dtype, device=device)
    hist_r = torch.zeros_like(hist_t)
    nfill = 0
    e_prev = float("inf")
    e_corr = 0.0
    conv = False
    cycle = 0
    r_tol = 1e-6
    while cycle < max_cycle and not conv:
        t1n, t2n, e = _ccsd_step(t1, t2, fock, w, d1, d2, no, nv)
        r = torch.cat([(t1n - t1).reshape(-1), (t2n - t2).reshape(-1)])
        t_vec = torch.cat([t1n.reshape(-1), t2n.reshape(-1)])
        slot = cycle % m
        hist_t[slot] = t_vec
        hist_r[slot] = r
        nfill = min(nfill + 1, m)
        if nfill >= 2:
            t_vec = _diis_coefficients(hist_r, nfill) @ hist_t
        t1 = t_vec[:n1].reshape(no, nv)
        t2 = t_vec[n1:].reshape(no, no, nv, nv)
        e_corr = float(e)
        rmax = float(torch.max(torch.abs(r)))
        conv = abs(e_corr - e_prev) < conv_tol and rmax < r_tol
        e_prev = e_corr
        cycle += 1
    if conv:
        logger.debug("CCSD converged in %d cycles.", cycle)
    else:
        logger.warning("CCSD did NOT converge in %d cycles.", max_cycle)
    return e_corr, e_ref
