"""Spin-orbital CCSD with Stanton-Gauss-Watts-Bartlett intermediates and
the perturbative (T) correction (port of ``nbed_tpu/solvers/ccsd.py``).

The amplitude equations run as torch einsums on the integrals' device; the
reference's on-device ``lax.while_loop`` becomes a Python loop with the
same Pulay-DIIS ring buffer and a host convergence test each cycle.

Precision modes as in the reference (``ccsd.py:287-381``): ``"f64"``, one
float64 sweep; ``"f32"``, one float32 sweep; ``"mixed"``, the float32 sweep
then a float64 polish seeded from its amplitudes; ``"auto"`` is ``"f64"``
(the reference picks ``"mixed"`` only on a TPU, where float64 is emulated).
The float32 sweep runs with TF32 off and float32 matmul precision
``"highest"``: TF32's 10-bit mantissa is too coarse for the amplitude fixed
point. (T) always runs in float64, on float32 amplitudes upcast.
"""

import logging
from contextlib import contextmanager

import torch

__all__ = ["run_ccsd"]

logger = logging.getLogger(__name__)

DIIS_DIM = 6  # amplitude-DIIS history length (the reference's default)
# elements of one (chunk, nv, nv, nv) block of the (T) energy; about ten
# such blocks are live per chunk (~0.7 GB in float64)
_T_BLOCK_ELEMS = 1 << 23


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


def _sweep(fock, w, d1, d2, t1, t2, conv_tol: float, r_tol: float,
           max_cycle: int, diis_dim: int):
    """Amplitude iterations with Pulay DIIS in the dtype of ``w``, from the
    amplitudes (t1, t2) -> (t1, t2, e_corr, rmax, cycles, converged); the
    amplitudes returned are the last DIIS extrapolation, as the
    reference's ``_make_sweep`` returns them."""
    no, nv = t1.shape
    dtype, device = w.dtype, w.device
    t1, t2 = t1.to(dtype), t2.to(dtype)
    m = diis_dim
    n1 = no * nv
    namp = n1 + no * no * nv * nv
    hist_t = torch.zeros((m, namp), dtype=dtype, device=device)
    hist_r = torch.zeros_like(hist_t)
    nfill = 0
    e_prev = float("inf")
    e_corr = 0.0
    rmax = float("inf")
    conv = False
    cycle = 0
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
    return t1, t2, e_corr, rmax, cycle, conv


def _triples_energy(fock, w, t1, t2, chunk: int | None = None) -> float:
    """Spin-orbital (T) energy of canonical-reference CCSD(T),

        E(T) = (1/36) sum_{ijkabc} Rc (Rc + Rd) / D,
        D Rc = P(i/jk) P(a/bc) [sum_e t2[jk,ae] <ei||bc> - sum_m t2[im,bc] <ma||jk>],
        D Rd = P(i/jk) P(a/bc) t1[ia] <jk||bc>,

    over all (i, j, k) occupied triples (``_make_triples_energy``,
    ``ccsd.py:224-284``). D takes only the Fock diagonal, also for
    non-canonical (embedded) orbitals, as the reference does. The (nv, nv,
    nv) blocks of ``chunk`` triples at a time are batched GEMMs and t3 is
    never stored; the last chunk is short (no padded triples to mask)."""
    no, nv = t1.shape
    o, v = slice(0, no), slice(no, no + nv)
    eps = torch.diagonal(fock)
    eps_o, eps_v = eps[:no], eps[no:]
    w_vovv = w[v, o, v, v].permute(1, 0, 2, 3).reshape(no, nv, nv * nv)  # [i][e, bc]
    w_ovoo = w[o, v, o, o].permute(2, 3, 1, 0)  # [j, k][a, m]
    w_oovv = w[o, o, v, v]
    t2_i = t2.reshape(no, no, nv * nv)  # [i][m, bc]
    d_abc = eps_v[:, None, None] + eps_v[None, :, None] + eps_v[None, None, :]
    n_tr = no ** 3
    if chunk is None:
        chunk = max(1, _T_BLOCK_ELEMS // max(nv ** 3, 1))

    def p_abc(x):  # (C, a, b, c)
        return x - x.permute(0, 2, 1, 3) - x.permute(0, 3, 2, 1)

    def conn(i, j, k):
        x = torch.bmm(t2[j, k], w_vovv[i])  # sum_e t2[jk,ae] <ei||bc>
        x = x - torch.bmm(w_ovoo[j, k], t2_i[i])  # sum_m t2[im,bc] <ma||jk>
        return p_abc(x.reshape(-1, nv, nv, nv))

    def disc(i, j, k):
        return p_abc(t1[i][:, :, None, None] * w_oovv[j, k][:, None, :, :])

    e_t = torch.zeros((), dtype=w.dtype, device=w.device)
    for c0 in range(0, n_tr, chunk):
        idx = torch.arange(c0, min(c0 + chunk, n_tr), dtype=torch.int64, device=w.device)
        i, j, k = idx // (no * no), (idx // no) % no, idx % no
        rc = conn(i, j, k) - conn(j, i, k) - conn(k, j, i)
        rd = disc(i, j, k) - disc(j, i, k) - disc(k, j, i)
        d = (eps_o[i] + eps_o[j] + eps_o[k])[:, None, None, None] - d_abc
        e_t = e_t + torch.sum(rc * (rc + rd) / d)
    return float(e_t) / 36.0


@contextmanager
def _true_float32():
    """Full float32 products for the float32 sweep: no TF32, matmul
    precision "highest" (the reference's 3-pass f32 products)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)


def run_ccsd(so_h1, so_h2, occ_mask, conv_tol: float = 1e-8,
             max_cycle: int = 100, precision: str = "auto",
             diis_dim: int = DIIS_DIM, triples: bool = False):
    """CCSD correlation energy from spin-orbital integrals.

    Args:
        so_h1: (M, M) spin-orbital one-body integrals (incl. any embedding
            potential), a float64 tensor.
        so_h2: (M, M, M, M) a+a+aa coefficient tensor (the
            HamiltonianBuilder's 0.5*h2).
        occ_mask: boolean (M,) numpy array, True for occupied spin orbitals.
        precision: ``"f64"``, ``"f32"`` (about 1e-5 Ha), ``"mixed"`` (the
            float32 sweep, then a float64 polish) or ``"auto"`` (= f64).
        diis_dim: DIIS history length.
        triples: also the perturbative (T) correction from the converged
            amplitudes.

    Returns:
        (e_corr, e_hf_elec): correlation energy and the mean-field
        electronic energy implied by the integrals; with ``triples=True``
        (e_corr, e_t, e_hf_elec).
    """
    if precision == "auto":
        precision = "f64"
    if precision not in ("f64", "f32", "mixed"):
        raise ValueError(f"precision must be 'auto', 'f64', 'f32' or 'mixed', got {precision!r}")
    device = so_h1.device
    occ_mask = torch.as_tensor(occ_mask, dtype=torch.bool, device=device)
    occ = torch.nonzero(occ_mask).flatten()
    vir = torch.nonzero(~occ_mask).flatten()
    order = torch.cat([occ, vir])
    no = len(occ)
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

    if precision in ("f32", "mixed"):
        f32 = torch.float32
        with _true_float32():
            t1, t2, e32, rmax, n_it, conv = _sweep(
                fock.to(f32), w.to(f32), d1.to(f32), d2.to(f32), t1, t2,
                max(conv_tol, 1e-6), 1e-5, max_cycle, diis_dim)
        logger.debug("CCSD f32 sweep: %s cycles, e=%s, rmax=%s", n_it, e32, rmax)
        if precision == "f32":
            if not conv:
                logger.warning("CCSD (f32) did NOT converge in %d cycles.", max_cycle)
            if triples:
                e_t = _triples_energy(fock, w, t1.to(fock.dtype), t2.to(fock.dtype))
                return e32, e_t, e_ref
            return e32, e_ref

    t1, t2, e_corr, rmax, n_it, conv = _sweep(fock, w, d1, d2, t1, t2, conv_tol, 1e-6,
                                              max_cycle, diis_dim)
    if conv:
        logger.debug("CCSD converged in %d f64 cycles (%s).", n_it, precision)
    else:
        logger.warning("CCSD did NOT converge in %d cycles.", max_cycle)
    if triples:
        e_t = _triples_energy(fock, w, t1, t2)
        logger.debug("(T) correction: %s", e_t)
        return e_corr, e_t, e_ref
    return e_corr, e_ref
