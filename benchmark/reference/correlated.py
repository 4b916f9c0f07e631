"""The reference's correlated solvers on a spin-orbital Hamiltonian:
spin-orbital CCSD (the Stanton-Gauss equations, which keep the off-diagonal
Fock blocks, so they hold for localized virtuals) and FCI by dense
diagonalisation over alpha and beta strings."""

import itertools

import numpy as np
import torch

__all__ = ["ccsd_energy", "fci_energy", "antisymmetrized"]


def antisymmetrized(h2_of):
    """<pq||rs> from OpenFermion-ordered h2[p, q, r, s] = (ps|qr)."""
    phys = h2_of.permute(0, 1, 3, 2)        # <pq|rs> = (pr|qs) = h2[p, q, s, r]
    return phys - phys.permute(0, 1, 3, 2)


def ccsd_energy(h1, h2_of, nocc, tol=1e-10, max_cycle=200):
    """(E_ref electronic, E_corr) of spin-orbital CCSD; ``h1`` and ``h2_of``
    as the Hamiltonian builder gives them (before its factor 1/2), the
    first ``nocc`` spin orbitals occupied."""
    g = antisymmetrized(h2_of)
    n = h1.shape[0]
    o, v = slice(0, nocc), slice(nocc, n)
    f = h1 + torch.einsum("piqi->pq", g[:, o, :, o])
    e_ref = torch.diagonal(h1)[o].sum() + 0.5 * torch.einsum("ijij->", g[o, o, o, o])
    foo, fvv, fov = f[o, o], f[v, v], f[o, v]
    d1 = torch.diagonal(foo)[:, None] - torch.diagonal(fvv)[None, :]
    d2 = d1[:, None, :, None] + d1[None, :, None, :]
    oovv, ovvv, ooov, oooo = g[o, o, v, v], g[o, v, v, v], g[o, o, o, v], g[o, o, o, o]
    vvvv, vovv, ovvo, oovo = g[v, v, v, v], g[v, o, v, v], g[o, v, v, o], g[o, o, v, o]
    ovov, vvvo, ovoo = g[o, v, o, v], g[v, v, v, o], g[o, v, o, o]
    eye_o = torch.eye(nocc, dtype=h1.dtype, device=h1.device)
    eye_v = torch.eye(n - nocc, dtype=h1.dtype, device=h1.device)
    t1 = fov / d1
    t2 = oovv / d2
    hist, errs = [], []

    def energy(t1, t2):
        return (torch.einsum("ia,ia->", fov, t1) + 0.25 * torch.einsum("ijab,ijab->", oovv, t2)
                + 0.5 * torch.einsum("ijab,ia,jb->", oovv, t1, t1))

    e_old = energy(t1, t2)
    for _ in range(max_cycle):
        tt = torch.einsum("ia,jb->ijab", t1, t1)
        tau = t2 + tt - tt.permute(0, 1, 3, 2)
        taut = t2 + 0.5 * (tt - tt.permute(0, 1, 3, 2))
        fae = fvv * (1 - eye_v) - 0.5 * torch.einsum("me,ma->ae", fov, t1) \
            + torch.einsum("mf,mafe->ae", t1, ovvv) - 0.5 * torch.einsum("mnaf,mnef->ae", taut, oovv)
        fmi = foo * (1 - eye_o) + 0.5 * torch.einsum("ie,me->mi", t1, fov) \
            + torch.einsum("ne,mnie->mi", t1, ooov) + 0.5 * torch.einsum("inef,mnef->mi", taut, oovv)
        fme = fov + torch.einsum("nf,mnef->me", t1, oovv)
        pij = torch.einsum("je,mnie->mnij", t1, ooov)
        wmnij = oooo + pij - pij.permute(0, 1, 3, 2) + 0.25 * torch.einsum("ijef,mnef->mnij", tau, oovv)
        pab = torch.einsum("mb,amef->abef", t1, vovv)
        wabef = vvvv - pab + pab.permute(1, 0, 2, 3) + 0.25 * torch.einsum("mnab,mnef->abef", tau, oovv)
        wmbej = ovvo + torch.einsum("jf,mbef->mbej", t1, ovvv) \
            - torch.einsum("nb,mnej->mbej", t1, oovo) \
            - torch.einsum("jnfb,mnef->mbej", 0.5 * t2 + torch.einsum("jf,nb->jnfb", t1, t1), oovv)

        r1 = fov + torch.einsum("ie,ae->ia", t1, fae) - torch.einsum("ma,mi->ia", t1, fmi) \
            + torch.einsum("imae,me->ia", t2, fme) - torch.einsum("nf,naif->ia", t1, ovov) \
            - 0.5 * torch.einsum("imef,maef->ia", t2, ovvv) \
            - 0.5 * torch.einsum("mnae,nmei->ia", t2, oovo)

        r2 = oovv.clone()
        tmp = torch.einsum("ijae,be->ijab", t2, fae)
        tmp = tmp - 0.5 * torch.einsum("ijae,be->ijab", t2, torch.einsum("mb,me->be", t1, fme))
        r2 = r2 + tmp - tmp.permute(0, 1, 3, 2)
        tmp = torch.einsum("imab,mj->ijab", t2, fmi)
        tmp = tmp + 0.5 * torch.einsum("imab,jm->ijab", t2, torch.einsum("je,me->jm", t1, fme))
        r2 = r2 - tmp + tmp.permute(1, 0, 2, 3)
        r2 = r2 + 0.5 * torch.einsum("mnab,mnij->ijab", tau, wmnij)
        r2 = r2 + 0.5 * torch.einsum("ijef,abef->ijab", tau, wabef)
        tmp = torch.einsum("imae,mbej->ijab", t2, wmbej) \
            - torch.einsum("ie,ma,mbej->ijab", t1, t1, ovvo)
        r2 = r2 + tmp - tmp.permute(0, 1, 3, 2) - tmp.permute(1, 0, 2, 3) \
            + tmp.permute(1, 0, 3, 2)
        tmp = torch.einsum("ie,abej->ijab", t1, vvvo)
        r2 = r2 + tmp - tmp.permute(1, 0, 2, 3)
        tmp = torch.einsum("ma,mbij->ijab", t1, ovoo)
        r2 = r2 - tmp + tmp.permute(0, 1, 3, 2)

        new1, new2 = r1 / d1, r2 / d2
        vec = torch.cat([new1.reshape(-1), new2.reshape(-1)])
        err = vec - torch.cat([t1.reshape(-1), t2.reshape(-1)])
        hist.append(vec)
        errs.append(err)
        hist, errs = hist[-8:], errs[-8:]
        if len(hist) > 1:
            b = torch.stack(errs) @ torch.stack(errs).T
            m = len(hist)
            a = torch.zeros((m + 1, m + 1), dtype=h1.dtype, device=h1.device)
            a[:m, :m] = b / b.diagonal().max()
            a[m, :m] = a[:m, m] = -1.0
            rhs = torch.zeros(m + 1, dtype=h1.dtype, device=h1.device)
            rhs[m] = -1.0
            c = torch.linalg.lstsq(a, rhs[:, None]).solution[:m, 0]
            vec = c @ torch.stack(hist)
        t1 = vec[:t1.numel()].reshape(t1.shape)
        t2 = vec[t1.numel():].reshape(t2.shape)
        e_new = energy(t1, t2)
        if abs(float(e_new - e_old)) < tol and float(err.abs().max()) < 100 * tol:
            return float(e_ref), float(e_new)
        e_old = e_new
    if h1.dtype == torch.float64:
        raise RuntimeError("reference CCSD did not converge")
    return float(e_ref), float(e_new)


def _strings(norb, nel):
    return [sum(1 << p for p in occ) for occ in itertools.combinations(range(norb), nel)]


def _excitation_matrices(norb, nel, dtype):
    """E[p, q] = a+_p a_q on the strings of ``nel`` electrons in ``norb``
    orbitals, (norb, norb, n, n)."""
    strings = _strings(norb, nel)
    index = {s: i for i, s in enumerate(strings)}
    e = np.zeros((norb, norb, len(strings), len(strings)), dtype=dtype)
    for j, s in enumerate(strings):
        for q in range(norb):
            if not s >> q & 1:
                continue
            s1 = s ^ (1 << q)
            sign_q = (-1) ** bin(s & ((1 << q) - 1)).count("1")
            for p in range(norb):
                if s1 >> p & 1:
                    continue
                sign_p = (-1) ** bin(s1 & ((1 << p) - 1)).count("1")
                e[p, q, index[s1 | (1 << p)], j] = sign_p * sign_q
    return e


def fci_energy(h, eri, nalpha, nbeta, dtype=np.float64):
    """Lowest eigenvalue of the spatial Hamiltonian (h, chemist ERIs) with
    ``nalpha`` and ``nbeta`` electrons (no constant), in ``dtype``."""
    h, eri = np.asarray(h, dtype=dtype), np.asarray(eri, dtype=dtype)
    k = h.shape[0]
    ea, eb = _excitation_matrices(k, nalpha, dtype), _excitation_matrices(k, nbeta, dtype)
    na, nb = ea.shape[-1], eb.shape[-1]
    hp = h - 0.5 * np.einsum("prrq->pq", eri)

    def one_spin(e):
        n = e.shape[-1]
        ee = e.reshape(k * k, n, n)
        two = 0.5 * np.einsum("xy,xab,ybc->ac", eri.reshape(k * k, k * k), ee, ee,
                              optimize=True)
        return np.einsum("pq,pqab->ab", hp, e) + two

    ham = np.kron(one_spin(ea), np.eye(nb, dtype=dtype)) + np.kron(np.eye(na, dtype=dtype), one_spin(eb))
    # the alpha-beta part: sum (pq|rs) E^a_pq x E^b_rs
    x = eri.reshape(k * k, k * k) @ eb.reshape(k * k, nb * nb)
    ab = (ea.reshape(k * k, na * na).T @ x).reshape(na, na, nb, nb)
    ham = ham + ab.transpose(0, 2, 1, 3).reshape(na * nb, na * nb)
    return float(np.linalg.eigvalsh(ham)[0])
