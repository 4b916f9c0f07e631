"""The reference's matrix-free FCI: the lowest eigenvalue of a spatial
Hamiltonian (h, chemist ERIs) in one (n_alpha, n_beta) sector, for sectors
whose dense matrix (``correlated.fci_energy``) does not fit, in plain
PyTorch on any device.

Determinants are (alpha string, beta string), each the lexicographic
combinations of its occupied orbitals. With k = h - 1/2 sum_r (pr|rq),

    H = sum_pq k_pq (Ea_pq + Eb_pq) + 1/2 sum_pqrs (pq|rs) E_pq E_rs,

split into one string Hamiltonian a spin (every one-spin term, built from
two hops of the single-replacement lists and applied as a GEMM) and the
alpha-beta part sum (pq|rs) Ea_pq Eb_rs, applied in blocks of source alpha
rows: the beta replacements gathered into D, one GEMM with the ERIs, and
the alpha replacements added into sigma with ``index_add_``. The lowest
eigenvalue comes from a plain Davidson (diagonal preconditioner, a seeded
admixture of every determinant in its start, no restart) to an energy
change of 1e-10 Ha and a residual of 1e-6 in float64; below float64 (the
control) it stops at its rounding, or at its iteration limit, and its last
value is its answer.
"""

import itertools

import numpy as np
import torch

__all__ = ["fci_energy_direct"]

# (energy change, residual norm) at which the Davidson stops, by dtype
TOLERANCES = {torch.float64: (1e-10, 1e-6), torch.float32: (1e-6, 1e-3)}
MAX_ITER = 160
# elements of a block's D and G together
BLOCK_ELEMENTS = 2 ** 28


def _replacements(norb, nel, device):
    """(strings, src, dst, pair, sign): every E_pq |J> = sign |I> with J =
    strings[src], I = strings[dst], pair = p * norb + q, q occupied in J and
    p empty or q."""
    strings = list(itertools.combinations(range(norb), nel))
    index = {s: i for i, s in enumerate(strings)}
    src, dst, pair, sign = [], [], [], []
    for j, occ in enumerate(strings):
        for q in occ:
            rest = [o for o in occ if o != q]
            below_q = sum(1 for o in occ if o < q)
            for p in range(norb):
                if p in rest:
                    continue
                new = tuple(sorted(rest + [p]))
                below_p = sum(1 for o in rest if o < p)
                src.append(j)
                dst.append(index[new])
                pair.append(p * norb + q)
                sign.append(-1.0 if (below_q + below_p) % 2 else 1.0)
    as_t = lambda x, dt: torch.tensor(x, dtype=dt, device=device)  # noqa: E731
    return (strings, as_t(src, torch.long), as_t(dst, torch.long), as_t(pair, torch.long),
            as_t(sign, torch.float64))


def _one_spin(k, eri, reps, n, dtype):
    """The dense (n, n) matrix of sum k_pq E_pq + 1/2 sum (pq|rs) E_pq E_rs
    over one spin's strings, from two hops of the replacement lists."""
    _, src, dst, pair, sign = reps
    norb = k.shape[0]
    ham = torch.zeros((n, n), dtype=dtype, device=k.device)
    ham.index_put_((dst, src), k.reshape(-1)[pair] * sign.to(dtype), accumulate=True)
    # E_rs takes J to K (first list entry), E_pq takes K to I (second)
    by_src = torch.argsort(src, stable=True)
    width = src.numel() // n
    nxt_dst = dst[by_src].reshape(n, width)
    nxt_pair = pair[by_src].reshape(n, width)
    nxt_sign = sign[by_src].reshape(n, width)
    eri2 = eri.reshape(norb * norb, norb * norb)
    i = nxt_dst[dst]                                     # (L, width)
    vals = 0.5 * eri2[nxt_pair[dst], pair[:, None]] * (nxt_sign[dst] * sign[:, None]).to(dtype)
    ham.index_put_((i.reshape(-1), src[:, None].expand_as(i).reshape(-1)), vals.reshape(-1),
                   accumulate=True)
    return ham


def fci_energy_direct(h, eri, nalpha, nbeta, dtype=torch.float64, device="cpu"):
    """Lowest eigenvalue of the spatial Hamiltonian (h, chemist ERIs) with
    ``nalpha`` and ``nbeta`` electrons (no constant), matrix-free, computed
    in ``dtype`` on ``device``."""
    h = torch.as_tensor(h, dtype=dtype, device=device)
    eri = torch.as_tensor(eri, dtype=dtype, device=device)
    norb = h.shape[0]
    k = h - 0.5 * torch.einsum("prrq->pq", eri)
    rep_a, rep_b = (_replacements(norb, ne, device) for ne in (nalpha, nbeta))
    na, nb = len(rep_a[0]), len(rep_b[0])
    ham_a = _one_spin(k, eri, rep_a, na, dtype)
    ham_b = _one_spin(k, eri, rep_b, nb, dtype)
    eri2 = eri.reshape(norb * norb, norb * norb)
    _, src_a, dst_a, pair_a, sign_a = rep_a
    _, src_b, dst_b, pair_b, sign_b = rep_b
    sign_a, sign_b = sign_a.to(dtype), sign_b.to(dtype)
    npair = norb * norb
    rows = max(1, min(na, BLOCK_ELEMENTS // (2 * npair * nb)))

    def sigma(c):
        out = ham_a @ c + c @ ham_b.T
        for lo in range(0, na, rows):
            hi = min(lo + rows, na)
            # D[j, rs, Ib] = sum_Jb <Ib|Eb_rs|Jb> c[lo + j, Jb]
            d = torch.zeros((hi - lo, npair * nb), dtype=dtype, device=c.device)
            d.index_add_(1, pair_b * nb + dst_b, c[lo:hi, src_b] * sign_b)
            g = (eri2 @ d.reshape(hi - lo, npair, nb)).reshape(hi - lo, npair, nb)
            del d
            use = (src_a >= lo) & (src_a < hi)
            out.index_add_(0, dst_a[use],
                           g[src_a[use] - lo, pair_a[use]] * sign_a[use][:, None])
        return out

    occ_a = torch.tensor([[1.0 if p in s else 0.0 for p in range(norb)] for s in rep_a[0]],
                         dtype=dtype, device=device)
    occ_b = torch.tensor([[1.0 if p in s else 0.0 for p in range(norb)] for s in rep_b[0]],
                         dtype=dtype, device=device)
    coulomb = torch.einsum("pprr->pr", eri)
    diag = ham_a.diagonal()[:, None] + ham_b.diagonal()[None, :] + occ_a @ coulomb @ occ_b.T
    return _davidson(sigma, diag, *TOLERANCES[dtype], dtype)


def _davidson(sigma, diag, tol_e, tol_r, dtype):
    shape, dim = diag.shape, diag.numel()
    flat = diag.reshape(-1)
    # the lowest diagonal determinant, and a seeded admixture of every
    # determinant of norm ~3e-3, so that no symmetry of the start hides a
    # lower state (a closed-shell start never reaches a lower triplet)
    noise = np.random.default_rng(0).uniform(-0.5, 0.5, dim) * 1e-2 / np.sqrt(dim)
    v = torch.as_tensor(noise, dtype=dtype, device=diag.device)
    v[int(torch.argmin(flat))] += 1.0
    v = v / torch.linalg.norm(v)
    vs, ss, e_old = [], [], None
    sub = np.zeros((MAX_ITER, MAX_ITER))
    for m in range(min(MAX_ITER, dim)):
        vs.append(v)
        ss.append(sigma(v.reshape(shape)).reshape(-1))
        sub[m, :m + 1] = sub[:m + 1, m] = torch.stack(
            [torch.dot(ss[m], u) for u in vs]).double().cpu().numpy()
        w, y = np.linalg.eigh(sub[:m + 1, :m + 1])
        e = float(w[0])
        x = sum(float(c) * u for c, u in zip(y[:, 0], vs))
        r = sum(float(c) * u for c, u in zip(y[:, 0], ss)) - e * x
        rnorm = float(torch.linalg.norm(r))
        if rnorm <= tol_r and e_old is not None and abs(e - e_old) <= tol_e:
            return e
        e_old = e
        denom = e - flat
        denom = torch.where(denom.abs() < 1e-8, torch.full_like(denom, 1e-8), denom)
        t = r / denom
        for _ in range(2):
            for u in vs:
                t = t - torch.dot(u, t) * u
        norm = float(torch.linalg.norm(t))
        if norm < 1e-12:
            return e
        v = t / norm
    if dtype == torch.float64:
        raise RuntimeError("reference Davidson did not converge")
    return e
