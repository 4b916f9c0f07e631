"""Matrix-free FCI on a fixed (n_alpha, n_beta) sector: sigma = H c over
alpha and beta strings, and a Davidson solve for the lowest eigenvalues.

``solvers.fci.run_fci`` takes this route ("matrix_free") for CUDA tensors
whose sector is too large for the dense card route, or above the size at
which this route is the faster (``fci.DENSE_MAX``). Nothing of it moves to
the host: the sector's tables are copied to the device once, and each
Davidson iteration reads two small results back (the subspace matrix, then
the residual and correction norms).

The operator is the HamiltonianBuilder's ``H = const + sum h1[P,Q] a+_P a_Q
+ sum h2[P,Q,R,S] a+_P a+_Q a_R a_S`` over interleaved spin orbitals (even
alpha, odd beta). Determinants are taken alpha string first, C[Ia, Ib]
(strings ascending as integers), which differs from the interleaved order
of ``fci.sector_basis`` by a sign per determinant and leaves the spectrum
alone (:func:`product_signs` gives the signs). H splits as

    H = Haa x 1 + 1 x Hbb + sum_{ps,qr} V[ps, qr] Ea_ps Eb_qr

- Haa, Hbb: every alpha-only (beta-only) term, as dense string matrices:
  the sector matrix of the full h1 and h2 over the strings of one spin
  (``ops.fci_hamiltonian.sector_matrix`` on the card,
  ``fci.sector_hamiltonian`` on the CPU), applied as two GEMMs;
- V: the mixed terms read from HamiltonianBuilder's four alpha-beta blocks of h2
  (``a+_pa a+_qb a_rb a_sa = Ea_ps Eb_qr``), so an unrestricted Hamiltonian
  stays exact. A term that changes the number of alpha electrons raises.

The mixed part runs in blocks of source alpha rows, gather, ``torch.bmm``
and scatter (``ops.fci_sigma``; the hand kernels on CUDA tensors, their
plain versions on CPU tensors, which is the torch formulation the CPU tests
call). Spans ``fci.tables`` (the sector's tables, cached by sector and
device, and the operator's set-up), ``fci.davidson`` and one ``fci.sigma``
per product; :data:`SIGMAS` counts the products.

The Davidson here is not ``solvers.tddft._davidson``: that one keeps its
subspace as host numpy arrays, grows it without a restart, and starts from
unit vectors, where an 11.8M-determinant sector needs its vectors on the
card, a bounded subspace, and a start from which no symmetry hides a lower
state.
"""

from collections import Counter
from dataclasses import dataclass
from functools import lru_cache
from itertools import combinations
from math import comb

import numpy as np
import torch

from ..ops import fci_sigma
from ..ops.fci_hamiltonian import sector_matrix
from ..profiling import span

__all__ = ["SIGMAS", "Tables", "tables", "DirectFCI", "davidson", "run_direct", "spin_mixing",
           "direct_bytes", "product_bits", "product_signs", "spin_strings", "TOL_E", "TOL_R",
           "MAX_SPACE", "MAX_ITER", "BLOCK_BYTES"]

# sigma products in this process: "sigma"
SIGMAS: Counter = Counter()

# Davidson's stopping rule: the lowest eigenvalues change by at most TOL_E
# Ha between iterations and each residual norm is at most TOL_R. PySCF's
# FCI solver stops at an energy change of 1e-10 (its conv_tol) with a
# residual of about its square root; an energy error is of the order of the
# residual squared, so 1e-6 leaves it ~1e-12 Ha, far under what the
# embedding's SCF sets (~1e-9 Ha).
TOL_E = 1e-10
TOL_R = 1e-6
# vectors the subspace holds before it collapses onto the lowest Ritz
# vectors (at least four per root)
MAX_SPACE = 24
MAX_ITER = 200
# device bytes of a mixed-part block's Y and Z ("a few GB"): 620 of
# acetonitrile's 3432 alpha rows at a time, six blocks a product
BLOCK_BYTES = 4 << 30
# floor of |theta - diagonal| in the preconditioner (PySCF's)
_PRECOND_FLOOR = 1e-8
# a start vector: 1 on its lowest-diagonal determinant and seeded uniform
# noise on every determinant, of about this norm over all of them times
# 0.29; a noise of norm ~1 swamps the start, and the solve takes many times
# the products or settles on an excited state
_START_ADMIXTURE = 1e-2


def spin_strings(n_orb: int, nel: int) -> np.ndarray:
    """The occupation bitstrings of ``nel`` electrons in ``n_orb`` orbitals,
    ascending as integers."""
    return np.array(sorted(sum(1 << p for p in occ) for occ in combinations(range(n_orb), nel)),
                    dtype=np.int64)


def _popcount(x):
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def _excitations(strings: np.ndarray, n_orb: int):
    """Every single replacement a+_c a_a of each string (a occupied, c empty
    or a itself), in order of (a, c): (a, c, target string index, sign),
    each (ns, nlink)."""
    pairs = np.array([[(a, c) for a in range(n_orb) if s >> a & 1
                       for c in range(n_orb) if c == a or not s >> c & 1]
                      for s in strings.tolist()], dtype=np.int64).reshape(len(strings), -1, 2)
    ann, cre = pairs[..., 0], pairs[..., 1]
    one = np.int64(1)
    s = strings[:, None]
    after = s ^ (one << ann)
    sign = (1 - 2 * (_popcount(s & ((one << ann) - 1)) & 1)) \
        * (1 - 2 * (_popcount(after & ((one << cre) - 1)) & 1))
    return ann, cre, np.searchsorted(strings, after | (one << cre)), sign


@dataclass(frozen=True)
class Tables:
    """A sector's string tables on one device (:func:`tables`)."""

    na: int                   # alpha strings
    nb: int                   # beta strings
    nlink: int                # single replacements of an alpha string
    table_b: torch.Tensor     # (n*n, nb) int32: Jb of <Ib|Eb_qr|Jb>, signed
    table_a: torch.Tensor     # (na, nlink) int32: sources Ja*nlink + k of Ia
    pair_a: torch.Tensor      # (na, nlink) int64: the ps of link k of Ja
    occ_a: torch.Tensor       # (na, n) float64 occupations
    occ_b: torch.Tensor       # (nb, n)
    basis_a: torch.Tensor     # (na,) int64 alpha strings on even spin orbitals
    basis_b: torch.Tensor     # (nb,) int64 beta strings on odd spin orbitals


def _spread(strings: np.ndarray, n_orb: int, parity: int) -> np.ndarray:
    """Spatial bitstrings onto the even (parity 0) or odd spin orbitals."""
    out = np.zeros_like(strings)
    for p in range(n_orb):
        out |= ((strings >> p) & 1) << (2 * p + parity)
    return out


@lru_cache(maxsize=8)
def tables(n_orb: int, nelec: tuple, device: torch.device) -> Tables:
    """The string tables of ``nelec`` = (n_alpha, n_beta) in ``n_orb``
    spatial orbitals on ``device``, built once per sector and device."""
    sa, sb = spin_strings(n_orb, nelec[0]), spin_strings(n_orb, nelec[1])
    na, nb, npair = len(sa), len(sb), n_orb * n_orb
    if na * max(nelec[0] * (n_orb - nelec[0] + 1), 1) >= 2 ** 31 - 1 or nb >= 2 ** 31 - 1:
        raise ValueError(f"fci_direct: {na} x {nb} strings overflow the int32 tables")

    ann, cre, target, sign = _excitations(sb, n_orb)
    table_b = np.zeros((npair, nb), dtype=np.int32)
    ib = np.broadcast_to(np.arange(nb)[:, None], ann.shape)
    # <Ib|Eb_qr|Jb> = <Jb|Eb_rq|Ib>: Jb is Ib with q replaced by r
    table_b[ann * n_orb + cre, ib] = (target + 1) * sign

    ann, cre, target, sign = _excitations(sa, n_orb)
    nlink = ann.shape[1]
    pair_a = cre * n_orb + ann              # Ea_ps with p created, s annihilated
    flat = np.arange(na * nlink).reshape(na, nlink)
    order = np.argsort(target.ravel(), kind="stable")
    table_a = ((flat.ravel()[order] + 1) * sign.ravel()[order]).reshape(na, nlink)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    occ = [((s[:, None] >> np.arange(n_orb)) & 1).astype(np.float64) for s in (sa, sb)]
    return Tables(na, nb, nlink, dev(table_b, torch.int32), dev(table_a, torch.int32),
                  dev(pair_a, torch.int64), dev(occ[0], torch.float64),
                  dev(occ[1], torch.float64), dev(_spread(sa, n_orb, 0), torch.int64),
                  dev(_spread(sb, n_orb, 1), torch.int64))


def product_bits(n_orb: int, nelec: tuple) -> np.ndarray:
    """(na, nb) interleaved bitstrings of the determinants (Ia, Ib)."""
    sa = _spread(spin_strings(n_orb, nelec[0]), n_orb, 0)
    sb = _spread(spin_strings(n_orb, nelec[1]), n_orb, 1)
    return sa[:, None] | sb[None, :]


def product_signs(n_orb: int, nelec: tuple):
    """(interleaved bitstrings (na, nb), signs (na, nb)): determinant (Ia, Ib)
    alpha string first is ``sign`` times the interleaved determinant of those
    bits (``fci.sector_basis``'s convention)."""
    bits = product_bits(n_orb, nelec)
    sa, sb = bits[:, :1] & 0x5555555555555555, bits[:1, :] & ~0x5555555555555555
    # move each beta creator right of the alpha creators above it
    swaps = np.zeros(bits.shape, dtype=np.int64)
    for p in range(n_orb):
        beta_below = _popcount(sb & ((np.int64(1) << (2 * p)) - 1))
        swaps += ((sa >> (2 * p)) & 1) * beta_below
    return bits, 1.0 - 2.0 * (swaps & 1)


def spin_mixing(h1, h2) -> tuple:
    """(one-body, two-body) numbers of the terms of h1 and h2 that change the
    number of alpha electrons, which the matrix-free route cannot take: one
    host read."""
    spin = torch.arange(h1.shape[0], device=h1.device) % 2
    keep1 = spin[:, None] == spin[None, :]
    keep2 = (spin[:, None, None, None] + spin[None, :, None, None]) == \
        (spin[None, None, :, None] + spin[None, None, None, :])
    mixing = torch.stack([torch.count_nonzero(h1 * ~keep1), torch.count_nonzero(h2 * ~keep2)])
    return tuple(int(x) for x in mixing.tolist())


def _mixed_terms(h1, h2):
    """V (n*n, n*n), V[p*n + s, q*n + r] the coefficient of Ea_ps Eb_qr,
    from the four alpha-beta blocks of ``h2``; raises where h1 or h2 has a
    term that changes the number of alpha electrons."""
    one, two = spin_mixing(h1, h2)
    if one or two:
        raise ValueError(
            f"fci_direct: {one} one-body and {two} two-body terms mix spins; the "
            f"matrix-free route takes spin-conserving Hamiltonians only")
    m = h1.shape[0]
    a, b = slice(0, m, 2), slice(1, m, 2)
    v = h2[a, b, b, a] - h2[a, b, a, b].transpose(2, 3) \
        - h2[b, a, b, a].transpose(0, 1) + h2[b, a, a, b].permute(1, 0, 3, 2)
    n = m // 2
    return v.permute(0, 3, 1, 2).reshape(n * n, n * n).contiguous()


def _string_hamiltonian(h1, h2, basis, n_spinorb, nelec):
    """The dense matrix of every term of one spin over its strings."""
    if h1.device.type == "cuda":
        return sector_matrix(0.0, h1, h2, basis)
    from .fci import sector_hamiltonian

    ham, _ = sector_hamiltonian(0.0, h1, h2, n_spinorb, nelec)
    return torch.as_tensor(ham.toarray(), dtype=h1.dtype)


def direct_bytes(n_orb: int, nelec: tuple, k: int = 1) -> int:
    """The least device bytes of the route, at blocks of one row: the
    Davidson subspace and its sigmas, its work vectors, the string
    Hamiltonians, V and its gathered rows."""
    na, nb = comb(n_orb, nelec[0]), comb(n_orb, nelec[1])
    dim, npair = na * nb, n_orb * n_orb
    nlink = nelec[0] * (n_orb - nelec[0] + 1)
    vectors = (2 * _space(k) + 4 + 6 * k) * dim
    fixed = na * na + nb * nb + na * nlink * npair + npair * npair
    return 8 * (vectors + fixed + (npair + nlink) * nb)


def _space(k: int) -> int:
    return max(MAX_SPACE, 4 * k)


class DirectFCI:
    """H of one sector as a matrix-free operator on h1's device: ``sigma``
    (C (na, nb) -> H C without the constant) and ``diagonal`` (na, nb)."""

    def __init__(self, h1, h2, n_spinorb: int, nelec: tuple, block_bytes: int = BLOCK_BYTES):
        n = n_spinorb // 2
        self.t = t = tables(n, tuple(nelec), h1.device)
        h1, h2 = h1.to(torch.float64).contiguous(), h2.to(torch.float64).contiguous()
        v = _mixed_terms(h1, h2)
        self.haa = _string_hamiltonian(h1, h2, t.basis_a, n_spinorb, (nelec[0], 0))
        self.hbb = _string_hamiltonian(h1, h2, t.basis_b, n_spinorb, (0, nelec[1]))
        # V's rows of the links of each source alpha string, (na, nlink, n*n)
        self.vg = v[t.pair_a]
        vd = v.reshape(n, n, n, n).diagonal(0, 0, 1).diagonal(0, 0, 1)   # V[pp, qq]
        self.diagonal = (self.haa.diagonal()[:, None] + self.hbb.diagonal()[None, :]
                         + t.occ_a @ vd @ t.occ_b.T)
        self.block = max(1, min(t.na, block_bytes // ((n * n + t.nlink) * t.nb * 8)))

    def sigma(self, c):
        """H c for C (na, nb), float64, on h1's device."""
        t = self.t
        with span("fci.sigma"):
            out = torch.addmm(c @ self.hbb.T, self.haa, c)
            if t.nlink:
                for lo in range(0, t.na, self.block):
                    hi = min(lo + self.block, t.na)
                    y = fci_sigma.gather(c, lo, hi - lo, t.table_b)
                    z = torch.bmm(self.vg[lo:hi], y)
                    del y
                    fci_sigma.scatter(z, lo, hi, t.table_a, out)
            SIGMAS["sigma"] += 1
        return out


def _orthonormal(new, basis, m: int):
    """The rows of ``new`` orthonormal to ``basis[:m]`` and to each other,
    in place (Gram-Schmidt, twice)."""
    for i in range(len(new)):
        for _ in range(2):
            new[i] -= (basis[:m] @ new[i]) @ basis[:m] + (new[:i] @ new[i]) @ new[:i]
        new[i] /= new[i].norm()
    return new


def davidson(apply, diagonal, k: int = 1):
    """Lowest ``k`` eigenvalues (ascending numpy) of the symmetric operator
    ``apply`` (a flat vector -> its product) with ``diagonal``: Davidson
    with the diagonal preconditioner, started from the k lowest diagonal
    determinants with a seeded admixture of every determinant (so that no
    symmetry of the start hides a lower state, as a closed-shell start
    would hide a lower triplet), restarted on the lowest Ritz vectors when
    the subspace is full. Raises where it does not converge in
    :data:`MAX_ITER` iterations."""
    diag = diagonal.reshape(-1)
    dim, dev = diag.numel(), diag.device
    if not 1 <= k <= dim:
        raise ValueError(f"davidson: k = {k} roots of a dimension {dim}")
    space = min(_space(k), dim)
    basis = torch.empty((space, dim), dtype=torch.float64, device=dev)
    products = torch.empty_like(basis)
    gen = torch.Generator(device=dev).manual_seed(0)
    new = (_START_ADMIXTURE / dim ** 0.5) * (
        torch.rand((k, dim), generator=gen, dtype=torch.float64, device=dev) - 0.5)
    new[torch.arange(k, device=dev), torch.topk(diag, k, largest=False).indices] += 1.0
    new = _orthonormal(new, basis, 0)
    m, theta_old = 0, None
    for _ in range(MAX_ITER):
        for v in new:
            basis[m] = v
            products[m] = apply(v)
            m += 1
        sub = (basis[:m] @ products[:m].T).cpu().numpy()
        w, y = np.linalg.eigh(0.5 * (sub + sub.T))
        theta = w[:k]
        yk = torch.as_tensor(np.ascontiguousarray(y[:, :k].T), device=dev)
        x, ax = yk @ basis[:m], yk @ products[:m]
        theta_d = torch.as_tensor(theta, device=dev)
        resid = ax - theta_d[:, None] * x
        denom = theta_d[:, None] - diag[None, :]
        denom = torch.where(denom.abs() < _PRECOND_FLOOR,
                            torch.full_like(denom, _PRECOND_FLOOR), denom)
        corr = resid / denom
        for _ in range(2):
            corr -= (corr @ basis[:m].T) @ basis[:m]
        norms = torch.cat([resid.norm(dim=1), corr.norm(dim=1)]).cpu().numpy()
        rnorm, cnorm = norms[:k], norms[k:]
        change = np.abs(theta - theta_old) if theta_old is not None else np.full(k, np.inf)
        done = (rnorm <= TOL_R) & ((change <= TOL_E) | (m == dim))
        grow = [i for i in range(k) if not done[i] and cnorm[i] > 1e-14]
        if done.all() or m == dim or not grow:
            return theta
        if m + len(grow) > space:
            # thick restart on the lowest Ritz vectors, twice the roots and two
            keep = torch.as_tensor(np.ascontiguousarray(y[:, :min(m - len(grow), 2 * k + 2)].T),
                                   device=dev)
            basis[:len(keep)], products[:len(keep)] = keep @ basis[:m], keep @ products[:m]
            m = len(keep)
        new = _orthonormal(corr[grow], basis, m)
        theta_old = theta
    raise RuntimeError(f"davidson: not converged in {MAX_ITER} iterations (residuals "
                       f"{rnorm.tolist()}, eigenvalue changes {change.tolist()})")


def run_direct(constant, h1, h2, n_spinorb: int, nelec: tuple, k: int = 1,
               block_bytes: int = BLOCK_BYTES) -> np.ndarray:
    """Lowest-k eigenvalues (ascending numpy) of the sector Hamiltonian,
    matrix-free on h1's device."""
    with span("fci.tables"):
        op = DirectFCI(h1, h2, n_spinorb, nelec, block_bytes)
    shape = op.diagonal.shape
    with span("fci.davidson"):
        vals = davidson(lambda v: op.sigma(v.reshape(shape)).reshape(-1), op.diagonal, k)
    return vals + float(constant)
