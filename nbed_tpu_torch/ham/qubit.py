"""Fermion-to-qubit mappings with a bitmask Pauli algebra (port of
``nbed_tpu/ham/qubit.py``, host numpy/scipy).

Pauli strings are stored in canonical symplectic form ``coeff * X^x Z^z``
(per-qubit overlap X&Z encodes Y up to a tracked phase), so products are two
XORs and a popcount-controlled sign. Jordan-Wigner, Bravyi-Kitaev
(Fenwick-tree construction) and the parity encoding share one
ladder-operator interface.

Term generation runs in the C++ engine ``csrc/qubit_terms.cpp`` (built with
``g++`` into ``nbed_tpu_torch/_build`` at first use; a failed build raises)
for registers of up to 63 qubits, and in :func:`_map_python`, the plain
Python-integer version it is tested against, above that. The reference's
numpy sort/segment-sum pipeline, its fall-back when the engine cannot be
built, is not ported.
"""

import ctypes
from functools import lru_cache

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.linalg import LinearOperator, eigsh

from .._compile import qubit_terms_library
from .._device import to_host

__all__ = ["PauliSum", "jordan_wigner", "bravyi_kitaev", "parity_transform",
           "MAPPINGS", "measurement_groups", "pauli_sum_to_sparse",
           "pauli_ground_state"]


def _popcount(x: int) -> int:
    return bin(x).count("1")


class PauliSum:
    """Sum of Pauli strings over ``n_qubits`` in canonical X^x Z^z form."""

    def __init__(self, n_qubits: int, terms=None):
        self.n_qubits = n_qubits
        self.terms = dict(terms or {})  # (x_mask, z_mask) -> complex coeff

    def add(self, coeff, x, z):
        if coeff == 0.0:
            return
        key = (x, z)
        new = self.terms.get(key, 0.0) + coeff
        if abs(new) < 1e-14:
            self.terms.pop(key, None)
        else:
            self.terms[key] = new

    def __len__(self):
        return len(self.terms)

    def compress(self, tol=1e-12):
        self.terms = {k: v for k, v in self.terms.items() if abs(v) > tol}
        return self

    def to_strings(self):
        """[(coeff, 'XIZY...')] with true Pauli-letter coefficients: the
        canonical X^x Z^z is (-i)^{nY} times the letter string."""
        out = []
        for (x, z), c in sorted(self.terms.items()):
            letters = ["IXZY"[((x >> q) & 1) + 2 * ((z >> q) & 1)]
                       for q in range(self.n_qubits)]
            out.append((c * ((-1j) ** letters.count("Y")), "".join(letters)))
        return out


def _mul(term_a, term_b):
    """(c, x, z) x (c, x, z) -> (c, x, z); phase from Z^z1 past X^x2."""
    ca, xa, za = term_a
    cb, xb, zb = term_b
    sign = -1.0 if (_popcount(za & xb) & 1) else 1.0
    return (ca * cb * sign, xa ^ xb, za ^ zb)


def _lowbit(i: int) -> int:
    return i & (-i)


def _bk_sets(j: int, n: int):
    """Fenwick-tree update/parity/flip sets of mode j (0-indexed)."""
    i = j + 1  # 1-indexed Fenwick node
    update = 0
    k = i + _lowbit(i)
    while k <= n:
        update |= 1 << (k - 1)
        k += _lowbit(k)
    parity = 0
    k = j  # prefix count of modes < j
    while k > 0:
        parity |= 1 << (k - 1)
        k -= _lowbit(k)
    flip = 0
    k = i - 1
    while k > i - _lowbit(i):
        flip |= 1 << (k - 1)
        k -= _lowbit(k)
    return update, parity, flip


def _ladder_factory(mapping: str, n: int):
    """``f(mode, dagger) -> [(coeff, x, z), (coeff, x, z)]``: the two
    strings of a ladder operator under ``mapping``."""

    def jw(mode, dagger):
        x = 1 << mode
        zlow = (1 << mode) - 1
        s = -0.5 if dagger else 0.5
        # a = (X + iY)/2 Z_< = (X - XZ)/2 Z_<;  a+ = (X + XZ)/2 Z_<
        return [(0.5, x, zlow), (-s, x, zlow | x)]

    def bk(mode, dagger):
        update, parity, flip = _bk_sets(mode, n)
        xmask = update | (1 << mode)
        rho = parity & ~flip if (mode & 1) else parity
        # c_j = X_U X_j Z_P, d_j = X_U Y_j Z_rho with Y = i X Z; a = (c + i
        # d)/2, a+ = (c - i d)/2 with the halves folded into the 0.5s
        sign = -1j if dagger else 1j
        return [(0.5, xmask, parity), (sign * 0.5j, xmask, rho | (1 << mode))]

    def parity(mode, dagger):
        # qubit j stores (n_0 + ... + n_j) mod 2, the degenerate-Fenwick
        # limit of BK: c_j = X_{j+1..n-1} X_j Z_{j-1}, d_j = X_{j+1..n-1} Y_j
        upper = (((1 << n) - 1) >> (mode + 1)) << (mode + 1)
        xmask = upper | (1 << mode)
        pmask = (1 << (mode - 1)) if mode > 0 else 0
        sign = -1j if dagger else 1j
        return [(0.5, xmask, pmask), (sign * 0.5j, xmask, 1 << mode)]

    return {"jw": jw, "bk": bk, "parity": parity}[mapping]


def _ladder_tables(ops):
    """(scalars (2,), x masks (2, n), z masks (2, n)) of one ladder flavour;
    each of the two strings has one scalar for every mode."""
    cs = np.array([ops[0][k][0] for k in (0, 1)], dtype=complex)
    if any(t[k][0] != cs[k] for t in ops for k in (0, 1)):
        raise ValueError("ladder scalars differ between modes")
    xs = np.array([[t[k][1] for t in ops] for k in (0, 1)], dtype=np.int64)
    zs = np.array([[t[k][2] for t in ops] for k in (0, 1)], dtype=np.int64)
    return cs, xs, zs


@lru_cache(maxsize=1)
def _lib():
    lib = qubit_terms_library()
    dptr = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.nbed_map_terms.argtypes = [
        ctypes.c_int, i64, i64, i64, i64, dptr, dptr,
        ctypes.c_int64, i32, dptr, ctypes.c_int64, i32, dptr,
        ctypes.c_double, i64, i64, dptr,
    ]
    lib.nbed_map_terms.restype = ctypes.c_int64
    return lib


def _map_native(n, dag, ann, h1, h2, tol):
    """Unique strings and complex coefficients of the fermionic (h1, h2)
    operator from the C++ engine: every term of ``h1`` expands into 4
    strings and of ``h2`` into 16, summed per (x, z) and cut at ``tol``
    (``nbed_tpu/native/__init__.py:95-140``)."""
    dc, dx, dz = _ladder_tables(dag)
    ac, ax, az = _ladder_tables(ann)

    def c2f(a):
        return np.ascontiguousarray(np.asarray(a, dtype=np.complex128)).view(np.float64)

    def ip(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    p1, q1 = np.nonzero(np.abs(h1) > tol)
    idx2 = np.nonzero(np.abs(h2) > tol)
    pq1 = np.ascontiguousarray(np.stack([p1, q1], axis=1), dtype=np.int32)
    pqrs2 = np.ascontiguousarray(np.stack(idx2, axis=1), dtype=np.int32)
    c1, c2 = c2f(h1[p1, q1]), c2f(h2[idx2])
    dsc, asc = c2f(dc), c2f(ac)
    tables = [np.ascontiguousarray(t) for t in (dx, dz, ax, az)]
    cap = 4 * len(p1) + 16 * len(idx2[0])
    out_x = np.empty(cap, dtype=np.int64)
    out_z = np.empty(cap, dtype=np.int64)
    out_c = np.empty(2 * cap, dtype=np.float64)
    dptr = ctypes.c_double
    n_out = _lib().nbed_map_terms(
        n, *(ip(t, ctypes.c_int64) for t in tables), ip(dsc, dptr), ip(asc, dptr),
        len(p1), ip(pq1, ctypes.c_int32), ip(c1, dptr),
        len(idx2[0]), ip(pqrs2, ctypes.c_int32), ip(c2, dptr),
        float(tol), ip(out_x, ctypes.c_int64), ip(out_z, ctypes.c_int64),
        ip(out_c, dptr))
    return out_x[:n_out], out_z[:n_out], out_c[:2 * n_out].view(np.complex128)


def _map_python(constant, h1, h2, mapping: str, tol=1e-12) -> PauliSum:
    """Plain version of the mapping: every ladder product multiplied out
    with Python integers, for any register width
    (``nbed_tpu/ham/qubit.py:316-334``)."""
    h1, h2 = to_host(h1), to_host(h2)
    n = h1.shape[0]
    ladder = _ladder_factory(mapping, n)
    dag = [ladder(p, True) for p in range(n)]
    ann = [ladder(p, False) for p in range(n)]
    out = PauliSum(n)
    out.add(complex(constant), 0, 0)
    for p, q in zip(*np.nonzero(np.abs(h1) > tol)):
        c = complex(h1[p, q])
        for t1 in dag[p]:
            for t2 in ann[q]:
                cc, x, z = _mul(t1, t2)
                out.add(c * cc, x, z)
    for p, q, r, s in zip(*np.nonzero(np.abs(h2) > tol)):
        c = complex(h2[p, q, r, s])
        for t1 in dag[p]:
            for t2 in dag[q]:
                t12 = _mul(t1, t2)
                for t3 in ann[r]:
                    t123 = _mul(t12, t3)
                    for t4 in ann[s]:
                        cc, x, z = _mul(t123, t4)
                        out.add(c * cc, x, z)
    return out.compress(tol)


def _map_interaction_operator(constant, h1, h2, mapping: str, tol=1e-12) -> PauliSum:
    """Map ``(constant, h1, h2)`` (tensors on any device, or arrays) to a
    PauliSum: the C++ engine up to 63 qubits, the plain version above."""
    h1, h2 = to_host(h1), to_host(h2)
    n = h1.shape[0]
    if n > 63:
        return _map_python(constant, h1, h2, mapping, tol)
    ladder = _ladder_factory(mapping, n)
    x_u, z_u, vals = _map_native(n, [ladder(p, True) for p in range(n)],
                                 [ladder(p, False) for p in range(n)], h1, h2, tol)
    out = PauliSum(n)
    out.terms.update(zip(zip(x_u.tolist(), z_u.tolist()), vals.tolist()))
    out.add(complex(constant), 0, 0)
    return out.compress(tol)


def jordan_wigner(constant, h1, h2, tol=1e-12) -> PauliSum:
    """JW-map an interaction operator ``(constant, h1, h2)`` to qubits."""
    return _map_interaction_operator(constant, h1, h2, "jw", tol)


def bravyi_kitaev(constant, h1, h2, tol=1e-12) -> PauliSum:
    """BK-map (Fenwick-tree construction) an interaction operator."""
    return _map_interaction_operator(constant, h1, h2, "bk", tol)


def parity_transform(constant, h1, h2, tol=1e-12) -> PauliSum:
    """Parity-encode an interaction operator (qubit j stores the mod-2
    particle count of modes 0..j). Number-parity conservation becomes the
    single-qubit symmetry Z_{n-1}, which :func:`taper` removes."""
    return _map_interaction_operator(constant, h1, h2, "parity", tol)


#: name -> transform, for config-driven mapping selection
MAPPINGS = {"jw": jordan_wigner, "bk": bravyi_kitaev, "parity": parity_transform}


def _term_arrays(psum: PauliSum):
    xs = np.array([k[0] for k in psum.terms], dtype=np.int64)
    zs = np.array([k[1] for k in psum.terms], dtype=np.int64)
    cs = np.array(list(psum.terms.values()), dtype=np.complex128)
    return xs, zs, cs


def _parity_int64(arr):
    """Bit parity of each element of an int64 array."""
    arr = arr.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        arr ^= arr >> shift
    return arr & 1


def _grouped_weights(psum: PauliSum):
    """One dense column-weight vector per distinct X mask.

    A term ``c X^x Z^z`` maps column ``col`` to ``col ^ x`` scaled by
    ``c (-1)^parity(col & z)``; terms sharing an X mask share the
    permutation, so their diagonals sum into one ``w_x[col]`` and the
    matrix action is ``out[col ^ x] += w_x * v`` over the distinct masks.
    Returns (masks, weights (n_masks, 2^n) complex, 2^n).
    """
    dim = 1 << psum.n_qubits
    xs, zs, cs = _term_arrays(psum)
    cols = np.arange(dim, dtype=np.int64)
    ux, inv = np.unique(xs, return_inverse=True)
    weights = np.zeros((len(ux), dim), dtype=np.complex128)
    for t in range(len(xs)):
        weights[inv[t]] += cs[t] * (1.0 - 2.0 * _parity_int64(cols & zs[t]))
    return ux, weights, dim


def measurement_groups(psum: PauliSum):
    """Partition the Pauli sum into qubit-wise-commuting groups, each
    measurable in one circuit execution.

    Greedy first-fit over the terms by descending |coefficient|; a group is
    summarised by the OR of its X and Z masks, and a term fits iff on every
    qubit where both act the (X, Z) bits agree. Returns a list of groups,
    each a list of ``((x, z), coeff)`` items.
    """
    items = sorted(psum.terms.items(), key=lambda kv: -abs(kv[1]))
    if not items:
        return []
    membership = []  # term index -> group index
    if psum.n_qubits <= 63:
        gx = np.zeros(0, dtype=np.int64)
        gz = np.zeros(0, dtype=np.int64)
        for (x, z), _ in items:
            common = (x | z) & (gx | gz)
            fits = ((x & common) == (gx & common)) & ((z & common) == (gz & common))
            hit = np.nonzero(fits)[0]
            if hit.size:
                g = int(hit[0])
                gx[g] |= x
                gz[g] |= z
            else:
                g = len(gx)
                gx = np.append(gx, np.int64(x))
                gz = np.append(gz, np.int64(z))
            membership.append(g)
        n_groups = len(gx)
    else:  # arbitrary-width Python-integer masks
        gx_l, gz_l = [], []
        for (x, z), _ in items:
            for g, (mx, mz) in enumerate(zip(gx_l, gz_l)):
                common = (x | z) & (mx | mz)
                if (x & common) == (mx & common) and (z & common) == (mz & common):
                    gx_l[g] |= x
                    gz_l[g] |= z
                    membership.append(g)
                    break
            else:
                membership.append(len(gx_l))
                gx_l.append(x)
                gz_l.append(z)
        n_groups = len(gx_l)
    groups = [[] for _ in range(n_groups)]
    for item, g in zip(items, membership):
        groups[g].append(item)
    return groups


def pauli_sum_to_sparse(psum: PauliSum):
    """Explicit CSR matrix (small qubit counts only)."""
    ux, weights, dim = _grouped_weights(psum)
    cols = np.arange(dim, dtype=np.int64)
    rows = (cols[None, :] ^ ux[:, None]).ravel()
    return coo_matrix((weights.ravel(), (rows, np.tile(cols, len(ux)))),
                      shape=(dim, dim)).tocsr()


# nnz budget for materialising the CSR in pauli_ground_state (~3 GB at
# complex128 with two int64 index arrays); beyond it, stay matrix-free
_SPARSE_NNZ_LIMIT = 100_000_000


def pauli_ground_state(psum: PauliSum, k: int = 1):
    """Lowest-k eigenvalues of the Pauli sum: CSR + Lanczos where the
    grouped weights fit :data:`_SPARSE_NNZ_LIMIT`, else a matrix-free
    operator streaming the terms with O(2^n) memory."""
    dim = 1 << psum.n_qubits
    xs, zs, cs = _term_arrays(psum)
    if len(np.unique(xs)) * dim <= _SPARSE_NNZ_LIMIT:
        vals = eigsh(pauli_sum_to_sparse(psum), k=k, which="SA",
                     return_eigenvectors=False)
        return np.sort(vals)
    cols = np.arange(dim, dtype=np.int64)

    def matvec(v):
        out = np.zeros(dim, dtype=np.complex128)
        for x, z, c in zip(xs, zs, cs):
            out[cols ^ x] += c * (1.0 - 2.0 * _parity_int64(cols & z)) * v.ravel()
        return out

    op = LinearOperator((dim, dim), matvec=matvec, dtype=np.complex128)
    return np.sort(eigsh(op, k=k, which="SA", return_eigenvectors=False))
