"""Z2-symmetry qubit tapering of Pauli-sum Hamiltonians (port of
``nbed_tpu/ham/taper.py``, host Python).

Every Pauli symmetry ``tau`` that commutes with all terms of ``H`` lets one
qubit be removed exactly: a Clifford rotation ``U = (sigma + tau)/sqrt(2)``
(with ``sigma`` a single-qubit Pauli anticommuting with ``tau``) maps ``tau``
onto ``sigma``, after which every term of ``U H U`` acts on ``sigma``'s qubit
as I or ``sigma`` and the qubit collapses to its +-1 eigenvalue
(Bravyi-Gambetta-Mezzacapo-Temme, arXiv:1701.08213).

Symmetry finding is one GF(2) Gaussian elimination over bit-packed rows of
the terms' check matrix, and the Clifford rotations are XOR/popcount term
rewrites on the bitmask representation of :mod:`.qubit`. On Jordan-Wigner
molecular Hamiltonians the yield is two qubits from the alpha/beta
electron-number parities plus one per point-group Z2 symmetry (water/STO-3G:
14 -> 10 qubits, the FCI spectrum preserved in the chosen sector).
"""

from dataclasses import dataclass

from .qubit import PauliSum, _popcount, pauli_ground_state

__all__ = ["Z2Symmetry", "find_z2_symmetries", "taper", "taper_auto"]


@dataclass(frozen=True)
class Z2Symmetry:
    """One Z2 symmetry of a Pauli sum.

    Attributes:
        x, z: bitmasks of the Hermitian symmetry operator
            ``tau = (-i)^{popcount(x & z)} X^x Z^z``.
        qubit: index of the qubit the Clifford rotation maps ``tau`` onto.
        sigma_is_x: True if the single-qubit image is ``X_qubit``
            (``tau`` acts as Z or Y there), False for ``Z_qubit``.
    """

    x: int
    z: int
    qubit: int
    sigma_is_x: bool

    def string(self, n_qubits: int) -> str:
        return "".join("IXZY"[((self.x >> q) & 1) + 2 * ((self.z >> q) & 1)]
                       for q in range(n_qubits))


def _gf2_rref(rows, n_cols):
    """Reduced row echelon form over GF(2) of bit-packed integer rows.

    Column ``c`` is bit ``c`` of each row int.  Returns (pivot_rows,
    pivot_cols) with fully reduced rows (each pivot column is zero in every
    other row).
    """
    rows = [int(r) for r in rows if r]
    pivot_rows, pivot_cols = [], []
    for col in range(n_cols):
        mask = 1 << col
        hit = next((i for i, r in enumerate(rows) if r & mask), None)
        if hit is None:
            continue
        piv = rows.pop(hit)
        rows = [r ^ piv if r & mask else r for r in rows]
        pivot_rows = [r ^ piv if r & mask else r for r in pivot_rows]
        pivot_rows.append(piv)
        pivot_cols.append(col)
        if not rows and len(pivot_cols) == n_cols:
            break
    return pivot_rows, pivot_cols


def find_z2_symmetries(psum: PauliSum) -> list[Z2Symmetry]:
    """Find an independent generating set of Pauli Z2 symmetries of ``psum``.

    A Pauli ``(xs, zs)`` commutes with a term ``(x, z)`` iff
    ``parity(x & zs) ^ parity(z & xs) == 0``; the symmetries are the kernel
    of the terms' symplectic check matrix over GF(2).  The kernel is computed
    by RREF on the (n_terms x 2n) matrix with columns ordered
    ``[z-part | x-part]`` so that the free-variable construction lands
    symmetry pivots on Z bits whenever possible (pure-Z symmetries — the
    physically meaningful parities — come out as plain Z strings).

    Identity terms are ignored; single-qubit identity columns (qubits no
    term touches) are excluded rather than reported as trivial symmetries.
    """
    n = psum.n_qubits
    # check-matrix rows, packed: bit q = z-bit of term at qubit q,
    # bit n+q = x-bit.  Symmetry (sx, sz) must satisfy, for every term,
    # parity(x_t & sz) ^ parity(z_t & sx) == 0  — i.e. the packed symmetry
    # vector [sz | sx] (z-part low) dotted with packed term row [x_t | z_t]
    # must vanish.  We pack term rows as low = x_t (paired with sz), high
    # = z_t (paired with sx).
    rows = []
    acted = 0
    for (x, z) in psum.terms:
        acted |= x | z
        if x or z:
            rows.append(x | (z << n))
    if not rows:
        return []

    # RREF the term rows; kernel vectors come from the free columns.
    pivot_rows, pivot_cols = _gf2_rref(rows, 2 * n)
    pivot_set = set(pivot_cols)
    # Only build kernel vectors whose free column touches an acted-on qubit
    # (untouched qubits give trivial "symmetries" that taper nothing real).
    sym_vecs = []
    for free in range(2 * n):
        if free in pivot_set:
            continue
        q = free if free < n else free - n
        if not (acted >> q) & 1:
            continue
        vec = 1 << free
        # back-substitute: for each pivot row containing this free column,
        # set that row's pivot bit.
        for prow, pcol in zip(pivot_rows, pivot_cols):
            if (prow >> free) & 1:
                vec |= 1 << pcol
        sym_vecs.append(vec)
    if not sym_vecs:
        return []

    # RREF the symmetry vectors (columns z-part first, so the physically
    # meaningful Z-string parities come out as plain Z strings), then
    # greedily build an abelian tapering set: each accepted tau needs a
    # private qubit q and a single-qubit sigma in {X_q, Z_q} such that
    # sigma anticommutes with its tau and commutes with every other
    # accepted tau (and vice versa for the other taus' sigmas).  Kernel
    # vectors that cannot be accommodated (mutually anticommuting pairs —
    # impossible for molecular Z2 parities, possible for degenerate toy
    # Hamiltonians) are dropped: fewer qubits tapered, never wrong.
    sym_rows, _ = _gf2_rref(sym_vecs, 2 * n)
    nmask = (1 << n) - 1
    cands = [(vec & nmask, vec >> n) for vec in sym_rows]  # (sz, sx)

    def commute(a, b):
        return not ((_popcount(a[1] & b[0]) ^ _popcount(a[0] & b[1])) & 1)

    accepted = []  # (sz, sx, qubit, sigma_is_x)
    used = set()
    for sz, sx in cands:
        if not all(commute((sz, sx), (oz, ox)) for oz, ox, _, _ in accepted):
            continue
        choice = None
        for q in range(n):
            if q in used:
                continue
            # sigma = X_q anticommutes with tau iff tau has a z-bit at q,
            # and commutes with an accepted tau iff that tau has no z-bit
            # there; mirror condition for sigma = Z_q with x-bits.
            if (sz >> q) & 1 and all(
                    not (oz >> q) & 1 for oz, _, _, _ in accepted):
                choice = (q, True)
                break
            if (sx >> q) & 1 and all(
                    not (ox >> q) & 1 for _, ox, _, _ in accepted):
                choice = (q, False)
                break
        if choice is None:
            continue
        q, sigma_is_x = choice
        # the new tau must also commute with every accepted sigma
        ok = True
        for _, _, oq, o_is_x in accepted:
            bit_z, bit_x = (sz >> oq) & 1, (sx >> oq) & 1
            if o_is_x and bit_z:  # X_oq vs a z-bit at oq
                ok = False
            if (not o_is_x) and bit_x:
                ok = False
        if not ok:
            continue
        accepted.append((sz, sx, q, sigma_is_x))
        used.add(q)
    return [Z2Symmetry(x=sx, z=sz, qubit=q, sigma_is_x=s)
            for sz, sx, q, s in accepted]


def _hermitian_phase(x: int, z: int) -> complex:
    """Coefficient of the Hermitian Pauli in canonical X^x Z^z form."""
    return (-1j) ** (_popcount(x & z) % 4)


def _rotate(psum: PauliSum, sym: Z2Symmetry) -> PauliSum:
    """Apply the Clifford ``U H U`` with ``U = (sigma + tau)/sqrt(2)``.

    Every term commutes with ``tau``; terms commuting with ``sigma`` too are
    unchanged, the rest map to ``sigma * tau * P`` (an XOR of masks with a
    popcount sign).
    """
    sig_x = (1 << sym.qubit) if sym.sigma_is_x else 0
    sig_z = 0 if sym.sigma_is_x else (1 << sym.qubit)
    # Hermitian tau and sigma as canonical-form (coeff, x, z) factors.
    tau_c = _hermitian_phase(sym.x, sym.z)
    st_sign = -1.0 if (_popcount(sig_z & sym.x) & 1) else 1.0  # Z^sz past X^tx
    st_c = tau_c * st_sign
    st_x = sig_x ^ sym.x
    st_z = sig_z ^ sym.z
    out = PauliSum(psum.n_qubits)
    for (x, z), c in psum.terms.items():
        # commutes with sigma?
        if not ((_popcount(x & sig_z) ^ _popcount(z & sig_x)) & 1):
            out.add(c, x, z)
            continue
        # (sigma tau) * P in canonical form
        sign = -1.0 if (_popcount(st_z & x) & 1) else 1.0
        nx, nz = st_x ^ x, st_z ^ z
        # restore Hermitian-Pauli coefficient convention: the canonical
        # coefficient of the product must be divided by the phases that
        # belong to the letters themselves.  P and the result are stored
        # canonically, so only the explicit tau/sigma phases enter.
        out.add(c * st_c * sign, nx, nz)
    return out


def taper(psum: PauliSum, symmetries=None, sector=None) -> PauliSum:
    """Taper ``psum`` over its Z2 symmetries.

    Args:
        psum: the Hamiltonian.
        symmetries: output of :func:`find_z2_symmetries` (found if None).
        sector: iterable of +-1 eigenvalues, one per symmetry.  Required
            here; use :func:`taper_auto` to select it automatically.

    Returns:
        A PauliSum on ``n_qubits - len(symmetries)`` qubits whose spectrum
        is the restriction of ``psum`` to the chosen symmetry sector.
    """
    if symmetries is None:
        symmetries = find_z2_symmetries(psum)
    if not symmetries:
        return PauliSum(psum.n_qubits, psum.terms)
    sector = list(sector)
    if len(sector) != len(symmetries):
        raise ValueError(
            f"sector has {len(sector)} eigenvalues for "
            f"{len(symmetries)} symmetries")

    rotated = psum
    for sym in symmetries:
        rotated = _rotate(rotated, sym)

    drop = {s.qubit: (s, eig) for s, eig in zip(symmetries, sector)}
    keep = [q for q in range(psum.n_qubits) if q not in drop]
    new_pos = {q: i for i, q in enumerate(keep)}
    out = PauliSum(len(keep))
    for (x, z), c in rotated.terms.items():
        coeff = complex(c)
        nx = nz = 0
        for q in range(psum.n_qubits):
            bx, bz = (x >> q) & 1, (z >> q) & 1
            if q in drop:
                sym, eig = drop[q]
                if not (bx or bz):
                    continue
                # after rotation the action at q must be exactly sigma
                if sym.sigma_is_x and (bx, bz) == (1, 0):
                    coeff *= eig
                elif (not sym.sigma_is_x) and (bx, bz) == (0, 1):
                    coeff *= eig
                else:
                    raise ValueError(
                        "term acts on a tapered qubit with a non-sigma "
                        "Pauli after rotation — the symmetry set is not "
                        "an abelian tapering set for this Hamiltonian")
            else:
                p = new_pos[q]
                nx |= bx << p
                nz |= bz << p
        out.add(coeff, nx, nz)
    return out.compress()


def _sector_from_state(symmetries, bits: int):
    """Eigenvalues of pure-Z symmetries on a computational basis state
    (occupation bitmask, e.g. the JW Hartree-Fock determinant).  Returns
    None if any symmetry has an X component (expectation would be 0)."""
    sector = []
    for s in symmetries:
        if s.x:
            return None
        sector.append(1 - 2 * (_popcount(s.z & bits) & 1))
    return sector


def taper_auto(psum: PauliSum, hf_bits: int = None, k: int = 1):
    """Taper and pick the symmetry sector automatically.

    If ``hf_bits`` (occupied-spin-orbital bitmask of the reference
    determinant, JW convention: bit p = spin orbital p occupied) is given and
    all symmetries are Z strings, the sector is fixed analytically.
    Otherwise every sector is scanned with the matrix-free Lanczos oracle
    and the lowest-ground-energy sector wins — exact, and affordable because
    each tapered space is 2^k-fold smaller.

    Returns:
        (tapered PauliSum, symmetries, sector)
    """
    symmetries = find_z2_symmetries(psum)
    if not symmetries:
        return PauliSum(psum.n_qubits, psum.terms), [], []
    if hf_bits is not None:
        sector = _sector_from_state(symmetries, hf_bits)
        if sector is not None:
            return taper(psum, symmetries, sector), symmetries, sector

    best = None
    n_sym = len(symmetries)
    for code in range(1 << n_sym):
        sector = [1 - 2 * ((code >> i) & 1) for i in range(n_sym)]
        tapered = taper(psum, symmetries, sector)
        e0 = float(pauli_ground_state(tapered, k=1)[0])
        if best is None or e0 < best[0] - 1e-12:
            best = (e0, tapered, sector)
    _, tapered, sector = best
    return tapered, symmetries, sector
