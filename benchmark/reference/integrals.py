"""Gaussian integrals of the reference: S, T, V and the ERI tensor over
cartesian s and p functions, by McMurchie-Davidson (Hermite expansion and
the R recursion over the Boys function), vectorised over primitive pairs
in plain PyTorch.

Each AO is a contracted cartesian Gaussian normalised to unit self-overlap.
For s and p shells the cartesian and the real spherical functions span the
same space one to one, so every quantity the benchmark compares (energies,
spectra, norms, counts) is the port's, whatever the order of the AOs within
an atom.
"""

import math

import numpy as np
import torch

__all__ = ["Basis", "build_basis", "overlap_kinetic_nuclear", "eri_tensor"]

ANGSTROM_TO_BOHR = 1.0 / 0.52917721092
Z_OF = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}

# STO-3G (Hehre, Stewart and Pople 1969, as distributed by the Basis Set
# Exchange): per element, shells of (l, [(exponent, coefficient), ...])
_S1 = (0.15432897, 0.53532814, 0.44463454)
_S2 = (-0.09996723, 0.39951283, 0.70011547)
_P2 = (0.15591627, 0.60768372, 0.39195739)
_EXPS = {
    "H": ((3.42525091, 0.62391373, 0.16885540),),
    "C": ((71.616837, 13.045096, 3.5305122), (2.9412494, 0.6834831, 0.2222899)),
    "N": ((99.106169, 18.052312, 4.8856602), (3.7804559, 0.8784966, 0.2857144)),
    "O": ((130.70932, 23.808861, 6.4436083), (5.0331513, 1.1695961, 0.3803890)),
    "F": ((166.67913, 30.360812, 8.2168207), (6.4648032, 1.5022812, 0.4885885)),
}


def _shells(symbol):
    exps = _EXPS[symbol]
    out = [(0, list(zip(exps[0], _S1)))]
    if len(exps) > 1:
        out += [(0, list(zip(exps[1], _S2))), (1, list(zip(exps[1], _P2)))]
    return out


class Basis:
    """Primitive cartesian functions of a molecule: centre, exponent, powers,
    contraction coefficient (primitive norm folded in) and owning AO."""

    def __init__(self, symbols, coords, prims, nao, ao_atom):
        self.symbols = symbols
        self.coords = coords          # (natm, 3) bohr, float64 numpy
        self.charges = np.array([Z_OF[s] for s in symbols], dtype=float)
        self.center, self.alpha, self.powers, self.coef, self.ao = prims
        self.nao = nao
        self.ao_atom = ao_atom        # (nao,) owning atom of each AO

    @property
    def nelectron(self) -> int:
        return int(self.charges.sum())

    def n_aos_of_first_atoms(self, n_atoms: int) -> int:
        return int(np.sum(self.ao_atom < n_atoms))

    def energy_nuc(self) -> float:
        e = 0.0
        for i in range(len(self.symbols)):
            for j in range(i):
                e += self.charges[i] * self.charges[j] / np.linalg.norm(
                    self.coords[i] - self.coords[j])
        return float(e)


def parse_xyz(text: str):
    """(symbols, coordinates in bohr) of XYZ text in angstrom."""
    lines = text.strip("\n").splitlines()
    natm = int(lines[0].split()[0])
    symbols, coords = [], []
    for line in lines[2:2 + natm]:
        parts = line.split()
        symbols.append(parts[0].capitalize())
        coords.append([float(v) for v in parts[1:4]])
    return symbols, np.array(coords) * ANGSTROM_TO_BOHR


def build_basis(xyz: str) -> Basis:
    symbols, coords = parse_xyz(xyz)
    center, alpha, powers, coef, ao, ao_atom = [], [], [], [], [], []
    nao = 0
    for ia, sym in enumerate(symbols):
        for l, prims in _shells(sym):
            comps = [(0, 0, 0)] if l == 0 else [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
            for comp in comps:
                for a, c in prims:
                    # norm of x^l e^{-a r^2} (l = 0, 1 along one axis)
                    norm = (2 * a / math.pi) ** 0.75 * (4 * a) ** (l / 2)
                    center.append(ia)
                    alpha.append(a)
                    powers.append(comp)
                    coef.append(c * norm)
                    ao.append(nao)
                ao_atom.append(ia)
                nao += 1
    prims = (np.array(center), np.array(alpha), np.array(powers), np.array(coef),
             np.array(ao))
    basis = Basis(symbols, coords, prims, nao, np.array(ao_atom))
    # renormalise each contracted AO to unit self-overlap
    s = _contracted(basis, _pair_overlap(basis, torch.float64, "cpu"), torch.float64, "cpu")
    basis.coef = basis.coef / np.sqrt(np.diag(s.numpy()))[basis.ao]
    return basis


# ------------------------------------------------------------ pair data

def _pairs(basis: Basis):
    """Index arrays (f, g) of the primitive pairs f <= g."""
    n = len(basis.alpha)
    f, g = np.triu_indices(n)
    return f, g


def _hermite_e(imax, jmax, q, a, b):
    """Hermite expansion coefficients E[i][j][t] along one axis for all
    pairs: q = A - B, exponents a, b (tensors)."""
    p = a + b
    mu = a * b / p
    xpa, xpb = -b * q / p, a * q / p
    e = {(0, 0, 0): torch.exp(-mu * q * q)}

    def get(i, j, t):
        if t < 0 or t > i + j or i < 0 or j < 0:
            return None
        return e.get((i, j, t))

    def add(*terms):
        out = None
        for term in terms:
            if term is not None:
                out = term if out is None else out + term
        return out

    for i in range(imax + 1):
        for j in range(jmax + 1):
            if (i, j) == (0, 0):
                continue
            for t in range(i + j + 1):
                if i > 0:
                    prev = (i - 1, j)
                    xp = xpa
                else:
                    prev = (i, j - 1)
                    xp = xpb
                lo, hi, mid = get(*prev, t - 1), get(*prev, t + 1), get(*prev, t)
                e[(i, j, t)] = add(None if lo is None else lo / (2 * p),
                                   None if mid is None else xp * mid,
                                   None if hi is None else (t + 1) * hi)
    return e


def _boys(nmax, t):
    """F_n(t) for n = 0..nmax, [nmax + 1] list of tensors."""
    small = t < 0.5
    ts = torch.where(small, t, torch.zeros_like(t))
    tl = torch.where(small, torch.ones_like(t), t)
    series = torch.zeros_like(t)
    term = torch.ones_like(t)
    for k in range(24):
        series = series + term / (2 * nmax + 2 * k + 1)
        term = term * (-ts) / (k + 1)
    a = nmax + 0.5
    large = math.gamma(a) * torch.special.gammainc(torch.full_like(tl, a), tl) / (2 * tl ** a)
    f = [None] * (nmax + 1)
    f[nmax] = torch.where(small, series, large)
    ex = torch.exp(-t)
    for n in range(nmax - 1, -1, -1):
        f[n] = (2 * t * f[n + 1] + ex) / (2 * n + 1)
    return f


def _r_table(lmax, p, x, y, z):
    """Hermite Coulomb integrals R_tuv (t + u + v <= lmax) for exponent p and
    separation (x, y, z), as a dict of tensors."""
    f = _boys(lmax, p * (x * x + y * y + z * z))
    memo = {}

    def r(t, u, v, n):
        key = (t, u, v, n)
        if key in memo:
            return memo[key]
        if t < 0 or u < 0 or v < 0:
            return None
        if t == u == v == 0:
            out = (-2 * p) ** n * f[n]
        elif t > 0:
            out = x * r(t - 1, u, v, n + 1)
            if t > 1:
                out = out + (t - 1) * r(t - 2, u, v, n + 1)
        elif u > 0:
            out = y * r(t, u - 1, v, n + 1)
            if u > 1:
                out = out + (u - 1) * r(t, u - 2, v, n + 1)
        else:
            out = z * r(t, u, v - 1, n + 1)
            if v > 1:
                out = out + (v - 1) * r(t, u, v - 2, n + 1)
        memo[key] = out
        return out

    return {(t, u, v): r(t, u, v, 0) for t in range(lmax + 1) for u in range(lmax + 1 - t)
            for v in range(lmax + 1 - t - u)}


class _PairData:
    """Per primitive pair: exponent sum, centre P, prefactors and the
    per-axis Hermite tables E[i][j][t] (i, j <= 3 on the second function)."""

    def __init__(self, basis: Basis, dtype, device, jmax=1):
        f, g = _pairs(basis)
        self.f, self.g = f, g

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        a, b = t(basis.alpha[f]), t(basis.alpha[g])
        ca, cb = basis.coords[basis.center[f]], basis.coords[basis.center[g]]
        self.p = a + b
        self.P = (a[:, None] * t(ca) + b[:, None] * t(cb)) / self.p[:, None]
        self.e = [_hermite_e(1, jmax, t(ca[:, d] - cb[:, d]), a, b) for d in range(3)]
        self.pa = torch.as_tensor(basis.powers[f], device=device)
        self.pb = torch.as_tensor(basis.powers[g], device=device)
        self.b = b

    def e_axis(self, d, shift=0, t=0):
        """E^{i, j + shift}_t along axis d, i and j the pair's own powers."""
        i, j = self.pa[:, d], self.pb[:, d] + shift
        out = torch.zeros_like(self.p)
        for (ii, jj, tt), val in self.e[d].items():
            if tt == t:
                out = torch.where((i == ii) & (j == jj), val, out)
        return out

    def hermite(self):
        """(npair, 10) coefficients E_tuv for t + u + v <= 2 and their
        (t, u, v) list."""
        keys = [(t, u, v) for t in range(3) for u in range(3 - t) for v in range(3 - t - u)]
        cols = [self.e_axis(0, 0, t) * self.e_axis(1, 0, u) * self.e_axis(2, 0, v)
                for t, u, v in keys]
        return torch.stack(cols, dim=1), keys


def _pair_overlap(basis, dtype, device):
    pd = _PairData(basis, dtype, device)
    return pd, (math.pi / pd.p) ** 1.5 * pd.e_axis(0) * pd.e_axis(1) * pd.e_axis(2)


def _contraction(basis: Basis, pd, dtype, device):
    """(nao*nao, npair) matrix C with AO-pair values = C @ primitive-pair
    values (both orders of an off-diagonal pair)."""
    n = basis.nao
    w = basis.coef[pd.f] * basis.coef[pd.g]
    rows = basis.ao[pd.f] * n + basis.ao[pd.g]
    rows_t = basis.ao[pd.g] * n + basis.ao[pd.f]
    cols = np.arange(len(pd.f))
    c = np.zeros((n * n, len(pd.f)))
    np.add.at(c, (rows, cols), w)
    off = pd.f != pd.g
    np.add.at(c, (rows_t[off], cols[off]), w[off])
    return torch.as_tensor(c, dtype=dtype, device=device)


def _contracted(basis, pair_values, dtype, device):
    pd, vals = pair_values
    c = _contraction(basis, pd, dtype, device)
    return (c @ vals).reshape(basis.nao, basis.nao)


def overlap_kinetic_nuclear(basis: Basis, dtype=torch.float64, device="cpu"):
    """(S, T, V) as (nao, nao) tensors."""
    pd = _PairData(basis, dtype, device, jmax=3)
    sq = torch.sqrt(math.pi / pd.p)
    s1 = [pd.e_axis(d) * sq for d in range(3)]
    # <i| d^2/dx^2 |j> = j(j-1) S_{i,j-2} - 2b(2j+1) S_{ij} + 4 b^2 S_{i,j+2}
    lap = []
    for d in range(3):
        j = pd.pb[:, d].to(pd.p.dtype)
        lower = torch.where(pd.pb[:, d] >= 2, pd.e_axis(d, -2) * sq, torch.zeros_like(sq))
        lap.append(j * (j - 1) * lower - 2 * pd.b * (2 * j + 1) * s1[d]
                   + 4 * pd.b ** 2 * pd.e_axis(d, 2) * sq)
    s = s1[0] * s1[1] * s1[2]
    t = -0.5 * (lap[0] * s1[1] * s1[2] + s1[0] * lap[1] * s1[2] + s1[0] * s1[1] * lap[2])
    herm, keys = pd.hermite()
    v = torch.zeros_like(s)
    for ia, z in enumerate(basis.charges):
        c = torch.as_tensor(basis.coords[ia], dtype=dtype, device=device)
        d = pd.P - c
        r = _r_table(2, pd.p, d[:, 0], d[:, 1], d[:, 2])
        v = v - z * (2 * math.pi / pd.p) * sum(herm[:, k] * r[key] for k, key in enumerate(keys))
    out = [_contracted(basis, (pd, x), dtype, device) for x in (s, t, v)]
    return out[0], out[1], out[2]


def eri_tensor(basis: Basis, dtype=torch.float64, device="cpu", chunk=96):
    """(nao, nao, nao, nao) electron repulsion integrals (ij|kl)."""
    pd = _PairData(basis, dtype, device)
    herm, keys = pd.hermite()
    sign = torch.tensor([(-1.0) ** (t + u + v) for t, u, v in keys], dtype=dtype, device=device)
    herm_k = herm * sign[None, :]
    sums = sorted({(a[0] + b[0], a[1] + b[1], a[2] + b[2]) for a in keys for b in keys})
    pos = {s: i for i, s in enumerate(sums)}
    index = torch.tensor([[pos[(a[0] + b[0], a[1] + b[1], a[2] + b[2])] for b in keys]
                          for a in keys], device=device)
    c = _contraction(basis, pd, dtype, device)
    n = basis.nao
    out = torch.zeros((n * n, n * n), dtype=dtype, device=device)
    q_all, qp = pd.p, pd.P
    for start in range(0, len(pd.f), chunk):
        sl = slice(start, start + chunk)
        p = pd.p[sl][:, None]
        q = q_all[None, :]
        alpha = p * q / (p + q)
        d = pd.P[sl][:, None, :] - qp[None, :, :]
        r = _r_table(4, alpha, d[..., 0], d[..., 1], d[..., 2])
        rs = torch.stack([r[s] for s in sums], dim=-1)          # (a, b, 35)
        m = rs[:, :, index]                                      # (a, b, 10, 10)
        vals = torch.einsum("ah,abhk,bk->ab", herm[sl], m, herm_k)
        vals = vals * (2 * math.pi ** 2.5) / (p * q * torch.sqrt(p + q))
        out += c[:, sl] @ vals @ c.T
    return out.reshape(n, n, n, n)
