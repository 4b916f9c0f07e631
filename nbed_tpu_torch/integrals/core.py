"""One-electron integrals in torch: overlap, cross-basis overlap, kinetic
energy, nuclear and point-charge attraction, and dipoles (port of
``nbed_tpu/integrals/core.py``).

Shell pairs are grouped into (la, lb, Ka, Kb) classes on the host, as in
the reference; each class is one batched McMurchie-Davidson computation
over its whole pair list (the reference ``vmap``s one pair), contracted
over primitives, turned spherical and accumulated into the AO matrix by
the class's precomputed indices. Every function is pure torch arithmetic
on the coordinates (the molecule's and the point charges'), so autograd
passes through it. Coordinates of shape (B, natm, 3) give B lanes (a batch
of conformers) in the same computations, the lane axis leading every
primitive tensor, and a (B, ...) result. The SCF engine keeps the host C++ engine
(``integrals.native``) for its own V; these serve the nuclear gradients.
"""

from functools import lru_cache

import numpy as np
import torch

from .._device import DTYPE, resolve_device
from ..chem.molecule import Molecule, cartesian_components
from .md import e_table_1d, hermite_r

__all__ = ["overlap", "overlap_cross", "kinetic", "nuclear_attraction",
           "point_charge_attraction", "dipole_integrals"]


# --------------------------------------------------------------------------
# host-side class tables
# --------------------------------------------------------------------------

def _group_pairs(shells_a, shells_b, symmetric):
    """{(la, lb, Ka, Kb): [(i, j), ...]}: shell pairs by class."""
    groups = {}
    for i, sa in enumerate(shells_a):
        js = range(i, len(shells_b)) if symmetric else range(len(shells_b))
        for j in js:
            sb = shells_b[j]
            key = (sa.l, sb.l, len(sa.exps), len(sb.exps))
            groups.setdefault(key, []).append((i, j))
    return groups


class _PairTable:
    """Arrays for one (la, lb, Ka, Kb) class of shell pairs."""

    def __init__(self, key, pairs, shells_a, shells_b, nao_b):
        la, lb, _, _ = key
        self.la, self.lb = la, lb
        sa = [shells_a[i] for i, _ in pairs]
        sb = [shells_b[j] for _, j in pairs]
        self.atom_a = np.array([s.atom for s in sa])
        self.atom_b = np.array([s.atom for s in sb])
        self.exps_a = np.array([s.exps for s in sa])
        self.coefs_a = np.array([s.coeffs for s in sa])
        self.exps_b = np.array([s.exps for s in sb])
        self.coefs_b = np.array([s.coeffs for s in sb])
        self.c2s_a = np.array([s.cart2sph for s in sa])  # (P, nca, nsa)
        self.c2s_b = np.array([s.cart2sph for s in sb])
        nsa, nsb = 2 * la + 1, 2 * lb + 1
        offs_a = np.array([s.ao_offset for s in sa])
        offs_b = np.array([s.ao_offset for s in sb])
        rows = offs_a[:, None, None] + np.arange(nsa)[None, :, None]
        cols = offs_b[:, None, None] + np.arange(nsb)[None, None, :]
        rows = np.broadcast_to(rows, (len(pairs), nsa, nsb)).ravel()
        cols = np.broadcast_to(cols, (len(pairs), nsa, nsb)).ravel()
        # flat indices into the (nao_a, nao_b) matrix and its transpose
        self.flat = rows * nao_b + cols
        self.flat_mirror = cols * nao_b + rows
        # mirror only blocks of distinct shells: a diagonal (i, i) shell
        # block already holds both triangles
        distinct = np.array([i != j for i, j in pairs], dtype=np.float64)
        self.mirror_mask = np.repeat(distinct, nsa * nsb)


@lru_cache(maxsize=128)
def _pair_tables(mol_a: Molecule, mol_b: Molecule, symmetric: bool):
    groups = _group_pairs(mol_a.shells, mol_b.shells, symmetric)
    return [_PairTable(key, pairs, mol_a.shells, mol_b.shells, mol_b.nao)
            for key, pairs in sorted(groups.items())]


@lru_cache(maxsize=64)
def _device_pair_tables(mol_a: Molecule, mol_b: Molecule, symmetric: bool,
                        device: torch.device):
    """The class tables of :func:`_pair_tables` as tensors on ``device``,
    made once per (molecule pair, symmetric, device) as
    :func:`nbed_tpu_torch.integrals.eri._device_tables` does for the ERIs:
    repeated calls (the displaced gradients of a Hessian, the steps of an
    optimization, a CUDA graph's body) copy nothing from the host."""
    def f64(a):
        return torch.as_tensor(a, dtype=DTYPE, device=device)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return [dict(la=t.la, lb=t.lb, atom_a=idx(t.atom_a), atom_b=idx(t.atom_b),
                 exps_a=f64(t.exps_a), exps_b=f64(t.exps_b), coefs_a=f64(t.coefs_a),
                 coefs_b=f64(t.coefs_b), c2s_a=f64(t.c2s_a), c2s_b=f64(t.c2s_b),
                 flat=idx(t.flat), flat_mirror=idx(t.flat_mirror),
                 mirror_mask=f64(t.mirror_mask))
            for t in _pair_tables(mol_a, mol_b, symmetric)]


@lru_cache(maxsize=None)
def _powers(l: int, device: torch.device):
    """The x, y, z powers of the cartesian components of ``l`` as index
    tensors on ``device``; unbounded, as ``md._cross_tables`` (a graph
    reads them by address). The bounded caches of this module are per
    molecule: a derivative program holds the entries its graph reads."""
    return tuple(torch.as_tensor(p, device=device) for p in _comp_powers(l))


@lru_cache(maxsize=64)
def _nuclear_charges(mol: Molecule, device: torch.device):
    return torch.as_tensor(mol.atom_charges, dtype=DTYPE, device=device)


@lru_cache(maxsize=64)
def _mm_tensors(mol: Molecule, device: torch.device):
    """``mol``'s MM charges (centers, charges, radii or None) on
    ``device``, the constants of its point-charge attraction."""
    return (_on(mol.mm_coords, device), _on(mol.mm_charges, device),
            None if mol.mm_radii is None else _on(mol.mm_radii, device))


def _on(a, device):
    """``a`` as a float64 tensor on ``device``; a tensor that already is
    one passes as it is (no host copy, and autograd follows it)."""
    if isinstance(a, torch.Tensor) and a.dtype == DTYPE and a.device == device:
        return a
    return torch.as_tensor(a, dtype=DTYPE, device=device)


# --------------------------------------------------------------------------
# per-class primitive integrals: ra, rb (P, 1, 1, 3); a (P, Ka, 1),
# b (P, 1, Kb) -> (P, Ka, Kb, [3,] nca, ncb)
# --------------------------------------------------------------------------

def _comp_powers(l):
    comps = cartesian_components(l)
    return tuple(np.array([c[d] for c in comps]) for d in range(3))


def _e_tables(la, lb, a, b, ab_vec, extra_b=0):
    """E tables per cartesian direction, optionally extended in j."""
    return [e_table_1d(la, lb + extra_b, a, b, ab_vec[..., d]) for d in range(3)]


def _sel(table, ia, jb):
    """table[..., ia, jb] over every component pair -> (..., nca, ncb),
    by two ``index_select`` (whose backward adds, with no sort)."""
    return table.index_select(-2, ia).index_select(-1, jb)


def _overlap_prim(la, lb):
    def f(ra, rb, a, b):
        pa, pb = _powers(la, a.device), _powers(lb, a.device)
        p = a + b
        ex, ey, ez = _e_tables(la, lb, a, b, ra - rb)
        pref = ((np.pi / p) ** 1.5)[..., None, None]
        return (pref * _sel(ex[..., 0], pa[0], pb[0]) * _sel(ey[..., 0], pa[1], pb[1])
                * _sel(ez[..., 0], pa[2], pb[2]))

    return f


def _kinetic_prim(la, lb):
    def f(ra, rb, a, b):
        pa, pb = _powers(la, a.device), _powers(lb, a.device)
        p = a + b
        sq = torch.sqrt(np.pi / p)[..., None, None]
        s1 = [e[..., 0] * sq for e in _e_tables(la, lb, a, b, ra - rb, extra_b=2)]
        bb = b[..., None, None]
        j = torch.arange(lb + 1, dtype=a.dtype, device=a.device)
        t1 = []
        for s in s1:  # 1D overlaps (..., la+1, lb+3)
            s_ij = s[..., : lb + 1]
            s_ijp2 = s[..., 2: lb + 3]
            # s_{i,j-2} with zero padding
            s_ijm2 = torch.nn.functional.pad(s[..., : max(lb - 1, 0)], (2, 0))[..., : lb + 1]
            t1.append(bb * (2 * j + 1) * s_ij - 2.0 * bb * bb * s_ijp2
                      - 0.5 * (j * (j - 1)) * s_ijm2)
        sx, sy, sz = (_sel(s1[d], pa[d], pb[d]) for d in range(3))
        tx, ty, tz = (_sel(t1[d], pa[d], pb[d]) for d in range(3))
        return tx * sy * sz + sx * ty * sz + sx * sy * tz

    return f


def _e3_tensor(la, lb, a, b, ab_vec):
    """Combined Hermite expansion E3[..., ca, cb, t, u, v]."""
    pa, pb = _powers(la, a.device), _powers(lb, a.device)
    ex, ey, ez = (e.index_select(-3, pa[d]).index_select(-2, pb[d])
                  for d, e in enumerate(_e_tables(la, lb, a, b, ab_vec)))
    return torch.einsum("...abt,...abu,...abv->...abtuv", ex, ey, ez)


def _nuclear_prim(la, lb):
    """Attraction to point charges ``charges`` (N,) at ``centers`` (N, 3)."""
    lmax = la + lb

    def f(ra, rb, a, b, centers, charges):
        p = a + b
        big_p = (a[..., None] * ra + b[..., None] * rb) / p[..., None]  # (..., 3)
        e3 = _e3_tensor(la, lb, a, b, ra - rb)
        r = hermite_r(lmax, p[..., None], big_p[..., None, :] - centers)  # (..., N, T, T, T)
        rz = torch.einsum("...ntuv,n->...tuv", r, -charges)
        return (2 * np.pi / p)[..., None, None] * torch.einsum("...abtuv,...tuv->...ab", e3, rz)

    return f


def _smeared_prim(la, lb):
    """Attraction to Gaussian charges of exponents ``etas`` (QM/MM with
    radii)."""
    lmax = la + lb

    def f(ra, rb, a, b, centers, charges, etas):
        p = a + b
        big_p = (a[..., None] * ra + b[..., None] * rb) / p[..., None]
        e3 = _e3_tensor(la, lb, a, b, ra - rb)
        pn = p[..., None]  # (..., 1) against the charges' axis
        r = hermite_r(lmax, pn * etas / (pn + etas), big_p[..., None, :] - centers)
        pref = -charges * (2 * np.pi / pn) * torch.sqrt(etas / (pn + etas))  # (..., N)
        return torch.einsum("...abtuv,...ntuv,...n->...ab", e3, r, pref)

    return f


def _dipole_prim(la, lb):
    def f(ra, rb, a, b):
        """-> (..., 3, nca, ncb): x, y, z dipole blocks about the origin."""
        pa, pb = _powers(la, a.device), _powers(lb, a.device)
        p = a + b
        sq = torch.sqrt(np.pi / p)[..., None, None]
        s1 = [e[..., 0] * sq for e in _e_tables(la, lb, a, b, ra - rb, extra_b=1)]
        out = []
        for d in range(3):
            # <i| x_d |j> = s_{i, j+1} + B_d s_{ij} along direction d
            dip1 = s1[d][..., 1: lb + 2] + rb[..., d, None, None] * s1[d][..., : lb + 1]
            mats = [_sel(dip1 if dim == d else s1[dim][..., : lb + 1], pa[dim], pb[dim])
                    for dim in range(3)]
            out.append(mats[0] * mats[1] * mats[2])
        return torch.stack(out, dim=-3)

    return f


# --------------------------------------------------------------------------
# assembly
# --------------------------------------------------------------------------

def _contract_pairs(table: dict, coords_a, coords_b, prim_factory, extra=()):
    """One class (its :func:`_device_pair_tables` entry): primitive
    integrals over the whole pair list, contracted and made spherical ->
    ([B,] P, [3,] nsa, nsb), B the lanes of (B, natm, 3) coordinates.
    ``extra`` tensors (point charges) follow the primitive arguments."""
    lanes = coords_a.ndim == 3
    ra = coords_a.index_select(-2, table["atom_a"])[..., :, None, None, :]
    rb = coords_b.index_select(-2, table["atom_b"])[..., :, None, None, :]
    fij = prim_factory(table["la"], table["lb"])(
        ra, rb, table["exps_a"][:, :, None], table["exps_b"][:, None, :], *extra)
    if lanes:  # (B, P, Ka, Kb, ...) -> (P, Ka, Kb, B, ...): the lane rides in "..."
        fij = fij.movedim(0, 3)
    block = torch.einsum("pi,pj,pij...->p...", table["coefs_a"], table["coefs_b"], fij)
    out = torch.einsum("p...ab,pax,pby->p...xy", block, table["c2s_a"], table["c2s_b"])
    return out.movedim(1, 0) if lanes else out


def _assemble(mol_a, mol_b, coords_a, coords_b, prim_factory, symmetric, n_ops=None,
              extra=()):
    """Accumulate every class into the (nao_a, nao_b) matrix, or the
    (n_ops, nao_a, nao_b) stack, by index addition: several classes write
    the same entries only through the mirror of the symmetric case, and
    ``index_add`` sums repeated indices. (B, natm, 3) coordinates put a
    lane axis in front."""
    dev = coords_a.device
    lead = tuple(coords_a.shape[:-2])
    shape = lead + ((mol_a.nao * mol_b.nao,) if n_ops is None
                    else (n_ops, mol_a.nao * mol_b.nao))
    out = torch.zeros(shape, dtype=DTYPE, device=dev)
    for table in _device_pair_tables(mol_a, mol_b, symmetric, dev):
        blocks = _contract_pairs(table, coords_a, coords_b, prim_factory, extra)
        if n_ops is None:
            vals = blocks.reshape(*lead, -1)
        else:
            vals = blocks.movedim(len(lead) + 1, len(lead)).reshape(*lead, n_ops, -1)
        out = out.index_add(-1, table["flat"], vals)
        if symmetric:
            out = out.index_add(-1, table["flat_mirror"], vals * table["mirror_mask"])
    return out.reshape(shape[:-1] + (mol_a.nao, mol_b.nao))


def _coords(mol, coords, device):
    return _on(mol.coords if coords is None else coords, device)


def overlap(mol: Molecule, coords=None, device="cuda"):
    """AO overlap matrix S (nao, nao) on ``device``; ``coords`` (Bohr)
    defaults to the molecule's. Coordinates (B, natm, 3) give (B, nao, nao),
    as for every function of this module."""
    c = _coords(mol, coords, resolve_device(device))
    return _assemble(mol, mol, c, c, _overlap_prim, symmetric=True)


def overlap_cross(mol_a: Molecule, mol_b: Molecule, coords_a=None, coords_b=None,
                  device="cuda"):
    """Cross-basis overlap <a|b> (nao_a, nao_b), used by IBO and by concentric
    localization onto another basis."""
    device = resolve_device(device)
    return _assemble(mol_a, mol_b, _coords(mol_a, coords_a, device),
                     _coords(mol_b, coords_b, device), _overlap_prim, symmetric=False)


def kinetic(mol: Molecule, coords=None, device="cuda"):
    """Kinetic-energy matrix T (nao, nao)."""
    c = _coords(mol, coords, resolve_device(device))
    return _assemble(mol, mol, c, c, _kinetic_prim, symmetric=True)


def nuclear_attraction(mol: Molecule, coords=None, device="cuda"):
    """Nuclear-attraction matrix V (nao, nao) over the molecule's nuclei at
    ``coords`` (the MM charges of a QM/MM molecule are not in it: see
    :func:`point_charge_attraction`)."""
    c = _coords(mol, coords, resolve_device(device))
    z = _nuclear_charges(mol, c.device)
    # the nuclei of a lane align with its (P, Ka, Kb) primitives
    centers = c[:, None, None, None] if c.ndim == 3 else c
    return _assemble(mol, mol, c, c, _nuclear_prim, symmetric=True, extra=(centers, z))


def core_program(mol: Molecule, coords, jit_kernel: str = "auto"):
    """(S, T + V) at ``coords`` ((natm, 3) or (B, natm, 3) tensor). Where
    the coordinates carry a forward-mode tangent and ``jit_kernel`` takes a
    program ("on", or "auto" on a card), both with their tangents from the
    derivative program of kind "core_jvp": one CUDA graph per (structure,
    shape, card) in :data:`nbed_tpu_torch.ops.programs.DERIVATIVE_PROGRAMS`
    (dual tensors the caller owns); else :func:`overlap`,
    :func:`kinetic` and :func:`nuclear_attraction` on ``coords``' device."""
    from ..ops.programs import (TangentProgram, derivative_program, has_tangent, structure_key,
                                takes_program)

    dev = coords.device
    if not (has_tangent(coords) and takes_program(jit_kernel, (coords,), tangent=True)):
        return (overlap(mol, coords, device=dev),
                kinetic(mol, coords, device=dev) + nuclear_attraction(mol, coords, device=dev))
    shape = tuple(coords.shape)

    def build(device, pool):
        def fn(x):
            return {"s": overlap(mol, x, device=device),
                    "hcore": kinetic(mol, x, device=device)
                    + nuclear_attraction(mol, x, device=device)}

        return TangentProgram("core_jvp", {"x": torch.zeros(shape, dtype=DTYPE, device=device)},
                              fn, device,
                              pool, holds=(_device_pair_tables(mol, mol, True, device),
                                           _nuclear_charges(mol, device)))

    out = derivative_program(("core_jvp", structure_key(mol), shape), dev, build)(x=coords)
    return out["s"].clone(), out["hcore"].clone()


def point_charge_attraction(mol: Molecule, centers, charges, radii=None, coords=None,
                            device="cuda"):
    """External charge attraction added to hcore for QM/MM: point charges,
    or with ``radii`` Gaussian charges of exponent 1/radii**2 (the
    reference's convention). ``centers`` (N, 3) in Bohr; any argument may be
    a tensor that autograd follows."""
    c = _coords(mol, coords, resolve_device(device))
    extra = (_on(centers, c.device), _on(charges, c.device))
    if radii is None:
        return _assemble(mol, mol, c, c, _nuclear_prim, symmetric=True, extra=extra)
    return _assemble(mol, mol, c, c, _smeared_prim, symmetric=True,
                     extra=extra + (1.0 / _on(radii, c.device) ** 2,))


def dipole_integrals(mol: Molecule, coords=None, device="cuda"):
    """Dipole (position-operator) matrices about the origin, in Bohr:
    (3, nao, nao)."""
    c = _coords(mol, coords, resolve_device(device))
    return _assemble(mol, mol, c, c, _dipole_prim, symmetric=True, n_ops=3)
