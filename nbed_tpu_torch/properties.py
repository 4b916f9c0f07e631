"""Molecular properties of SCF solutions: dipole moments, population
analysis and cube files (port of ``nbed_tpu/properties.py``).

Every function takes an :class:`~nbed_tpu_torch.scf.engine.SCFSolution`,
global or embedded (for an embedded solution the density is the active
subsystem's). The integrals and lattice AO values are computed on the
solution's device; the per-atom sums and the cube text are host numpy.
"""

import numpy as np
import torch

from ._device import DTYPE, to_host
from .grids.grid import eval_aos
from .integrals.core import dipole_integrals

__all__ = ["dipole_moment", "mulliken_populations", "lowdin_populations",
           "mulliken_charges", "lowdin_charges", "atomic_spin_densities",
           "cube_grid", "mo_cube", "density_cube"]

DEBYE_PER_AU = 2.541746473


def _total_dm(scf_sol):
    dm = scf_sol.make_rdm1()  # a restricted solution's is the total already
    return dm if scf_sol.restricted else dm[0] + dm[1]


def _spin_dm(scf_sol):
    dm = scf_sol.make_rdm1()  # a restricted solution is closed-shell
    return torch.zeros_like(dm) if scf_sol.restricted else dm[0] - dm[1]


def _s_half(s):
    w, v = torch.linalg.eigh(s)
    return (v * torch.sqrt(torch.clamp(w, min=0.0))) @ v.T


def dipole_moment(scf_sol, origin=(0.0, 0.0, 0.0), unit: str = "debye"):
    """Total (nuclear + electronic) dipole moment, shape (3,).

    ``origin`` is in Bohr. A neutral system's dipole does not depend on
    it; an ion's shifts by ``q * origin``. ``unit`` is ``"debye"`` or
    ``"au"``.
    """
    mol = scf_sol.mol
    dm = _total_dm(scf_sol)
    r_ints = dipole_integrals(mol, device=scf_sol.engine.device)  # <mu| r |nu> about 0
    d_el = -to_host(torch.einsum("xij,ij->x", r_ints, dm))
    z = np.asarray(mol.atom_charges, dtype=float)
    d_nuc = z @ np.asarray(mol.coords)
    # the electron count tr(D S) and the nuclear charge fix the origin shift
    n_el = float(torch.einsum("ij,ji->", dm, scf_sol.engine.s))
    d = d_nuc + d_el - (z.sum() - n_el) * np.asarray(origin, dtype=float)
    return d * DEBYE_PER_AU if unit.lower() == "debye" else d


def _per_atom(mol, ao_values):
    """Sum an (nao,) host vector into per-atom buckets."""
    slices = mol.aoslice_by_atom()
    return np.array([ao_values[slices[ia, 2]: slices[ia, 3]].sum()
                     for ia in range(mol.natm)])


def mulliken_populations(scf_sol):
    """Mulliken gross populations per atom: diagonal blocks of D S."""
    ds = torch.einsum("ij,ji->i", _total_dm(scf_sol), scf_sol.engine.s)
    return _per_atom(scf_sol.mol, to_host(ds))


def lowdin_populations(scf_sol):
    """Löwdin populations per atom: diagonal of S^1/2 D S^1/2."""
    s_half = _s_half(scf_sol.engine.s)
    p = torch.einsum("ij,jk,ki->i", s_half, _total_dm(scf_sol), s_half)
    return _per_atom(scf_sol.mol, to_host(p))


def mulliken_charges(scf_sol):
    """Mulliken atomic charges Z_A - pop_A."""
    return np.asarray(scf_sol.mol.atom_charges, float) - mulliken_populations(scf_sol)


def lowdin_charges(scf_sol):
    """Löwdin atomic charges Z_A - pop_A."""
    return np.asarray(scf_sol.mol.atom_charges, float) - lowdin_populations(scf_sol)


def atomic_spin_densities(scf_sol, scheme: str = "mulliken"):
    """Per-atom spin density <n_alpha - n_beta> (Mulliken or Löwdin)."""
    s = scf_sol.engine.s
    dm_spin = _spin_dm(scf_sol)
    if scheme == "mulliken":
        vals = torch.einsum("ij,ji->i", dm_spin, s)
    elif scheme == "lowdin":
        s_half = _s_half(s)
        vals = torch.einsum("ij,jk,ki->i", s_half, dm_spin, s_half)
    else:
        raise ValueError(f"Unknown scheme '{scheme}' (mulliken|lowdin).")
    return _per_atom(scf_sol.mol, to_host(vals))


def cube_grid(mol, margin: float = 4.0, spacing: float = 0.25):
    """Regular lattice enclosing the molecule (Bohr).

    Returns ``(origin, axes, shape, points)``: ``axes`` the 3x3 diagonal
    step matrix and ``points`` the (nx*ny*nz, 3) host array in
    Gaussian-cube order (z fastest).
    """
    coords = np.asarray(mol.coords, float)
    lo = coords.min(axis=0) - margin
    hi = coords.max(axis=0) + margin
    shape = np.maximum(np.ceil((hi - lo) / spacing).astype(int) + 1, 2)
    axes = np.diag([spacing] * 3)
    grids = [lo[d] + spacing * np.arange(shape[d]) for d in range(3)]
    mesh = np.meshgrid(*grids, indexing="ij")
    points = np.stack([m.ravel() for m in mesh], axis=1)
    return lo, axes, tuple(int(n) for n in shape), points


def _eval_field(mol, points, field_of_ao, device, chunk: int = 20000):
    """``field_of_ao(ao_values)`` over the lattice in chunks of points on
    ``device``, so memory stays O(chunk * nao) at any resolution."""
    out = []
    for start in range(0, len(points), chunk):
        pts = torch.as_tensor(points[start:start + chunk], dtype=DTYPE, device=device)
        ao, _ = eval_aos(mol, pts)
        out.append(to_host(field_of_ao(ao)))
    return np.concatenate(out)


def _write_cube(path, mol, origin, axes, shape, values, comment):
    lines = [comment, "generated by nbed_tpu_torch.properties"]
    lines.append(f"{mol.natm:5d} {origin[0]:11.6f} {origin[1]:11.6f} {origin[2]:11.6f}")
    for d in range(3):
        a = axes[d]
        lines.append(f"{shape[d]:5d} {a[0]:11.6f} {a[1]:11.6f} {a[2]:11.6f}")
    for z, xyz in zip(mol.atom_charges, np.asarray(mol.coords, float)):
        lines.append(f"{int(z):5d} {float(z):11.6f} {xyz[0]:11.6f} "
                     f"{xyz[1]:11.6f} {xyz[2]:11.6f}")
    vals = values.reshape(shape)
    for i in range(shape[0]):
        for j in range(shape[1]):
            row = vals[i, j]
            for start in range(0, shape[2], 6):
                lines.append(" ".join(f"{v:12.5e}" for v in row[start:start + 6]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def mo_cube(scf_sol, index: int, path, spin: int = 0, margin: float = 4.0,
            spacing: float = 0.25):
    """Write molecular orbital ``index`` of spin ``spin`` as a Gaussian cube
    file (a restricted solution's one set for either spin); returns the
    lattice values, shaped."""
    mol = scf_sol.mol
    orb = scf_sol.per_spin()[0][spin][:, index]
    origin, axes, shape, points = cube_grid(mol, margin, spacing)
    vals = _eval_field(mol, points, lambda ao: ao @ orb, scf_sol.engine.device)
    _write_cube(path, mol, origin, axes, shape, vals, f"MO {index} (spin {spin})")
    return vals.reshape(shape)


def density_cube(scf_sol, path, spin: bool = False, margin: float = 4.0,
                 spacing: float = 0.25):
    """Write the electron density (or the spin density) as a cube file;
    returns the lattice values, shaped."""
    mol = scf_sol.mol
    dm = _spin_dm(scf_sol) if spin else _total_dm(scf_sol)
    origin, axes, shape, points = cube_grid(mol, margin, spacing)
    vals = _eval_field(mol, points, lambda ao: torch.einsum("gi,ij,gj->g", ao, dm, ao),
                       scf_sol.engine.device)
    _write_cube(path, mol, origin, axes, shape, vals,
                "spin density" if spin else "electron density")
    return vals.reshape(shape)
