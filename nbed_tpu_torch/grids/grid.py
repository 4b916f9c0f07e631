"""Grid construction and AO evaluation on grid points (port of
``nbed_tpu/grids/grid.py``, scheme ``"reference"``).

The reference scheme replicates the grid the upstream code inherits from
PySCF: per-element Treutler-Ahlrichs M4 radial maps, Lebedev angular rules,
NWChem pruning and Becke partitioning with Treutler's atomic-size
adjustment. The static layout (atom-relative points and base weights) is
host numpy; the Becke weights and AO tables are torch on the molecule's
device, in float64. The public layout is the reference's: ``ao`` is
point-major ``(G, nao)``, ``ao_grad`` is ``(3, G, nao)``.

Not ported: the ``"product"`` grid scheme (convergence studies only).
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .._device import DTYPE, resolve_device
from ..chem.molecule import Molecule, cartesian_components
from .lebedev import LEBEDEV_PARAMS, lebedev_grid

__all__ = ["MolecularGrid", "build_grid", "eval_aos"]

# Bragg-Slater radii (angstrom -> bohr at use site), H..Ar, for Becke size
# adjustment and NWChem pruning. Values from Bragg (1920) as used by
# standard DFT grids (noble gases carry the historical Slater placeholders).
_BRAGG = {
    1: 0.35, 2: 1.40, 3: 1.45, 4: 1.05, 5: 0.85, 6: 0.70, 7: 0.65, 8: 0.60,
    9: 0.50, 10: 1.50, 11: 1.80, 12: 1.50, 13: 1.25, 14: 1.10, 15: 1.00,
    16: 1.00, 17: 1.00, 18: 1.88,
}
_ANGSTROM_TO_BOHR = 1.0 / 0.52917721092


def _bragg_bohr(z: int) -> float:
    return _BRAGG.get(int(z), 1.5) * _ANGSTROM_TO_BOHR


def _radial_treutler(n: int):
    """Treutler-Ahlrichs M4 radial map on Chebyshev-2 abscissas.

    r_i = -(1/ln2) (1+x)^0.6 ln((1-x)/2),  x = cos(i pi/(n+1)), i=1..n,
    returned in ascending r with weights w_i = 4 pi r_i^2 dr_i (dr folds the
    Chebyshev quadrature step).  Matches the radial scheme behind the
    reference's PySCF grids (no per-element xi; atomic size enters through
    the Becke radii adjustment instead).
    """
    step = np.pi / (n + 1)
    ln2 = np.log(2.0)
    i = np.arange(1, n + 1)
    x = np.cos(i * step)
    r = -(1.0 / ln2) * (1.0 + x) ** 0.6 * np.log((1.0 - x) / 2.0)
    dr = (
        step * np.sin(i * step) * (1.0 / ln2) * (1.0 + x) ** 0.6
        * (-0.6 / (1.0 + x) * np.log((1.0 - x) / 2.0) + 1.0 / (1.0 - x))
    )
    w = 4.0 * np.pi * r**2 * dr
    return r[::-1], w[::-1]


# ------------------------------------------------ per-element defaults

_PERIOD_BOUNDS = (2, 10, 18, 36, 54, 86)

#   period:      1    2    3    4    5    6    7     (by grid level 0..9)
_RAD_TABLE = (
    (10, 15, 20, 30, 35, 40, 50),
    (30, 40, 50, 60, 65, 70, 75),
    (40, 60, 65, 75, 80, 85, 90),
    (50, 75, 80, 90, 95, 100, 105),
    (60, 90, 95, 105, 110, 115, 120),
    (70, 105, 110, 120, 125, 130, 135),
    (80, 120, 125, 135, 140, 145, 150),
    (90, 135, 140, 150, 155, 160, 165),
    (100, 150, 155, 165, 170, 175, 180),
    (200, 200, 200, 200, 200, 200, 200),
)
_ANG_DEGREE_TABLE = (
    (11, 15, 17, 17, 17, 17, 17),
    (17, 23, 23, 23, 23, 23, 23),
    (23, 29, 29, 29, 29, 29, 29),
    (29, 29, 35, 35, 35, 35, 35),
    (35, 41, 41, 41, 41, 41, 41),
    (41, 47, 47, 47, 47, 47, 47),
    (47, 53, 53, 53, 53, 53, 53),
    (53, 59, 59, 59, 59, 59, 59),
    (59, 59, 59, 59, 59, 59, 59),
    (65, 65, 65, 65, 65, 65, 65),
)
_DEGREE_TO_N = {3: 6, 5: 14, 7: 26, 9: 38, 11: 50, 13: 74, 15: 86, 17: 110,
                19: 146, 21: 170, 23: 194, 25: 230, 27: 266, 29: 302,
                31: 350, 35: 434, 41: 590}
# rule sequence used by the NWChem prune index arithmetic
_NWCHEM_SEQ = (38, 50, 74, 86, 110, 146, 170, 194, 230, 266, 302, 350, 434,
               590)


def _period(z: int) -> int:
    return sum(z > b for b in _PERIOD_BOUNDS)  # 0-based


def _default_rad_ang(z: int, level: int):
    period = min(_period(z), 6)
    n_rad = _RAD_TABLE[level][period]
    degree = _ANG_DEGREE_TABLE[level][period]
    # clamp to the largest solved Lebedev table
    avail = {d for d, n in _DEGREE_TO_N.items() if _has_rule(n)}
    degree = max(d for d in avail if d <= degree) if degree not in avail else degree
    return n_rad, _DEGREE_TO_N[degree]


def _has_rule(n: int) -> bool:
    return n in LEBEDEV_PARAMS


def _nwchem_prune(z: int, rads: np.ndarray, n_ang: int) -> np.ndarray:
    """Per-radial-point angular rule size (NWChem scheme)."""
    alphas = (
        (0.25, 0.5, 1.0, 4.5),
        (0.1667, 0.5, 0.9, 3.5),
        (0.1, 0.4, 0.8, 2.5),
    )[0 if z <= 2 else (1 if z <= 10 else 2)]
    if n_ang < 50:
        return np.full(len(rads), n_ang, dtype=int)
    if n_ang == 50:
        leb_l = np.array([1, 2, 2, 2, 1])
    else:
        idx = _NWCHEM_SEQ.index(n_ang)
        leb_l = np.array([1, 3, idx - 1, idx, idx])
    place = (rads[:, None] / _bragg_bohr(z) > np.asarray(alphas)[None, :]).sum(axis=1)
    angs = np.asarray(_NWCHEM_SEQ)[leb_l[place]]
    # fall back to the largest solved rule if an order is unavailable
    avail = sorted(n for n in _NWCHEM_SEQ if _has_rule(n))
    return np.array([n if _has_rule(n) else avail[-1] for n in angs])


@dataclass(eq=False)
class MolecularGrid:
    """Static grid metadata; ``points``/``weights`` from :func:`build_grid`."""

    rel_points: np.ndarray  # (G, 3) atom-relative points
    base_weights: np.ndarray  # (G,) radial*angular weights (no partition)
    atom_of_point: np.ndarray  # (G,) owning atom index
    size: int


@lru_cache(maxsize=32)
def _grid_meta_reference(mol: Molecule, level: int) -> MolecularGrid:
    rel, w, owner = [], [], []
    for ia, z in enumerate(mol.atom_charges):
        n_rad, n_ang = _default_rad_ang(int(z), level)
        r, wr = _radial_treutler(n_rad)
        angs = _nwchem_prune(int(z), r, n_ang)
        for i in range(n_rad):
            leb_pts, leb_w = lebedev_grid(int(angs[i]))
            rel.append(r[i] * leb_pts)
            w.append(wr[i] * leb_w)
            owner.append(np.full(len(leb_w), ia))
    rel = np.concatenate(rel)
    return MolecularGrid(
        rel_points=rel,
        base_weights=np.concatenate(w),
        atom_of_point=np.concatenate(owner),
        size=len(rel),
    )


def _becke_weights(points, owner, coords, bragg_radii, chunk=32768):
    """Becke fuzzy-cell partition weights (k=3 smoothing) with Treutler's
    atomic-size adjustment a_ij = (chi_ji - chi_ij)/4,
    chi_ij = sqrt(R_i/R_j) clipped to +-1/2. Evaluated in chunks of
    ``chunk`` points to bound the (g, natm, natm) intermediate."""
    natm = coords.shape[0]
    eye = torch.eye(natm, dtype=coords.dtype, device=coords.device)
    dvec = coords[:, None, :] - coords[None, :, :]
    rij = torch.sqrt(torch.sum(dvec * dvec, dim=-1) + eye)
    rad = torch.sqrt(bragg_radii)
    chi = rad[:, None] / rad[None, :]
    a = torch.clamp(0.25 * (1.0 / chi - chi), -0.5, 0.5)
    diag = eye.bool()[None, :, :]

    def wpart(pts, own):
        d = torch.linalg.norm(pts[:, None, :] - coords[None, :, :], dim=-1)
        mu = (d[:, :, None] - d[:, None, :]) / rij[None, :, :]
        mu = mu + a[None, :, :] * (1.0 - mu * mu)
        f = mu
        for _ in range(3):
            f = 0.5 * f * (3.0 - f * f)
        s = 0.5 * (1.0 - f)
        s = torch.where(diag, torch.ones_like(s), s)
        p = torch.prod(s, dim=2)  # (g, natm)
        idx = torch.arange(pts.shape[0], device=pts.device)
        return p[idx, own] / torch.sum(p, dim=1)

    return torch.cat([wpart(points[i:i + chunk], owner[i:i + chunk])
                      for i in range(0, points.shape[0], chunk)])


def build_grid(mol: Molecule, device="cuda", level: int = 3):
    """(points (G, 3), weights (G,)) for XC quadrature on ``device``."""
    device = resolve_device(device)
    meta = _grid_meta_reference(mol, level)
    c = torch.as_tensor(mol.coords, dtype=DTYPE, device=device)
    owner = torch.as_tensor(meta.atom_of_point, device=device)
    points = torch.as_tensor(meta.rel_points, dtype=DTYPE, device=device) + c[owner]
    bragg = torch.tensor([_bragg_bohr(int(z)) for z in mol.atom_charges],
                         dtype=DTYPE, device=device)
    becke = _becke_weights(points, owner, c, bragg)
    base = torch.as_tensor(meta.base_weights, dtype=DTYPE, device=device)
    return points, base * becke


def eval_aos(mol: Molecule, points):
    """AO values and gradients on grid points.

    Returns:
        ao: (G, nao); ao_grad: (3, G, nao).
    """
    c = torch.as_tensor(mol.coords, dtype=points.dtype, device=points.device)
    vals, grads = [], []  # per shell: (nsph, G) and (3, nsph, G)
    for sh in mol.shells:
        rel = (points - c[sh.atom][None, :]).T  # (3, G)
        x, y, z = rel[0], rel[1], rel[2]
        r2 = x * x + y * y + z * z
        exps = torch.tensor(sh.exps, dtype=points.dtype, device=points.device)
        coefs = torch.tensor(sh.coeffs, dtype=points.dtype, device=points.device)
        gauss = coefs[:, None] * torch.exp(-exps[:, None] * r2[None, :])  # (K, G)
        rad = torch.sum(gauss, dim=0)
        drad = torch.sum(-2.0 * exps[:, None] * gauss, dim=0)
        mono, dmono = [], []
        zero = torch.zeros_like(x)
        for (i, j, k) in cartesian_components(sh.l):
            xm = x ** i * y ** j * z ** k
            mono.append(xm)
            gx = i * x ** max(i - 1, 0) * y ** j * z ** k if i > 0 else zero
            gy = j * x ** i * y ** max(j - 1, 0) * z ** k if j > 0 else zero
            gz = k * x ** i * y ** j * z ** max(k - 1, 0) if k > 0 else zero
            dmono.append(torch.stack([gx, gy, gz]))
        mono = torch.stack(mono, dim=0)  # (ncart, G)
        dmono = torch.stack(dmono, dim=1)  # (3, ncart, G)
        cart_val = mono * rad[None, :]
        # d/dx [mono * rad(r2)] = dmono*rad + mono * drad * x
        cart_grad = (dmono * rad[None, None, :]
                     + mono[None, :, :] * drad[None, None, :] * rel[:, None, :])
        c2s_t = torch.as_tensor(sh.cart2sph.T, dtype=points.dtype,
                                device=points.device)  # (nsph, ncart)
        vals.append(c2s_t @ cart_val)
        grads.append(torch.einsum("sc,dcg->dsg", c2s_t, cart_grad))
    ao_t = torch.cat(vals, dim=0)  # (nao, G)
    grad_t = torch.cat(grads, dim=1)  # (3, nao, G)
    return ao_t.T.contiguous(), grad_t.transpose(1, 2).contiguous()
