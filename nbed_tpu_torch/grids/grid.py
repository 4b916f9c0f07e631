"""Grid construction and AO evaluation on grid points (port of
``nbed_tpu/grids/grid.py``).

Two quadrature schemes, as in the reference. ``scheme="reference"`` (the
default) replicates the grid the upstream code inherits from PySCF:
per-element Treutler-Ahlrichs M4 radial maps, Lebedev angular rules, NWChem
pruning and Becke partitioning with Treutler's atomic-size adjustment.
``scheme="product"`` is a Mura-Knowles x Gauss-Legendre product grid with
Becke's own size adjustment, for convergence studies at any degree.

The static layout (atom-relative points and base weights) is host numpy;
the points, Becke weights and AO tables are torch on the device, in
float64, and pure functions of the coordinates: given ``coords`` as a
tensor, autograd follows the grid's response to the nuclei (the KS
gradients' grid response, ``solvers/gradients.py``). The public layout is
the reference's: ``ao`` is point-major ``(G, nao)``, ``ao_grad`` is
``(3, G, nao)``.
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch.autograd import forward_ad

from .._device import DTYPE, resolve_device
from ..chem.molecule import Molecule, cartesian_components
from .lebedev import LEBEDEV_PARAMS, lebedev_grid

__all__ = ["MolecularGrid", "ao_views", "build_grid", "eval_aos", "grid_constants", "grid_points",
           "tables_program"]

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


def _radial_mura_knowles(n: int, alpha: float = 5.0):
    """Mura-Knowles Log3 radial grid: r = -alpha ln(1 - x^3), with weights
    r^2 dr/dx / n."""
    i = np.arange(n)
    x = (i + 0.5) / n
    r = -alpha * np.log(1.0 - x**3)
    w = (alpha * 3.0 * x**2 / (1.0 - x**3)) / n * r**2
    return r, w


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


def _angular_product(n_theta: int):
    """Gauss-Legendre in cos(theta) x uniform azimuth (2 n_theta angles)."""
    xt, wt = np.polynomial.legendre.leggauss(n_theta)
    n_phi = 2 * n_theta
    phi = 2.0 * np.pi * np.arange(n_phi) / n_phi
    wp = 2.0 * np.pi / n_phi
    ct = xt[:, None]
    st = np.sqrt(1.0 - ct**2)
    x = (st * np.cos(phi)[None, :]).ravel()
    y = (st * np.sin(phi)[None, :]).ravel()
    z = np.broadcast_to(ct, (n_theta, n_phi)).ravel()
    w = np.broadcast_to(wt[:, None] * wp, (n_theta, n_phi)).ravel()
    return np.stack([x, y, z], axis=1), w


@dataclass(eq=False)
class MolecularGrid:
    """Static grid metadata; ``points``/``weights`` from :func:`build_grid`."""

    rel_points: np.ndarray  # (G, 3) atom-relative points
    base_weights: np.ndarray  # (G,) radial*angular weights (no partition)
    atom_of_point: np.ndarray  # (G,) owning atom index
    size: int


@lru_cache(maxsize=32)
def _grid_meta_product(mol: Molecule, n_rad: int, n_theta: int) -> MolecularGrid:
    ang_pts, ang_w = _angular_product(n_theta)
    rel, w, owner = [], [], []
    for ia, z in enumerate(mol.atom_charges):
        alpha = 5.0 if z > 1 else 3.2  # tighter shells for H
        r, wr = _radial_mura_knowles(n_rad, alpha)
        rel.append((r[:, None, None] * ang_pts[None, :, :]).reshape(-1, 3))
        w.append((wr[:, None] * ang_w[None, :]).reshape(-1))
        owner.append(np.full(n_rad * len(ang_w), ia))
    rel = np.concatenate(rel)
    return MolecularGrid(
        rel_points=rel,
        base_weights=np.concatenate(w),
        atom_of_point=np.concatenate(owner),
        size=len(rel),
    )


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


def _becke_weights(points, owner, coords, bragg_radii, chunk=32768, adjust="treutler"):
    """Becke fuzzy-cell partition weights (k=3 smoothing). Becke, JCP 88,
    2547 (1988). ``adjust="treutler"``: Treutler's atomic-size adjustment
    a_ij = (chi_ji - chi_ij)/4, chi_ij = sqrt(R_i/R_j), clipped to +-1/2;
    ``adjust="becke"``: Becke's appendix formula on the plain radius ratio.
    Evaluated in chunks of ``chunk`` points to bound the (g, natm, natm)
    intermediate.

    The clips act on the radii alone, so no coordinate gradient passes
    them; the diagonal guard sits inside the square root of the
    interatomic distances (sqrt(0) has an infinite derivative), which keeps
    the weights differentiable in ``coords``."""
    natm = coords.shape[0]
    eye = torch.eye(natm, dtype=coords.dtype, device=coords.device)
    dvec = coords[:, None, :] - coords[None, :, :]
    rij = torch.sqrt(torch.sum(dvec * dvec, dim=-1) + eye)
    if adjust == "treutler":
        rad = torch.sqrt(bragg_radii)
        chi = rad[:, None] / rad[None, :]
        a = torch.clamp(0.25 * (1.0 / chi - chi), -0.5, 0.5)
    else:
        chi = bragg_radii[:, None] / bragg_radii[None, :]
        u = (chi - 1.0) / (chi + 1.0)
        a = torch.clamp(u / (u * u - 1.0), -0.5, 0.5)
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
        if s.requires_grad or forward_ad.unpack_dual(s).tangent is not None:
            # torch.prod's backward (and its forward-mode rule, which calls
            # it) reads whether a factor is zero on the host, which a CUDA
            # graph cannot capture: multiply out instead
            p = s[:, :, 0]
            for k in range(1, natm):
                p = p * s[:, :, k]
        else:
            p = torch.prod(s, dim=2)  # (g, natm)
        return torch.gather(p, 1, own[:, None])[:, 0] / torch.sum(p, dim=1)

    return torch.cat([wpart(points[i:i + chunk], owner[i:i + chunk])
                      for i in range(0, points.shape[0], chunk)])


def grid_constants(mol: Molecule, n_rad: int = 80, n_theta: int = 18,
                   scheme: str = "reference", level: int = 3, device="cuda") -> dict:
    """The structure's constants of :func:`build_grid` as tensors on
    ``device``: atom-relative points "rel" (G, 3), owning atoms "owner"
    (G,), base weights "base" (G,), Bragg radii "bragg" (natm,), and the
    Becke size adjustment "adjust" of the scheme. Made once per structure,
    they let :func:`grid_points` copy nothing from the host (a CUDA graph
    captures it)."""
    if scheme == "reference":
        meta = _grid_meta_reference(mol, level)
        adjust = "treutler"
    elif scheme == "product":
        meta = _grid_meta_product(mol, n_rad, n_theta)
        adjust = "becke"
    else:
        raise ValueError(f"Unknown grid scheme '{scheme}'")
    device = resolve_device(device)
    return {
        "rel": torch.as_tensor(meta.rel_points, dtype=DTYPE, device=device),
        "owner": torch.as_tensor(meta.atom_of_point, device=device),
        "base": torch.as_tensor(meta.base_weights, dtype=DTYPE, device=device),
        "bragg": torch.tensor([_bragg_bohr(int(z)) for z in mol.atom_charges],
                              dtype=DTYPE, device=device),
        "adjust": adjust,
    }


def grid_points(constants: dict, coords):
    """(points, weights) of the grid of :func:`grid_constants` for atoms at
    ``coords`` ((natm, 3) tensor on the constants' device): each point is
    its atom-relative offset plus its owning atom's coordinates."""
    owner = constants["owner"]
    points = constants["rel"] + coords.index_select(0, owner)
    becke = _becke_weights(points, owner, coords, constants["bragg"],
                           adjust=constants["adjust"])
    return points, constants["base"] * becke


def build_grid(mol: Molecule, coords=None, n_rad: int = 80, n_theta: int = 18,
               scheme: str = "reference", level: int = 3, device="cuda"):
    """(points (G, 3), weights (G,)) for XC quadrature on ``device``.

    A pure function of ``coords`` (Bohr; the molecule's by default): each
    point is its atom-relative offset plus its owning atom's coordinates,
    so autograd follows points and weights. ``scheme="reference"`` ignores
    ``n_rad``/``n_theta`` and takes the per-element level-``level``
    defaults; ``scheme="product"`` ignores ``level``.
    """
    c = torch.as_tensor(mol.coords if coords is None else coords, dtype=DTYPE,
                        device=resolve_device(device))
    return grid_points(grid_constants(mol, n_rad, n_theta, scheme, level, c.device), c)


def eval_aos(mol: Molecule, points, coords=None, tables=None):
    """AO values and gradients on grid points, for atoms at ``coords``
    (Bohr; the molecule's by default), differentiable in both.
    ``tables`` are the molecule's :func:`shell_tables` in the points' dtype
    and device, made once by a caller that evaluates many chunks (a
    streaming XC closure, whose CUDA-graph capture takes no host-to-device
    copy); by default they are made here.

    Returns:
        ao: (G, nao); ao_grad: (3, G, nao).
    """
    c = torch.as_tensor(mol.coords if coords is None else coords, dtype=points.dtype,
                        device=points.device)
    if tables is None:
        tables = shell_tables(mol, points.dtype, points.device)
    ao, grad = ao_views(mol, points, c, tables)
    return ao.contiguous(), grad.contiguous()


def ao_views(mol: Molecule, points, coords, tables):
    """:func:`eval_aos` on tensors alone (``coords`` (natm, 3) and the
    :func:`shell_tables` on the points' device), returning the (G, nao) and
    (3, G, nao) tables as transposed views of AO-major tensors: a caller
    that copies them into buffers (a CUDA graph) skips the contiguous
    copy."""
    vals, grads = [], []  # per shell: (nsph, G) and (3, nsph, G)
    for sh, (exps, coefs, c2s_t) in zip(mol.shells, tables):
        rel = (points - coords[sh.atom][None, :]).T  # (3, G)
        x, y, z = rel[0], rel[1], rel[2]
        r2 = x * x + y * y + z * z
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
        vals.append(c2s_t @ cart_val)
        grads.append(torch.einsum("sc,dcg->dsg", c2s_t, cart_grad))
    ao_t = torch.cat(vals, dim=0)  # (nao, G)
    grad_t = torch.cat(grads, dim=1)  # (3, nao, G)
    return ao_t.T, grad_t.transpose(1, 2)


def tables_program(mol: Molecule, coords, level: int = 3, scheme: str = "reference",
                   n_rad: int = 80, n_theta: int = 18, jit_kernel: str = "auto") -> dict:
    """The grid and AO tables at ``coords`` ((natm, 3) or (B, natm, 3)
    tensor), lane by lane: {"points" ([B,] G, 3), "w" ([B,] G), "ao" ([B,]
    G, nao), "ao_grad" ([B,] 3, G, nao)}. Where the coordinates carry a
    forward-mode tangent and ``jit_kernel`` takes a program ("on", or
    "auto" on a card), all four with their tangents from the derivative
    program of kind "grid_jvp", the tangent variant of the engine's "grid"
    and "aos" tables (points, Becke weights, AO values and gradients): one
    CUDA graph per (structure, grid, shape, card) over the structure's
    :func:`grid_constants` and :func:`shell_tables`, made once (dual
    tensors the caller owns); else :func:`build_grid` and
    :func:`eval_aos` on ``coords``' device."""
    from ..ops.programs import (TangentProgram, derivative_program, has_tangent, structure_key,
                                takes_program)

    def tables(x, constants, shells):
        lanes = x if x.ndim == 3 else x[None]
        parts = []
        for xb in lanes:
            points, w = grid_points(constants, xb)
            ao, ao_grad = ao_views(mol, points, xb, shells)
            parts.append((points, w, ao.contiguous(), ao_grad.contiguous()))
        out = {name: torch.stack([p[i] for p in parts])
               for i, name in enumerate(("points", "w", "ao", "ao_grad"))}
        return out if x.ndim == 3 else {name: t[0] for name, t in out.items()}

    dev = coords.device
    if not (has_tangent(coords) and takes_program(jit_kernel, (coords,), tangent=True)):
        return tables(coords, grid_constants(mol, n_rad, n_theta, scheme, level, dev),
                      shell_tables(mol, DTYPE, dev))
    shape = tuple(coords.shape)

    def build(device, pool):
        constants = grid_constants(mol, n_rad, n_theta, scheme, level, device)
        shells = shell_tables(mol, DTYPE, device)
        return TangentProgram("grid_jvp", {"x": torch.zeros(shape, dtype=DTYPE, device=device)},
                              lambda x: tables(x, constants, shells), device, pool,
                              holds=(constants, shells))

    key = ("grid_jvp", structure_key(mol), shape, scheme, int(level), int(n_rad), int(n_theta))
    out = derivative_program(key, dev, build)(x=coords)
    return {name: t.clone() for name, t in out.items()}


def shell_tables(mol: Molecule, dtype, device) -> list:
    """Per shell of ``mol``: (exponents, contraction coefficients, the
    (nsph, ncart) spherical transform) as tensors of ``dtype`` on
    ``device``, the constants of :func:`eval_aos`."""
    return [(torch.tensor(sh.exps, dtype=dtype, device=device),
             torch.tensor(sh.coeffs, dtype=dtype, device=device),
             torch.as_tensor(sh.cart2sph.T, dtype=dtype, device=device))
            for sh in mol.shells]
