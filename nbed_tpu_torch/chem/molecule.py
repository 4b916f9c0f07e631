"""Molecule and shell-table construction (host-side, static metadata).

Port of ``nbed_tpu/chem/molecule.py``: the shell tables and AO metadata are
numpy, as in the reference, since they only fix shapes and feed the host
integral engine. ``energy_nuc``, the one method the reference computes in
JAX, is computed in torch here.
"""

from dataclasses import dataclass, field, replace
from functools import lru_cache

import numpy as np
import torch

from .._device import DTYPE
from .basis import get_element_shells
from .periodic import ANGSTROM_TO_BOHR, SYMBOL_TO_Z

__all__ = ["Shell", "Molecule", "parse_xyz", "build_molecule"]


def _double_factorial(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def cartesian_components(l: int) -> list[tuple[int, int, int]]:
    """Cartesian monomial powers for angular momentum ``l`` (libcint order)."""
    return [
        (l - i, i - j, j)
        for i in range(l + 1)
        for j in range(i + 1)
    ]


def _poly_times(poly: dict, shift: tuple, scale: float) -> dict:
    """``scale * x^a y^b z^c * poly`` for ``shift = (a, b, c)``; a
    polynomial is a dict from monomial powers to coefficients."""
    return {tuple(p + s for p, s in zip(powers, shift)): scale * coeff
            for powers, coeff in poly.items()}


def _poly_sum(*polys: dict) -> dict:
    out: dict = {}
    for poly in polys:
        for powers, coeff in poly.items():
            out[powers] = out.get(powers, 0.0) + coeff
    return out


@lru_cache(maxsize=None)
def _solid_harmonics(l: int) -> tuple:
    """Real regular solid harmonics S_lm, m = -l..l, as polynomials, by the
    recursion of Helgaker, Jorgensen and Olsen (Molecular
    Electronic-Structure Theory, eqs. 6.4.70-6.4.73):

        S_{l+1,l+1}  = c_l (x S_ll - (1 - d_l0) y S_{l,-l})
        S_{l+1,-l-1} = c_l (y S_ll + (1 - d_l0) x S_{l,-l})
        S_{l+1,m}    = ((2l+1) z S_lm - sqrt((l+m)(l-m)) r^2 S_{l-1,m})
                       / sqrt((l+m+1)(l-m+1)),   |m| <= l

    with c_l = sqrt(2^d_l0 (2l+1) / (2l+2)). The coefficients are exact, so
    no fit and no special-function library is needed at any l.
    """
    if l == 0:
        return ({(0, 0, 0): 1.0},)
    k = l - 1
    prev = _solid_harmonics(k)
    prev2 = _solid_harmonics(k - 1) if k >= 1 else ()
    top, bottom = prev[2 * k], prev[0]  # S_kk, S_{k,-k}
    c = np.sqrt((2.0 if k == 0 else 1.0) * (2 * k + 1) / (2 * k + 2))
    other = 0.0 if k == 0 else 1.0
    middle = []
    for m in range(-k, k + 1):
        poly = _poly_times(prev[m + k], (0, 0, 1), 2 * k + 1.0)
        if abs(m) < k:  # S_{k-1,m} exists
            scale = -np.sqrt((k + m) * (k - m))
            poly = _poly_sum(poly, *(_poly_times(prev2[m + k - 1], sq, scale)
                                     for sq in ((2, 0, 0), (0, 2, 0), (0, 0, 2))))
        middle.append(_poly_times(poly, (0, 0, 0),
                                  1.0 / np.sqrt((k + m + 1) * (k - m + 1))))
    plus = _poly_sum(_poly_times(top, (1, 0, 0), c),
                     _poly_times(bottom, (0, 1, 0), -other * c))
    minus = _poly_sum(_poly_times(top, (0, 1, 0), c),
                      _poly_times(bottom, (1, 0, 0), other * c))
    return (minus, *middle, plus)


def _solid_harmonic_table(l: int) -> np.ndarray:
    """Real solid harmonics in terms of unnormalised cartesian monomials.

    Returns ``(ncart, nsph)`` with sph columns ordered m = -l..l
    (s; p: m=-1,0,1 -> y,z,x; d: xy, yz, 3z^2-r^2, xz, x^2-y^2), the same
    columns as ``nbed_tpu``'s tables up to l = 2. Above that the reference
    fits scipy's spherical harmonics; this table spans the same space with
    another sign and scale convention, which no fitted or contracted
    quantity sees. Column scale is arbitrary — each AO column is
    renormalised numerically in :func:`_normalise_shell`.
    """
    idx = {c: i for i, c in enumerate(cartesian_components(l))}
    polys = _solid_harmonics(l)
    out = np.zeros((len(idx), len(polys)))
    for m, poly in enumerate(polys):
        for powers, coeff in poly.items():
            out[idx[powers], m] = coeff
    return out


def _same_center_cart_overlap(powers_a, powers_b, g: float) -> float:
    """<cart_a exp(-a r^2)|cart_b exp(-b r^2)> on one center; g = a + b."""
    val = 1.0
    for pa, pb in zip(powers_a, powers_b):
        n = pa + pb
        if n % 2 == 1:
            return 0.0
        val *= np.sqrt(np.pi / g) * _double_factorial(n - 1) / (2 * g) ** (n // 2)
    return val


def _normalise_shell(l: int, exps: np.ndarray, coeffs: np.ndarray):
    """Fold primitive norms into coefficients and unit-normalise the AOs.

    Returns ``(coeffs, cart2sph)`` such that the contracted spherical AOs
    built from *unnormalised* cartesian primitives
    ``x^i y^j z^k exp(-a r^2)`` have exactly unit self-overlap.
    """
    # published coefficients refer to unit-normalised primitives:
    # N(a) for the (l,0,0) cartesian component.
    norms = np.sqrt(
        (2 * exps / np.pi) ** 1.5 * (4 * exps) ** l / _double_factorial(2 * l - 1)
    )
    c = coeffs * norms
    cart = cartesian_components(l)
    c2s = _solid_harmonic_table(l)
    # contracted same-centre cartesian overlap block, summed over primitives
    ncart = len(cart)
    block = np.zeros((ncart, ncart))
    for i, (ai, ci) in enumerate(zip(exps, c)):
        for j, (aj, cj) in enumerate(zip(exps, c)):
            for p in range(ncart):
                for q in range(ncart):
                    block[p, q] += ci * cj * _same_center_cart_overlap(
                        cart[p], cart[q], ai + aj
                    )
    ao_norm = np.sqrt(np.einsum("pm,pq,qm->m", c2s, block, c2s))
    return c, c2s / ao_norm[None, :]


@dataclass(frozen=True, eq=False)
class Shell:
    """One contracted shell: static metadata for the integral engine."""

    atom: int
    l: int
    exps: tuple
    coeffs: tuple  # primitive-normalised contraction coefficients
    ao_offset: int  # offset into the spherical AO vector
    cart2sph: np.ndarray = field(repr=False, default=None)  # (ncart, nsph), AO-normalising

    @property
    def nsph(self) -> int:
        return 2 * self.l + 1

    @property
    def ncart(self) -> int:
        return (self.l + 1) * (self.l + 2) // 2


@dataclass(frozen=True, eq=False)
class Molecule:
    """Static molecular structure + electron bookkeeping.

    ``coords`` (bohr) is stored as a plain numpy array here; integral
    routines take coordinates explicitly so they stay pure/jittable.
    """

    symbols: tuple
    atom_charges: tuple  # nuclear charges Z
    coords: np.ndarray  # (natm, 3) bohr — default geometry
    basis: str
    shells: tuple
    charge: int = 0
    spin: int = 0  # n_alpha - n_beta
    nelec_override: tuple | None = None  # embedded-subsystem electron counts
    mm_coords: np.ndarray | None = None  # (nmm, 3) bohr
    mm_charges: np.ndarray | None = None
    mm_radii: np.ndarray | None = None  # Gaussian widths, as given (not converted)

    @property
    def natm(self) -> int:
        return len(self.symbols)

    @property
    def nao(self) -> int:
        last = self.shells[-1]
        return last.ao_offset + last.nsph

    @property
    def nelectron(self) -> int:
        if self.nelec_override is not None:
            return int(sum(self.nelec_override))
        return int(sum(self.atom_charges)) - self.charge

    @property
    def nelec(self) -> tuple:
        """(n_alpha, n_beta)."""
        if self.nelec_override is not None:
            return tuple(int(x) for x in self.nelec_override)
        ne = self.nelectron
        if (ne + self.spin) % 2 != 0:
            raise ValueError(
                f"Electron number {ne} and spin {self.spin} are inconsistent."
            )
        na = (ne + self.spin) // 2
        return (na, ne - na)

    def with_nelec(self, nelec: tuple) -> "Molecule":
        """Copy with overridden electron counts (reference driver.py:262-287)."""
        return replace(self, nelec_override=(int(nelec[0]), int(nelec[1])))

    def aoslice_by_atom(self) -> np.ndarray:
        """(natm, 4): [shell_start, shell_end, ao_start, ao_end] per atom."""
        out = np.zeros((self.natm, 4), dtype=int)
        for ia in range(self.natm):
            sh = [i for i, s in enumerate(self.shells) if s.atom == ia]
            out[ia, 0] = sh[0]
            out[ia, 1] = sh[-1] + 1
            out[ia, 2] = self.shells[sh[0]].ao_offset
            out[ia, 3] = self.shells[sh[-1]].ao_offset + self.shells[sh[-1]].nsph
        return out

    def energy_nuc(self, coords=None) -> float:
        """Nuclear repulsion, plus the nuclei's interaction with the MM
        charges taken as bare point charges (radii only smear the
        electronic term, as in the reference)."""
        return float(self.energy_nuc_tensor(coords))

    def energy_nuc_tensor(self, coords=None) -> torch.Tensor:
        """:meth:`energy_nuc` as a 0-d tensor on the device of ``coords``
        (a tensor that autograd follows, or an array for the CPU); (B,
        natm, 3) coordinates give a (B,) tensor, one energy per lane. The
        charges are on the device once per molecule and device, so a call
        on a tensor copies nothing from the host."""
        r = coords if isinstance(coords, torch.Tensor) and coords.dtype == DTYPE else \
            torch.as_tensor(self.coords if coords is None else coords, dtype=DTYPE)
        z, eye, mm_coords, mm_charges = _nuclear_tables(self, r.device)
        diff = r[..., :, None, :] - r[..., None, :, :]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + eye)
        pair = z[:, None] * z[None, :] / dist
        e = 0.5 * torch.sum(pair * (1.0 - eye), dim=(-2, -1))
        if mm_coords is not None:
            d_mm = torch.linalg.norm(r[..., :, None, :] - mm_coords[None], dim=-1)
            e = e + torch.sum(z[:, None] * mm_charges[None] / d_mm, dim=(-2, -1))
        return e


@lru_cache(maxsize=64)
def _nuclear_tables(mol: Molecule, device: torch.device):
    """(charges Z, the natm identity, MM coordinates, MM charges) of
    :meth:`Molecule.energy_nuc_tensor` on ``device``."""
    def t(a):
        return None if a is None else torch.as_tensor(np.asarray(a), dtype=DTYPE, device=device)

    return (t(mol.atom_charges), torch.eye(mol.natm, dtype=DTYPE, device=device),
            t(mol.mm_coords), t(mol.mm_charges))


def parse_xyz(text: str, unit: str = "angstrom"):
    """Parse an XYZ-format string -> (symbols, coords_bohr)."""
    lines = [ln for ln in text.splitlines()]
    natm = int(lines[0].split()[0])
    atoms = []
    for ln in lines[2 : 2 + natm]:
        parts = ln.split()
        if not parts:
            continue
        atoms.append((parts[0], [float(x) for x in parts[1:4]]))
    symbols = tuple(a[0].capitalize() for a in atoms)
    coords = np.array([a[1] for a in atoms], dtype=np.float64)
    if unit.lower().startswith("a"):
        coords = coords * ANGSTROM_TO_BOHR
    return symbols, coords


def build_molecule(
    geometry: str,
    basis: str,
    charge: int = 0,
    spin: int = 0,
    unit: str = "angstrom",
    mm_coords=None,
    mm_charges=None,
    mm_radii=None,
) -> Molecule:
    """Build a :class:`Molecule` from an XYZ string (reference driver.py:87-104).

    MM charges: ``mm_coords`` are in ``unit`` like the geometry;
    ``mm_radii`` are taken as given, unconverted, as the reference does."""
    symbols, coords = parse_xyz(geometry, unit)
    shells = []
    ao_offset = 0
    for ia, sym in enumerate(symbols):
        for l, prims in get_element_shells(basis, sym):
            exps = np.array([p[0] for p in prims], dtype=np.float64)
            coeffs = np.array([p[1] for p in prims], dtype=np.float64)
            c, c2s = _normalise_shell(l, exps, coeffs)
            shells.append(
                Shell(
                    atom=ia,
                    l=l,
                    exps=tuple(exps.tolist()),
                    coeffs=tuple(c.tolist()),
                    ao_offset=ao_offset,
                    cart2sph=c2s,
                )
            )
            ao_offset += 2 * l + 1
    to_bohr = ANGSTROM_TO_BOHR if unit.lower().startswith("a") else 1.0
    return Molecule(
        symbols=symbols,
        atom_charges=tuple(float(SYMBOL_TO_Z[s]) for s in symbols),
        coords=coords,
        basis=basis,
        shells=tuple(shells),
        charge=charge,
        spin=spin,
        mm_coords=None if mm_coords is None else
        np.asarray(mm_coords, dtype=np.float64) * to_bohr,
        mm_charges=None if mm_charges is None else np.asarray(mm_charges, float),
        mm_radii=None if mm_radii is None else np.asarray(mm_radii, float),
    )
