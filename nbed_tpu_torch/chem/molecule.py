"""Molecule and shell-table construction (host-side, static metadata).

Port of ``nbed_tpu/chem/molecule.py``: the shell tables and AO metadata are
numpy, as in the reference, since they only fix shapes and feed the host
integral engine. ``energy_nuc``, the one method the reference computes in
JAX, is computed in torch here.
"""

from dataclasses import dataclass, field, replace

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


def _solid_harmonic_table(l: int) -> np.ndarray:
    """Real solid harmonics in terms of unnormalised cartesian monomials.

    Returns ``(ncart, nsph)`` with sph columns ordered m = -l..l
    (s; p: m=-1,0,1 -> y,z,x; d: xy, yz, z2, xz, x2-y2). Column scale is
    arbitrary — each AO column is renormalised numerically in
    :func:`_normalise_shell`. The port's basis sets stop at d shells; the
    reference's generic-l fit comes with the cc-pVDZ tables.
    """
    cart = cartesian_components(l)
    idx = {c: i for i, c in enumerate(cart)}
    if l > 2:
        raise NotImplementedError(
            f"l={l} shells are not ported yet (ROADMAP queue 1 item 14: basis tables)")
    if l == 0:
        cols = [{(0, 0, 0): 1.0}]
    elif l == 1:
        # m = -1, 0, +1  ->  y, z, x
        cols = [{(0, 1, 0): 1.0}, {(0, 0, 1): 1.0}, {(1, 0, 0): 1.0}]
    else:
        s3 = np.sqrt(3.0)
        cols = [
            {(1, 1, 0): s3},                                     # xy
            {(0, 1, 1): s3},                                     # yz
            {(0, 0, 2): 1.0, (2, 0, 0): -0.5, (0, 2, 0): -0.5},  # 3z^2-r^2
            {(1, 0, 1): s3},                                     # xz
            {(2, 0, 0): s3 / 2, (0, 2, 0): -s3 / 2},
        ]
    out = np.zeros((len(cart), len(cols)))
    for m, col in enumerate(cols):
        for powers, coeff in col.items():
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
        """Nuclear repulsion energy."""
        r = torch.as_tensor(self.coords if coords is None else coords, dtype=DTYPE)
        z = torch.tensor(self.atom_charges, dtype=DTYPE)
        eye = torch.eye(self.natm, dtype=DTYPE)
        diff = r[:, None, :] - r[None, :, :]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + eye)
        pair = z[:, None] * z[None, :] / dist
        return float(0.5 * torch.sum(pair * (1.0 - eye)))


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
) -> Molecule:
    """Build a :class:`Molecule` from an XYZ string (reference driver.py:87-104)."""
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
    return Molecule(
        symbols=symbols,
        atom_charges=tuple(float(SYMBOL_TO_Z[s]) for s in symbols),
        coords=coords,
        basis=basis,
        shells=tuple(shells),
        charge=charge,
        spin=spin,
    )
