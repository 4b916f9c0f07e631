"""SCF engine: per-molecule operator tensors and the SCF call (port of the
exact-ERI subset of ``nbed_tpu/scf/engine.py``).

:class:`SCFEngine` owns the operators of one molecule and method on one
device (S, hcore, the ERI supermatrices, grid AO tables); ``kernel`` is a
call whose embedding potentials, electron counts and Huzinaga projectors
are explicit arguments. Every J/K product goes through the fused J/K
kernel (:func:`nbed_tpu_torch.ops.jk.fused_jk`). :class:`SCFSolution` is
the result the embedding driver edits (environment deletion, virtual
localization).

Not ported: density fitting (ROADMAP queue 1 item 7), range-separated
hybrids and streaming XC (item 8), the mixed-precision modes (item 9) and
the TPU-only compiled-program machinery.
"""

import logging
from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Optional

import torch

from .._device import DTYPE, resolve_device
from ..chem.molecule import Molecule, build_molecule
from ..chem.periodic import SYMBOL_TO_Z, Z_TO_SYMBOL
from ..dft.functionals import resolve_functional
from ..dft.xc import make_xc_fn
from ..grids import build_grid, eval_aos
from ..integrals import native
from ..ops.jk import fused_jk
from .hf import make_rdm1, run_scf

logger = logging.getLogger(__name__)

__all__ = ["SCFEngine", "SCFSolution", "VeffResult"]


@dataclass
class VeffResult:
    """get_veff output with energy components."""

    matrix: torch.Tensor  # (2, n, n)
    ecoul: torch.Tensor
    exc: torch.Tensor  # functional exc incl. -0.5*hyb*tr(D K) HF part


def _spinify(dm):
    if dm.ndim == 2:
        return torch.stack([dm, dm]) * 0.5
    return dm


# Hund's-rule unpaired-electron counts for neutral atoms (SAD guess)
_ATOM_SPIN = {1: 1, 2: 0, 3: 1, 4: 0, 5: 1, 6: 2, 7: 3, 8: 2, 9: 1, 10: 0,
              11: 1, 12: 0, 13: 1, 14: 2, 15: 3, 16: 2, 17: 1, 18: 0}


@lru_cache(maxsize=64)
def _atomic_density(symbol: str, basis: str, device: str):
    """Spin-summed UHF density of the neutral atom (per-spin average), for
    the superposition-of-atomic-densities guess. The atoms' SCFs run on the
    molecule's device, their J/K through the fused kernel."""
    mol = build_molecule(f"1\n\n{symbol} 0.0 0.0 0.0", basis)
    z = SYMBOL_TO_Z[symbol.capitalize()]
    spin = _ATOM_SPIN.get(z, z % 2)
    na = (z + spin) // 2
    eng = SCFEngine(mol, conv_tol=1e-8, max_cycle=100, init_guess="hcore",
                    device=device)
    dm = eng.kernel(nelec=(na, z - na)).make_rdm1()
    return 0.5 * (dm[0] + dm[1])


@dataclass(eq=False)
class SCFEngine:
    """Operator context for one molecule + method on one device.

    Args:
        mol: molecule (static structure).
        xc: functional name, or None for Hartree-Fock.
        device: ``"cuda"`` (default) or ``"cpu"``; CUDA asked for and
          absent raises.
    """

    mol: Molecule
    xc: Optional[str] = None
    conv_tol: float = 1e-6
    dm_conv_tol: float = 1e-6
    max_cycle: int = 50
    init_guess: str = "sad"  # "sad" | "hcore"
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.init_guess not in ("sad", "hcore"):
            raise ValueError(f"init_guess must be 'sad' or 'hcore', got {self.init_guess!r}")
        self.coords = self.mol.coords

    def _tensor(self, array):
        return torch.as_tensor(array, dtype=DTYPE, device=self.device)

    # ---------------------------------------------------------- operators
    @cached_property
    def _native_1e(self):
        return native.one_electron(self.mol, self.coords)

    @cached_property
    def s(self):
        return self._tensor(self._native_1e[0])

    @cached_property
    def hcore(self):
        _, t, v = self._native_1e
        return self._tensor(t + v)

    @cached_property
    def eri(self):
        return self._tensor(native.eri(self.mol, self.coords))

    @cached_property
    def eri_j(self):
        n = self.mol.nao
        return self.eri.reshape(n * n, n * n).contiguous()

    @cached_property
    def eri_k(self):
        """Exchange supermatrix (ik|jl)."""
        n = self.mol.nao
        return self.eri.permute(0, 2, 1, 3).reshape(n * n, n * n).contiguous()

    @cached_property
    def _grid(self):
        return build_grid(self.mol, self.device)

    @cached_property
    def _xc(self):
        """(xc_fn or None, hyb)."""
        if self.xc is None:
            return None, 1.0
        _, hyb, _ = resolve_functional(self.xc)
        points, weights = self._grid
        ao, ao_grad = eval_aos(self.mol, points)
        return make_xc_fn(ao, ao_grad, weights, self.xc), hyb

    @property
    def hyb(self):
        return self._xc[1]

    @property
    def xc_fn(self):
        return self._xc[0]

    def _sad_guess(self):
        """Block-diagonal superposition of neutral-atom UHF densities."""
        n = self.mol.nao
        dm = torch.zeros((n, n), dtype=DTYPE, device=self.device)
        sl = self.mol.aoslice_by_atom()
        for ia, z in enumerate(self.mol.atom_charges):
            blk = _atomic_density(Z_TO_SYMBOL[int(z)], self.mol.basis, str(self.device))
            p0, p1 = int(sl[ia, 2]), int(sl[ia, 3])
            dm[p0:p1, p0:p1] = blk
        return torch.stack([dm, dm])

    # ------------------------------------------------------------ methods
    def energy_nuc(self) -> float:
        return self.mol.energy_nuc(self.coords)

    def get_jk(self, dm):
        """(J (n, n), K (2, n, n)) of a density, through the fused kernel."""
        dm = _spinify(dm)
        return fused_jk(self.eri_j, self.eri_k, dm.contiguous())

    def get_j(self, dm):
        return self.get_jk(dm)[0]

    @staticmethod
    def _veff_math(dm, j, k, xc_fn, hyb) -> VeffResult:
        if xc_fn is not None:
            exc, vxc = xc_fn(dm)
        else:
            exc, vxc = torch.zeros((), dtype=dm.dtype, device=dm.device), torch.zeros_like(dm)
        v = j[None] + vxc - hyb * k
        ecoul = 0.5 * torch.einsum("ij,ji->", j, dm[0] + dm[1])
        exc = exc - 0.5 * hyb * torch.einsum("sij,sji->", k, dm)
        return VeffResult(matrix=v, ecoul=ecoul, exc=exc)

    def get_veff(self, dm) -> VeffResult:
        """J + Vxc - hyb*K with pyscf-compatible energy components."""
        dm = _spinify(self._tensor(dm))
        j, k = self.get_jk(dm)
        xc_fn, hyb = self._xc
        return self._veff_math(dm, j, k, xc_fn, hyb)

    def subsystem_decomposition(self, dm_act, dm_env):
        """(e_act, e_env, two_e_cross, embedding_potential) of the driver's
        subsystem-DFT stage (``nbed_tpu/scf/engine.py:939-968``)."""
        dm_act, dm_env = _spinify(dm_act), _spinify(dm_env)
        v_act = self.get_veff(dm_act)
        v_env = self.get_veff(dm_env)
        v_tot = self.get_veff(dm_act + dm_env)
        j_act = self.get_j(dm_act)
        j_env = self.get_j(dm_env)
        h = self.hcore
        tot_act = dm_act[0] + dm_act[1]
        tot_env = dm_env[0] + dm_env[1]
        e_act = float(torch.einsum("ij,ji->", h, tot_act) + v_act.ecoul + v_act.exc)
        e_env = float(torch.einsum("ij,ji->", h, tot_env) + v_env.ecoul + v_env.exc)
        j_cross = 0.5 * float(torch.einsum("ij,ij", tot_act, j_env)
                              + torch.einsum("ij,ij", tot_env, j_act))
        xc_cross = float(v_tot.exc) - float(v_act.exc) - float(v_env.exc)
        v_emb = v_tot.matrix - v_act.matrix
        return e_act, e_env, j_cross + xc_cross, v_emb

    def kernel(self, nelec=None, v_emb=None, dm_env_occ=None, dm_env_virt=None,
               dm0=None, conv_tol=None, dm_conv_tol=None, max_cycle=None,
               level_shift=0.0) -> "SCFSolution":
        """Run SCF; all embedding terms are explicit arguments."""
        nelec = self.mol.nelec if nelec is None else nelec
        xc_fn, hyb = self._xc
        if (dm0 is None and self.init_guess == "sad"
                and tuple(nelec) == tuple(self.mol.nelec) and v_emb is None):
            # full-molecule SCF: seed from atomic densities (embedded SCFs
            # keep the reference's modified-hcore guess)
            dm0 = self._sad_guess()

        def opt(t):
            return None if t is None else _spinify(self._tensor(t))

        res = run_scf(
            hcore=self.hcore, s=self.s, jk_fn=self.get_jk, nelec=nelec,
            v_emb=None if v_emb is None else self._tensor(v_emb),
            xc_fn=xc_fn, hyb=hyb,
            dm_env_occ=opt(dm_env_occ), dm_env_virt=opt(dm_env_virt), dm0=opt(dm0),
            conv_tol=self.conv_tol if conv_tol is None else conv_tol,
            dm_conv_tol=self.dm_conv_tol if dm_conv_tol is None else dm_conv_tol,
            max_cycle=self.max_cycle if max_cycle is None else max_cycle,
            level_shift=level_shift,
        )
        if not res.converged:
            logger.warning("SCF has NOT converged (%s cycles).", res.n_iter)
        return SCFSolution(
            engine=self,
            nelec=tuple(int(x) for x in nelec),
            mo_coeff=res.mo_coeff,
            mo_energy=res.mo_energy,
            mo_occ=res.mo_occ,
            e_tot=res.e_elec + self.energy_nuc(),
            converged=res.converged,
            v_emb=None if v_emb is None else self._tensor(v_emb),
            huzinaga_op=res.huzinaga_op if dm_env_occ is not None else None,
        )


@dataclass(eq=False)
class SCFSolution:
    """Unrestricted SCF result on the engine's device. The driver edits the
    MO sets in place when it deletes environment orbitals and localizes
    virtuals."""

    engine: SCFEngine
    nelec: tuple
    mo_coeff: torch.Tensor  # (2, n, k)
    mo_energy: torch.Tensor  # (2, k)
    mo_occ: torch.Tensor  # (2, k) in electrons per spin orbital (0/1)
    e_tot: float
    converged: bool
    v_emb: Optional[torch.Tensor] = None  # (2, n, n)
    huzinaga_op: Optional[torch.Tensor] = None

    @property
    def mol(self) -> Molecule:
        return self.engine.mol

    def copy(self) -> "SCFSolution":
        def clone(t):
            return None if t is None else t.clone()

        return SCFSolution(
            engine=self.engine, nelec=self.nelec,
            mo_coeff=self.mo_coeff.clone(), mo_energy=self.mo_energy.clone(),
            mo_occ=self.mo_occ.clone(), e_tot=self.e_tot,
            converged=self.converged, v_emb=clone(self.v_emb),
            huzinaga_op=clone(self.huzinaga_op),
        )

    def get_hcore(self):
        """Core Hamiltonian including the embedding potential, (n, n) or
        (2, n, n)."""
        h = self.engine.hcore
        if self.v_emb is None:
            return h
        return h[None] + self.v_emb

    def make_rdm1(self):
        return make_rdm1(self.mo_coeff, self.mo_occ)

    def get_fock(self):
        """(2, n, n) Fock matrix (incl. v_emb and the Huzinaga term) at the
        current density."""
        veff = self.engine.get_veff(self.make_rdm1())
        h = self.get_hcore()
        if h.ndim == 2:
            h = h[None]
        f = h + veff.matrix
        if self.huzinaga_op is not None:
            f = f + self.huzinaga_op
        return f

    def energy_nuc(self) -> float:
        return self.engine.energy_nuc()

    def energy_elec(self, dm=None):
        """(e_elec, e_2) at the given (default: current) density, with v_emb
        folded into the one-body term; e_2 is the Coulomb+exchange energy for
        HF and ecoul + exc for KS, as PySCF reports them."""
        dm = self.make_rdm1() if dm is None else _spinify(self.engine._tensor(dm))
        veff = self.engine.get_veff(dm)
        h = self.get_hcore()
        if h.ndim == 2:
            h = h[None]
        e1 = float(torch.einsum("sij,sji->", h.expand_as(dm), dm))
        if self.engine.xc_fn is None:
            j, k = self.engine.get_jk(dm)
            e_coul = 0.5 * float(torch.einsum("ij,ji->", j, dm[0] + dm[1])
                                 - torch.einsum("sij,sji->", k, dm))
            return e1 + e_coul, e_coul
        e2 = float(veff.ecoul + veff.exc)
        return e1 + e2, e2

    def spin_square(self):
        """(<S^2>, 2S+1) of the unrestricted determinant:
        <S^2> = S_z(S_z+1) + N_beta - sum_ij |<phi_i^a|phi_j^b>|^2 over
        occupied orbitals."""
        ca = self.mo_coeff[0][:, self.mo_occ[0] > 0.5]
        cb = self.mo_coeff[1][:, self.mo_occ[1] > 0.5]
        ovlp = ca.T @ self.engine.s @ cb
        na, nb = ovlp.shape
        sz = 0.5 * (na - nb)
        s2 = sz * (sz + 1.0) + nb - float(torch.sum(ovlp * ovlp))
        return s2, 2.0 * (s2 + 0.25) ** 0.5
