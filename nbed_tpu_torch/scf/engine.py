"""SCF engine: per-molecule operator tensors and the SCF call (port of
``nbed_tpu/scf/engine.py``).

:class:`SCFEngine` owns the operators of one molecule and method on one
device (S, hcore, the ERI supermatrices or the density-fitting factor, grid
AO tables); ``kernel`` is a call whose embedding potentials, electron
counts and Huzinaga projectors are explicit arguments. Exact J/K products
go through the fused J/K kernel, prepared once per engine and dtype
(:func:`nbed_tpu_torch.ops.jk.prepare_jk`);
density-fitted J/K (:func:`df_b_factor`, :func:`_df_k_spin`) are plain
torch GEMMs, as they are XLA in the reference. :class:`SCFSolution` is the
result the embedding driver edits (environment deletion, virtual
localization).

Range-separated hybrids fold their exact exchange hyb*K + beta*K_LR(omega)
into the exchange operator and report ``hyb`` 1.0, as the reference does
(``engine.py:322-338, 439-452``): on the exact route ``eri_k`` is the folded
supermatrix the fused kernel reads; on the DF route K is built from the
ordinary factor and a second factor fitted in the long-range metric. MM
charges of a QM/MM molecule are in the host V, so in ``hcore``;
``rohf=True`` runs ROHF/ROKS through Roothaan's effective Fock.

One memory budget, ``max_memory_mb`` (the config's ``max_ram_memory``),
bounds the two large intermediates as in the reference: the auxiliary
chunk of the DF exchange and the switch from AO-table XC to streaming XC.

Two mixed-precision modes are options, off by default
(``nbed_tpu/scf/engine.py:462-581, 1036-1057``): ``warmup_f32`` runs a
float32 SCF to loose convergence before the float64 one, and
``incremental_jk="on"`` builds most J/K of the float64 SCF from float32
contractions of the density change. Every exact-ERI J/K in float32 goes
through the fused kernel too. Not ported: the TPU-only compiled-program
machinery and the TPU's Pallas switch (``pallas_jk``).
"""

import logging
import time
from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from typing import Optional

import numpy as np
import torch

from .._device import DTYPE, resolve_device
from ..chem.basis.auxiliary import make_auxiliary_molecule
from ..chem.molecule import Molecule, build_molecule
from ..chem.periodic import SYMBOL_TO_Z, Z_TO_SYMBOL
from ..dft.functionals import resolve_functional
from ..dft.xc import make_xc_fn, make_xc_fn_streaming
from ..grids import build_grid, eval_aos
from ..integrals import native
from ..ops.jk import prepare_jk
from .hf import make_rdm1, run_scf

logger = logging.getLogger(__name__)

__all__ = ["SCFEngine", "SCFSolution", "VeffResult", "df_b_factor"]


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


def df_b_factor(mol, beta: float = 1.8, device="cuda",
                timings: Optional[dict] = None, omega: float = 0.0):
    """Metric-folded DF factor with (ab|cd) ~ sum_P B[a,P,b] B[c,P,d], as a
    float64 (nao, nkeep, nao) tensor on ``device`` (``nbed_tpu``'s
    ``df_b_factor``, ``engine.py:54-82``, stores the same numbers as
    (nao, nao, naux)). ``omega > 0`` fits in the long-range
    erf(omega*r12)/r12 metric, three-centre integrals and metric alike: the
    factor of a range-separated hybrid's long-range exchange, with its own
    ``eigh`` and keep rule.

    The 3-centre and 2-centre integrals over the automatic auxiliary basis
    and the metric ``eigh`` run on the host in float64 with the reference's
    keep rule ``w > 1e-10 * w.max()`` (canonical orthogonalisation), so both
    packages keep the same metric directions; the product with M^-1/2 runs
    on ``device``. B differs from the reference's by a rotation of the
    auxiliary axis (eigenvector freedom): compare B B^T, never B.

    ``timings``, when given, receives the seconds of each part:
    ``eri_3c``, ``eri_2c``, ``eigh`` (host) and ``product`` (device).
    """
    device = resolve_device(device)
    timings = {} if timings is None else timings
    aux = make_auxiliary_molecule(mol, beta=beta)
    t0 = time.perf_counter()
    b3 = native.eri_3c(mol, aux, omega=omega)
    t1 = time.perf_counter()
    m2 = native.eri_2c(aux, omega=omega)
    t2 = time.perf_counter()
    w, v = np.linalg.eigh(m2)
    keep = w > 1e-10 * w.max()
    m_isqrt = v[:, keep] / np.sqrt(w[keep])[None, :]  # (naux, nkeep)
    t3 = time.perf_counter()
    nao = mol.nao
    b = torch.as_tensor(b3, dtype=DTYPE, device=device).reshape(nao * nao, -1)
    b = b @ torch.as_tensor(m_isqrt, dtype=DTYPE, device=device)
    b = b.reshape(nao, nao, -1).permute(0, 2, 1).contiguous()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings.update(eri_3c=t1 - t0, eri_2c=t2 - t1, eigh=t3 - t2,
                   product=time.perf_counter() - t3)
    logger.debug("DF aux: %d functions, %d kept after metric pruning",
                 len(w), int(keep.sum()))
    return b


# max elements of the (nao, chunk, nao) DF-exchange intermediate at the
# default 4000 MB budget, the reference's bound (nbed_tpu/scf/engine.py:
# 85-92); engines scale it linearly with max_memory_mb, so the config's
# max_ram_memory bounds the same intermediate in both packages
_DF_K_CHUNK_ELEMS = int(2e7)


def _df_k_spin(b, d, chunk_elems: int = _DF_K_CHUNK_ELEMS):
    """DF exchange K = sum_P B_P d B_P of one spin density ``d``, for any
    symmetric ``d``; ``b`` is the (nao, naux, nao) factor.

    Per block of the auxiliary axis, two products: U[l,P,i] = (d B_P)[l,i]
    as one GEMM over a strided view of ``b``, then K += sum_l U_l^T B_l as
    a batched GEMM. Above ``chunk_elems`` elements of U the block is the
    reference's ``max(256, chunk_elems // nao^2)`` auxiliary functions; a
    short last block takes the remainder (K is exact under any partition
    of P).
    """
    nao, naux = b.shape[0], b.shape[1]
    chunk = naux if nao * nao * naux <= chunk_elems else \
        max(256, chunk_elems // (nao * nao))
    k = torch.zeros((nao, nao), dtype=b.dtype, device=b.device)
    for p0 in range(0, naux, chunk):
        b_c = b[:, p0:p0 + chunk]  # (nao, c, nao) view
        u = (d @ b_c.reshape(nao, -1)).reshape(nao, -1, nao)
        k += torch.bmm(u.transpose(1, 2), b_c).sum(0)
    return 0.5 * (k + k.T)


def _df_j(b, d):
    """DF Coulomb J of the total density ``d`` through the fitted density
    rho_P = sum_ab B[a,P,b] d[a,b]: two passes over B."""
    rho = torch.bmm(b, d.unsqueeze(-1)).sum(0).squeeze(-1)  # (naux,)
    return torch.matmul(rho, b)


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
        density_fitting: DF J/K through the factor ``df_b`` instead of the
          exact ERI supermatrices.
        df_b: a DF factor to use (from :func:`df_b_factor` for this
          molecule and ``df_beta``), so engines of one molecule share one;
          built at first use when None. A range-separated hybrid also
          builds ``df_b_lr``, its long-range factor, at first use.
        max_memory_mb: memory budget scaling the DF-exchange chunk and the
          table/streaming XC switch from their 4000-MB calibration.
        rohf: restricted open shell (ROHF, or ROKS with ``xc``): both spins
          share spatial orbitals through Roothaan's effective Fock.
        warmup_f32: seed a full-molecule SCF from a float32 SCF (conv_tol
          1e-4, dm_conv_tol 1e-3) on float32 casts of the operators. Its
          J/K are exact even with density fitting, as in the reference:
          the float32 supermatrices are 2 * nao^4 * 4 bytes (2 GB at
          nao 126) beside the float64 ERI tensor they are cast from.
        incremental_jk: ``"on"``: the float64 SCF contracts each cycle's
          density change in float32 (exact or DF, as the engine is) and
          rebuilds J/K in float64 every ``rebase_every`` cycles, with
          float32 XC on coarse cycles and a float64 polish at the end;
          ``"off"`` or ``"auto"`` (the reference turns "auto" on only on
          a TPU): plain float64.
    """

    mol: Molecule
    xc: Optional[str] = None
    conv_tol: float = 1e-6
    dm_conv_tol: float = 1e-6
    max_cycle: int = 50
    init_guess: str = "sad"  # "sad" | "hcore"
    device: str = "cuda"
    density_fitting: bool = False
    df_beta: float = 1.8  # even-tempered auxiliary-basis ratio
    df_b: Optional[torch.Tensor] = field(default=None, repr=False)
    df_b_lr: Optional[torch.Tensor] = field(default=None, repr=False)
    max_memory_mb: float = 4000.0
    rohf: bool = False
    warmup_f32: bool = False
    incremental_jk: str = "off"  # "on" | "off" | "auto" (= off)
    rebase_every: int = 8  # float64 J/K rebuild period of the incremental SCF
    # seconds of each part of this engine's factor builds (df_b_factor)
    df_timings: dict = field(default_factory=dict, init=False, repr=False)
    df_lr_timings: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.init_guess not in ("sad", "hcore"):
            raise ValueError(f"init_guess must be 'sad' or 'hcore', got {self.init_guess!r}")
        if self.incremental_jk not in ("on", "off", "auto"):
            raise ValueError("incremental_jk must be 'on', 'off' or 'auto', "
                             f"got {self.incremental_jk!r}")
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
        _, t, v = self._native_1e  # V includes the MM charges
        return self._tensor(t + v)

    @cached_property
    def eri(self):
        return self._tensor(native.eri(self.mol, self.coords))

    @cached_property
    def eri_lr(self):
        """Long-range erf(omega*r12)/r12 AO ERIs of a range-separated hybrid."""
        _, omega = self._rsh
        return self._tensor(native.eri(self.mol, self.coords, omega=omega))

    @cached_property
    def eri_j(self):
        n = self.mol.nao
        return self.eri.reshape(n * n, n * n).contiguous()

    @cached_property
    def eri_k(self):
        """Exchange supermatrix (ik|jl); for a range-separated hybrid the
        folded hyb*(ik|jl) + beta*(ik|jl)_LR(omega), which every consumer
        pairs with the reported ``hyb`` of 1.0."""
        n = self.mol.nao
        k = self.eri.permute(0, 2, 1, 3).reshape(n * n, n * n)
        if self._rsh is None:
            return k.contiguous()
        beta, _ = self._rsh
        k_lr = self.eri_lr.permute(0, 2, 1, 3).reshape(n * n, n * n)
        return (self._xc_meta[1] * k + beta * k_lr).contiguous()

    def df_factor(self):
        """The DF factor B (nao, naux, nao), built on first use."""
        if self.df_b is None:
            self.df_b = df_b_factor(self.mol, self.df_beta, self.device,
                                    timings=self.df_timings)
        return self.df_b

    def df_factor_lr(self):
        """The long-range DF factor of a range-separated hybrid, built on
        first use (``nbed_tpu/scf/engine.py:588-594``)."""
        if self.df_b_lr is None:
            self.df_b_lr = df_b_factor(self.mol, self.df_beta, self.device,
                                       timings=self.df_lr_timings,
                                       omega=self._rsh[1])
        return self.df_b_lr

    @property
    def _df_chunk_elems(self) -> int:
        """Auxiliary-chunk element bound of the DF exchange, scaled from
        the 4000-MB calibration by :attr:`max_memory_mb`."""
        return max(int(_DF_K_CHUNK_ELEMS * self.max_memory_mb / 4000.0), 1_000_000)

    @property
    def _XC_TABLE_LIMIT(self) -> float:
        """AO-table elements (points x nao) above which the XC streams AO
        evaluation per grid chunk (1e8 at 4000 MB, counting the AO table
        once), as ``nbed_tpu/scf/engine.py:356-358``."""
        return 1e8 * self.max_memory_mb / 4000.0

    @cached_property
    def _grid(self):
        return build_grid(self.mol, self.device)

    @cached_property
    def _xc_meta(self):
        """(terms, hyb, rsh) of the functional; HF when xc is None."""
        if self.xc is None:
            return [], 1.0, None
        return resolve_functional(self.xc)

    @property
    def _rsh(self):
        """(beta, omega) of a range-separated hybrid, else None."""
        return self._xc_meta[2]

    @cached_property
    def _ao_tables(self):
        return eval_aos(self.mol, self._grid[0])

    def _build_xc(self, dtype):
        """The XC closure in ``dtype``: the AO-table quadrature, or the
        streaming one above :attr:`_XC_TABLE_LIMIT`."""
        points, weights = self._grid
        if points.shape[0] * self.mol.nao > self._XC_TABLE_LIMIT:
            return make_xc_fn_streaming(self.mol, points, weights, self.xc,
                                        dtype=dtype)
        ao, ao_grad = self._ao_tables
        return make_xc_fn(ao.to(dtype), ao_grad.to(dtype), weights.to(dtype), self.xc)

    @cached_property
    def _xc(self):
        """(xc_fn or None, hyb). Under range separation hyb is 1.0: the
        exchange weights are folded into K."""
        terms, hyb, rsh = self._xc_meta
        if rsh is not None:
            hyb = 1.0
        if not terms:
            return None, hyb
        return self._build_xc(DTYPE), hyb

    @cached_property
    def _xc_f32(self):
        """Float32 XC closure of the mixed-precision modes, or None."""
        return None if self._xc[0] is None else self._build_xc(torch.float32)

    @cached_property
    def _f32_ops(self):
        """Float32 operators of the warm-up SCF: hcore, S, the XC closure,
        hyb, and exact J/K through the fused kernel on float32 casts of the
        ERI supermatrices (``nbed_tpu/scf/engine.py:462-479``)."""
        f32 = torch.float32
        jk = prepare_jk(self.eri_j.to(f32).contiguous(), self.eri_k.to(f32).contiguous())
        return {
            "hcore": self.hcore.to(f32), "s": self.s.to(f32),
            "jk_fn": lambda dm: jk(dm.contiguous()),
            "xc_fn": self._xc_f32, "hyb": self.hyb,
        }

    @cached_property
    def _jk_exact(self):
        """Exact J/K on ``eri_j``/``eri_k``, prepared at first use (DF
        engines never build it)."""
        return prepare_jk(self.eri_j, self.eri_k)

    @cached_property
    def _jk_fast_fn(self):
        """Float32 J/K of the incremental SCF's density changes, or None
        unless ``incremental_jk == "on"`` (``engine.py:514-570``): the
        fused kernel on the float32 supermatrices, or DF J/K on a float32
        cast of the factor(s). Its input is a difference of densities,
        symmetric but not positive semidefinite; J and K are linear in it."""
        if self.incremental_jk != "on":
            return None
        if not self.density_fitting:
            return self._f32_ops["jk_fn"]
        f32 = torch.float32
        b32 = self.df_factor().to(f32)
        b32_lr = None if self._rsh is None else self.df_factor_lr().to(f32)
        return lambda dm: (_df_j(b32, dm[0] + dm[1]), self._df_k(dm, b32, b32_lr))

    @property
    def _xc_fast_fn(self):
        """Float32 XC of the incremental SCF's coarse cycles, or None."""
        return None if self._jk_fast_fn is None else self._xc_f32

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
        """(J (n, n), K (2, n, n)) of a density: density-fitted, or exact
        through the fused kernel. Under range separation K is the folded
        hyb*K + beta*K_LR on both routes."""
        dm = _spinify(dm)
        if not self.density_fitting:
            return self._jk_exact(dm.contiguous())
        return _df_j(self.df_factor(), dm[0] + dm[1]), self._df_k(dm)

    def _df_k(self, dm, b=None, b_lr=None):
        """(2, n, n) DF exchange of a spin density pair, folded under range
        separation (``nbed_tpu/scf/engine.py:596-607``), from the engine's
        factors or the given ones (``b_lr`` only under range separation)."""
        chunk = self._df_chunk_elems

        def k_of(f):
            return torch.stack([_df_k_spin(f, dm[0], chunk), _df_k_spin(f, dm[1], chunk)])

        k = k_of(self.df_factor() if b is None else b)
        if self._rsh is None:
            return k
        k_lr = k_of(self.df_factor_lr() if b_lr is None else b_lr)
        return self._xc_meta[1] * k + self._rsh[0] * k_lr

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
        from_guess = False
        if (dm0 is None and self.init_guess == "sad"
                and tuple(nelec) == tuple(self.mol.nelec) and v_emb is None):
            # full-molecule SCF: seed from atomic densities (embedded SCFs
            # keep the reference's modified-hcore guess)
            dm0 = self._sad_guess()
            from_guess = True
        max_cycle = self.max_cycle if max_cycle is None else max_cycle

        def opt(t, dtype=DTYPE):
            return None if t is None else _spinify(self._tensor(t)).to(dtype)

        if self.warmup_f32 and (dm0 is None or from_guess):
            f32 = torch.float32
            ops = self._f32_ops
            warm = run_scf(
                hcore=ops["hcore"], s=ops["s"], jk_fn=ops["jk_fn"], nelec=nelec,
                v_emb=None if v_emb is None else self._tensor(v_emb).to(f32),
                xc_fn=ops["xc_fn"], hyb=ops["hyb"],
                dm_env_occ=opt(dm_env_occ, f32), dm_env_virt=opt(dm_env_virt, f32),
                dm0=opt(dm0, f32), conv_tol=1e-4, dm_conv_tol=1e-3,
                max_cycle=max_cycle, rohf=self.rohf,
            )
            dm0 = warm.dm.to(DTYPE)

        res = run_scf(
            hcore=self.hcore, s=self.s, jk_fn=self.get_jk, nelec=nelec,
            jk_fn_fast=self._jk_fast_fn, xc_fn_fast=self._xc_fast_fn,
            rebase_every=self.rebase_every,
            v_emb=None if v_emb is None else self._tensor(v_emb),
            xc_fn=xc_fn, hyb=hyb,
            dm_env_occ=opt(dm_env_occ), dm_env_virt=opt(dm_env_virt), dm0=opt(dm0),
            conv_tol=self.conv_tol if conv_tol is None else conv_tol,
            dm_conv_tol=self.dm_conv_tol if dm_conv_tol is None else dm_conv_tol,
            max_cycle=max_cycle, level_shift=level_shift, rohf=self.rohf,
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
