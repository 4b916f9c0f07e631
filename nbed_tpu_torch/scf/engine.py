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
``rohf=True`` runs ROHF/ROKS through Roothaan's effective Fock;
``restricted=True`` changes only how a closed-shell solution is reported
(one (n, k) orbital set, occupations 0/2), as in the reference.

One memory budget, ``max_memory_mb`` (the config's ``max_ram_memory``),
bounds the two large intermediates as in the reference: the auxiliary
chunk of the DF exchange and the switch from AO-table XC to streaming XC.

Two mixed-precision modes are options, off by default
(``nbed_tpu/scf/engine.py:462-581, 1036-1057``): ``warmup_f32`` runs a
float32 SCF to loose convergence before the float64 one, and
``incremental_jk="on"`` builds most J/K of the float64 SCF from float32
contractions of the density change. Every exact-ERI J/K in float32 goes
through the fused kernel too.

Compiled programs (``jit_kernel``, ``dispatch_cycles``; the reference's
``_jitted_kernel``, ``_jitted_veff`` and ``_jitted_subsys``,
``engine.py:764-937``): on a CUDA device an SCF runs as CUDA graphs. The
cycle of :class:`nbed_tpu_torch.scf.hf.SCFProgram` (J/K through the fused
kernel or DF, XC, DIIS and the Fock diagonalisation through the capturable
cuSOLVER eigh of :mod:`nbed_tpu_torch.ops.eigh`) is captured ``K`` cycles
at a time, with one host read per replay, and the final Fock build once;
the float32 warm-up has its own float32 graphs, and the incremental SCF
its mixed loop's cycle variants (see :class:`_GraphedSCF`).
``get_veff`` and the subsystem-DFT stage are one replay each.

Programs are shared as the reference shares its compiled ones
(``_jit_spec``, ``_shared_jit``, ``_JIT_PROGRAM_CACHE``, ``engine.py:
144-145, 657-685``): keyed by structure, operand shapes, call signature
and card, never by engine or geometry, in a bounded LRU. A program reads
its operators from fixed buffers (:class:`_Operands`), into which an
engine's operators are copied when it is not their current owner, so the
engines of a geometry scan, a Hessian or a second driver replay the first
one's graphs. :func:`lane_scf` runs the lane SCFs of the batched
energies, gradients, Hessians and the embedding program as programs of
the same cache. The reference's jit-argument packing and its TPU
streaming-crash chunking are not ported, nor is its Pallas switch
(``pallas_jk``): the port always runs its kernel.
"""

import itertools
import logging
import weakref
from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from typing import Optional

import numpy as np
import torch
from torch.autograd import forward_ad

from .._device import DTYPE, resolve_device
from ..chem.basis.auxiliary import make_auxiliary_molecule
from ..chem.molecule import Molecule, build_molecule
from ..chem.periodic import SYMBOL_TO_Z, Z_TO_SYMBOL
from ..dft.functionals import resolve_functional
from ..dft.xc import STREAM_CHUNK, TABLE_CHUNK, make_xc_fn, make_xc_fn_streaming
from ..grids import build_grid, eval_aos
from ..grids.grid import ao_views, grid_constants, grid_points, shell_tables
from ..integrals import kinetic, native, nuclear_attraction, overlap, point_charge_attraction
from ..integrals.eri import eri_program
from ..ops import eigh as eigh_ops
from ..ops import eri as md_eri
from ..ops.jk import LAUNCHES, prepare_jk
from ..ops.programs import RUNS, cached_program, has_tangent, replay, takes_program
from ..ops.programs import Captured as _Captured
from ..ops.programs import card as _card
from ..profiling import span
from .hf import (SCFProgram, TangentSCFProgram, _first_lane, _one_lane, carries_derivative,
                 lowdin_x, make_rdm1, run_scf)

logger = logging.getLogger(__name__)

__all__ = ["SCFEngine", "SCFSolution", "VeffResult", "df_b_factor", "DISPATCH_CYCLES",
           "RUNS", "lane_scf", "lane_spec", "single_scf"]

# SCF cycles per graph replay when dispatch_cycles is None: capture time
# grows by 30-160 ms per captured cycle (water to pfoa) and is paid once
# per engine and call signature, while a host read per replay costs no
# measurable time and a longer chunk runs up to K - 1 frozen cycles after
# convergence (PERF.md §6, scripts/bench_graphs.py)
DISPATCH_CYCLES = 1



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
                timings: Optional[dict] = None, omega: float = 0.0, coords=None):
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

    ``coords`` (Bohr) overrides the molecule's geometry. ``timings``, when
    given, receives the seconds of each part, the spans "df.eri_3c",
    "df.eri_2c", "df.eigh" (host) and "df.product" (device, synchronised):
    ``eri_3c``, ``eri_2c``, ``eigh`` and ``product``.
    """
    device = resolve_device(device)
    timings = {} if timings is None else timings
    aux = make_auxiliary_molecule(mol, beta=beta)
    with span("df.eri_3c") as eri_3c:
        b3 = native.eri_3c(mol, aux, coords, omega=omega)
    with span("df.eri_2c") as eri_2c:
        m2 = native.eri_2c(aux, coords, omega=omega)
    with span("df.eigh") as eigh:
        w, v = np.linalg.eigh(m2)
        keep = w > 1e-10 * w.max()
        m_isqrt = v[:, keep] / np.sqrt(w[keep])[None, :]  # (naux, nkeep)
    with span("df.product") as product:
        nao = mol.nao
        b = torch.as_tensor(b3, dtype=DTYPE, device=device).reshape(nao * nao, -1)
        b = b @ torch.as_tensor(m_isqrt, dtype=DTYPE, device=device)
        b = b.reshape(nao, nao, -1).permute(0, 2, 1).contiguous()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    timings.update(eri_3c=eri_3c.seconds, eri_2c=eri_2c.seconds, eigh=eigh.seconds,
                   product=product.seconds)
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


def _df_k_folded(dm, b, b_lr, chunk_elems: int, fold):
    """(2, n, n) DF exchange of a spin density pair from the factor ``b``;
    under range separation (``fold`` = (hyb, beta), ``b_lr`` the long-range
    factor) the folded hyb*K + beta*K_LR."""
    def k_of(f):
        return torch.stack([_df_k_spin(f, dm[0], chunk_elems),
                            _df_k_spin(f, dm[1], chunk_elems)])

    k = k_of(b)
    if fold is None:
        return k
    hyb, beta = fold
    return hyb * k + beta * k_of(b_lr)


def _df_j(b, d):
    """DF Coulomb J of the total density ``d`` through the fitted density
    rho_P = sum_ab B[a,P,b] d[a,b]: two passes over B."""
    rho = torch.bmm(b, d.unsqueeze(-1)).sum(0).squeeze(-1)  # (naux,)
    return torch.matmul(rho, b)


# Hund's-rule unpaired-electron counts for neutral atoms (SAD guess)
_ATOM_SPIN = {1: 1, 2: 0, 3: 1, 4: 0, 5: 1, 6: 2, 7: 3, 8: 2, 9: 1, 10: 0,
              11: 1, 12: 0, 13: 1, 14: 2, 15: 3, 16: 2, 17: 1, 18: 0}


@lru_cache(maxsize=64)
def _atomic_density(symbol: str, basis: str, device: str, jit_kernel: str = "auto"):
    """Spin-summed UHF density of the neutral atom (per-spin average), for
    the superposition-of-atomic-densities guess. The atoms' SCFs run on the
    molecule's device, their J/K through the fused kernel, graphed or eager
    as the molecule's engine (``jit_kernel``)."""
    mol = build_molecule(f"1\n\n{symbol} 0.0 0.0 0.0", basis)
    z = SYMBOL_TO_Z[symbol.capitalize()]
    spin = _ATOM_SPIN.get(z, z % 2)
    na = (z + spin) // 2
    eng = SCFEngine(mol, conv_tol=1e-8, max_cycle=100, init_guess="hcore",
                    device=device, jit_kernel=jit_kernel)
    dm = eng.kernel(nelec=(na, z - na)).make_rdm1()
    return 0.5 * (dm[0] + dm[1])


class _GraphedSCF:
    """An :class:`nbed_tpu_torch.scf.hf.SCFProgram` and its graphs in its
    structure's memory pool (direct calls off CUDA), each captured at its
    first use: the chunk of ``cycles`` plain cycles, the final Fock build,
    the ``grad_cycles`` polish, and for the incremental SCF the mixed
    loop's cycle variants: at one cycle per replay one graph per variant
    (float64 rebase or float32 increment, float32 or float64 XC), picked
    from the replay's one host read; a chunk of K > 1 cycles selects on
    the device with ``torch.where`` over both builds. A program of
    the cache (:func:`_shared_program`) holds its operator buffers
    (``operands``, which :data:`_OPERANDS` holds only weakly) and the
    names of the operator groups it reads (``needs``, see
    ``SCFEngine._operand_sources``), never an engine."""

    def __init__(self, program: SCFProgram, cycles: int, pool: list, operands=None,
                 needs: tuple = ()):
        self.program, self.cycles, self.pool = program, cycles, pool
        self.operands, self.needs = operands, needs
        self.chunk = self._captured(lambda: program.run_cycles(cycles),
                                    lambda: program.run_cycles(1))
        self.final = self._captured(program.finish)
        self.grad = self._captured(program.grad_polish) if program.grad_cycles else None
        self.mixed = {}

    def _captured(self, fn, warmup=None):
        # the capture's warm-up call runs the body once: the program's
        # state, in buffers fixed for its life, is restored after it
        return _Captured(fn, self.program.device, self.pool, warmup,
                         keep=self.program.buffers())

    def _variant(self, variant, k: int) -> _Captured:
        """The graph of ``k`` incremental cycles of ``variant``."""
        if (variant, k) not in self.mixed:
            prog = self.program
            self.mixed[variant, k] = self._captured(lambda: prog.run_cycles(k, variant),
                                                    lambda: prog.run_cycles(1, variant))
        return self.mixed[variant, k]

    def launches_per_replay(self) -> dict:
        """{key: fused J/K launches} of one chunk replay."""
        return self.chunk.record.launches(LAUNCHES)

    def _ensure(self, captured: _Captured, stats: dict):
        """Capture ``captured`` at its first use."""
        if not captured.captures or captured.graph is not None:
            return
        with span("program.capture", {"kind": "scf"}) as capture:
            captured.capture()
        stats["capture_s"] += capture.seconds
        stats["captures"] += 1
        before, after = captured.reserved
        RUNS["scf_pool_gb"] += (after - before) / 1e9

    def _replay(self, captured: _Captured, stats: dict):
        self._ensure(captured, stats)
        captured()
        stats["replays"] += 1

    def _loop(self, pick, max_cycle: int, stats: dict) -> list:
        """Replay ``pick(it, ddm)`` (a graph and its cycles) until the
        flags read converged or ``max_cycle`` cycles, one host read per
        replay; returns the last status."""
        prog = self.program
        it, ddm = 0, float("inf")
        while True:
            graph, k = pick(it, ddm)
            self._replay(graph, stats)
            status = prog.status.tolist()  # the replay's one host read
            stats["host_reads"] += 1
            conv, cycles, failures, ddm, _ = status
            if failures:
                prog.flags.zero_()
                eigh_ops.failure_count(prog.device).zero_()
                raise RuntimeError(f"eigh: cuSOLVER failed on {int(failures)} matrices in a "
                                   "graphed SCF")
            it += k
            if conv or cycles >= max_cycle:
                return status

    def run(self, inputs: dict, stats: dict):
        """Load ``inputs`` (:meth:`SCFProgram.load`), run the incremental
        mixed loop and restart for the polish where the program is
        incremental, replay the chunk until converged or ``max_cycle``
        cycles, then the ``grad_cycles`` polish if any lane converged and
        the final build; returns the
        :class:`nbed_tpu_torch.scf.hf.SCFResult` and adds replays, host
        reads, captures and capture seconds to ``stats``. The load is a part
        of the span "scf.setup", the rest the span "scf.run"."""
        prog = self.program
        with span("scf.setup"):
            prog.load(**inputs)
        max_cycle = int(inputs["max_cycle"])
        with span("scf.run"):
            mixed = 0
            if prog.incremental:
                def pick(it, ddm):
                    if self.cycles > 1:
                        return self._variant((None, None), self.cycles), self.cycles
                    coarse = prog.xc_fast and ddm > prog.xc_switch_tol
                    return self._variant((it % prog.rebase_every == 0, coarse), 1), 1

                mixed = int(self._loop(pick, max_cycle, stats)[1])
                prog.start_polish()
            status = self._loop(lambda it, ddm: (self.chunk, self.cycles), max_cycle, stats)
            if self.grad is not None and status[4]:
                for _ in range(prog.polish_replays):
                    self._replay(self.grad, stats)
            self._replay(self.final, stats)
            stats["host_reads"] += 1  # the energy, read by result()
            return prog.result(mixed)


class _FixedProgram:
    """A one-replay program of the cache (graphed ``get_veff`` or subsystem
    stage): its input and output ``buffers`` and the :class:`_Captured`
    function that reads and writes them, over its structure's float64
    operator buffers (``operands``)."""

    needs = ("f64",)

    def __init__(self, buffers: dict, captured: _Captured, operands):
        self.buffers, self.captured, self.operands = buffers, captured, operands


class _Operands:
    """The operator buffers of one structure's programs (the reference's
    jit arguments): fixed device tensors that the programs' closures and
    graphs read, each holding one owner's operator at a time (an engine,
    or one lane call), and the memory pool of the structure's graphs. A
    call from another owner copies its operators in first (eager
    ``copy_``, outside any graph); the first fill allocates them."""

    def __init__(self):
        self.buffers, self.owners = {}, {}
        self.pool = [None]

    def fill(self, owner: int, sources: dict):
        """Make the buffers of ``sources`` ({name: () -> tensor}) hold
        ``owner``'s operators; a source is called only where the buffer
        holds another owner's."""
        for name, source in sources.items():
            if self.owners.get(name) == owner:
                continue
            value = source().detach()
            buf = self.buffers.get(name)
            if buf is None:
                self.buffers[name] = torch.empty_like(
                    value, memory_format=torch.contiguous_format).copy_(value)
            else:
                buf.copy_(value)
            self.owners[name] = owner


# shared programs across engines, geometries and lane calls, keyed by
# (kind, structure (SCFEngine._jit_spec), operand shapes, call signature,
# card): geometry enters only through the operator buffers, so a new engine,
# driver, conformer or geometry step reuses a program and its graphs
# instead of capturing again. An LRU bounded as the reference bounds its
# own (nbed_tpu/scf/engine.py:144-145, 672-685): each entry pins its
# structure's operator buffers and graph memory
_JIT_PROGRAM_CACHE: dict = {}
_JIT_PROGRAM_CACHE_MAX = 24
# the live operator buffers by (structure, shapes, card): held by their
# programs
_OPERANDS = weakref.WeakValueDictionary()
# owner tokens of the operator buffers (engines and lane calls)
_OWNERS = itertools.count(1)


def _shared_program(key, build):
    """The cached program of ``key``, promoted to most recently used; else
    ``build()``'s, inserted after evicting the least recently used entries
    beyond :data:`_JIT_PROGRAM_CACHE_MAX` (``_shared_jit``'s rules)."""
    return cached_program(_JIT_PROGRAM_CACHE, _JIT_PROGRAM_CACHE_MAX, key, build)


def _operands(key) -> _Operands:
    """The live :class:`_Operands` of ``key``, or new ones."""
    ops = _OPERANDS.get(key)
    if ops is None:
        ops = _OPERANDS[key] = _Operands()
    return ops


def _stack_spins(h):
    """A (.., n, n) core Hamiltonian as (.., 2, n, n)."""
    return torch.stack([h, h], dim=-3)


def _jk_closure(buffers, suffix: str, density_fitting: bool, fold, chunk: int):
    """``dm (2, n, n) -> (J, K)`` over the operator buffers of one dtype
    (``suffix`` "" for float64, "32" for float32): the fused kernel on
    ``g_j``/``g_k``, or DF J/K on ``b`` (and ``b_lr``)."""
    if density_fitting:
        b, b_lr = buffers["b" + suffix], buffers.get("b_lr" + suffix)
        return lambda dm: (_df_j(b, dm[0] + dm[1]), _df_k_folded(dm, b, b_lr, chunk, fold))
    jk = prepare_jk(buffers["g_j" + suffix], buffers["g_k" + suffix])
    return lambda dm: jk(dm.contiguous())


def _xc_closure(buffers, suffix: str, mol, xc: str, streams: bool, dtype, chunk=None,
                differentiable: bool = False):
    """The engine's XC closure (``_build_xc``) over the operator buffers:
    AO tables, or the grid points and atoms of the streaming quadrature;
    ``chunk`` and ``differentiable`` as there."""
    if streams:
        return make_xc_fn_streaming(mol, buffers["points"], buffers["w" + suffix], xc,
                                    chunk=chunk or STREAM_CHUNK, dtype=dtype,
                                    differentiable=differentiable, coords=buffers["atoms"])
    return make_xc_fn(buffers["ao" + suffix], buffers["ao_grad" + suffix],
                      buffers["w" + suffix], xc, chunk=chunk or TABLE_CHUNK,
                      differentiable=differentiable)


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
        integrals_from: another engine of the same molecule object, at the
          same coordinates, integrals backend and device, whose S, hcore
          and ERIs this engine takes (computed there once, at first use)
          instead of computing its own, so engines of one molecule share
          one set of integrals; anything else raises ``ValueError``. The
          orthogonaliser, the J/K supermatrices, the long-range ERIs, the
          grid and the programs stay the engine's own.
        max_memory_mb: memory budget scaling the DF-exchange chunk and the
          table/streaming XC switch from their 4000-MB calibration.
        rohf: restricted open shell (ROHF, or ROKS with ``xc``): both spins
          share spatial orbitals through Roothaan's effective Fock.
        restricted: report style only (``nbed_tpu/scf/engine.py:1082-1113``):
          the solver stays spin-resolved, and the solution carries the
          alpha orbitals as (n, k), occupations 0/2 and the alpha Huzinaga
          operator; n_alpha != n_beta raises.
        warmup_f32: seed a full-molecule SCF from a float32 SCF (conv_tol
          1e-4, dm_conv_tol 1e-3) on float32 casts of the operators. Its
          J/K are exact even with density fitting, as in the reference:
          the float32 supermatrices are 2 * nao^4 * 4 bytes (2 GB at
          nao 126) beside the float64 ERI tensor they are cast from.
        coords: geometry (Bohr) of every operator, the grid and the
          nuclear repulsion, in place of ``mol.coords`` (the nuclear
          gradients' displaced and optimized geometries).
        grid_scheme, grid_level, grid_size: the XC grid (see
          :func:`nbed_tpu_torch.grids.build_grid`): ``"reference"`` at
          ``grid_level``, or ``"product"`` with ``grid_size`` = (radial
          points, polar angles).
        incremental_jk: ``"on"``: the float64 SCF contracts each cycle's
          density change in float32 (exact or DF, as the engine is) and
          rebuilds J/K in float64 every ``rebase_every`` cycles, with
          float32 XC on coarse cycles and a float64 polish at the end;
          ``"off"`` or ``"auto"`` (the reference turns "auto" on only on
          a TPU): plain float64.
        integrals_backend: ``"native"``: S, hcore and the ERIs from the
          host C++ engine; ``"auto"``: the same, but the ERIs from the
          card's kernel (:func:`nbed_tpu_torch.ops.eri.eri`) on a CUDA
          device where every shell is within it (up to d); ``"torch"``
          (or ``"jax"``, the reference's name for its device integrals):
          from the port's torch integrals (:mod:`nbed_tpu_torch.integrals`)
          on the engine's device. The DF factor is built on the host
          either way.
        jit_kernel: how ``kernel()``, ``get_veff`` and
          ``subsystem_decomposition`` run. ``"on"``: as graphed programs
          (:class:`nbed_tpu_torch.scf.hf.SCFProgram`): on CUDA captured as
          CUDA graphs, where a failure to capture raises; on the CPU the
          same chunk body runs without capture. ``"auto"``: graphed on a
          CUDA device, eager on the CPU. ``"off"``: eager. A call whose
          inputs carry ``requires_grad`` or a forward-mode tangent runs
          eagerly under "auto" and raises under "on". The programs are
          shared by every engine of the same structure (``_jit_spec``),
          operand shapes and call signature, from a bounded LRU
          (:data:`_JIT_PROGRAM_CACHE`): a second engine of a molecule, at
          the same or another geometry, reuses the first one's graphs.
          ``last_run`` records how the last ``kernel()`` ran.
        dispatch_cycles: SCF cycles per graph replay: K with
          0 < K < max_cycle gives K cycles per replay and one host read of
          the convergence flags after each; 0 (or K >= max_cycle) one
          replay of max_cycle cycles; None :data:`DISPATCH_CYCLES`. The
          DIIS history, density, energy and cycle count carry from one
          replay to the next, so the graphed SCF gives the iterates of
          the eager route, which runs the same cycle, whatever K is (the
          reference restarts DIIS at each chunk, ``engine.py:1010-1033``).
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
    integrals_from: Optional["SCFEngine"] = field(default=None, repr=False)
    max_memory_mb: float = 4000.0
    rohf: bool = False
    restricted: bool = False
    warmup_f32: bool = False
    incremental_jk: str = "off"  # "on" | "off" | "auto" (= off)
    rebase_every: int = 8  # float64 J/K rebuild period of the incremental SCF
    grid_size: tuple = (96, 22)  # (n_radial, n_theta) for scheme="product"
    grid_scheme: str = "reference"  # "reference" (PySCF-parity) | "product"
    grid_level: int = 3  # per-element density level for scheme="reference"
    coords: Optional[np.ndarray] = None  # geometry override (Bohr)
    integrals_backend: str = "auto"  # "auto" | "native" | "torch" ("jax" = "torch")
    jit_kernel: str = "auto"  # "auto" (graphs on CUDA) | "on" | "off"
    dispatch_cycles: Optional[int] = None  # SCF cycles per graph replay
    # seconds of each part of this engine's factor builds (df_b_factor)
    df_timings: dict = field(default_factory=dict, init=False, repr=False)
    df_lr_timings: dict = field(default_factory=dict, init=False, repr=False)
    # how the last kernel() ran: mode "graph" or "eager", replays,
    # host_reads, captures, capture_s, cycles (and warmup_cycles, and the
    # incremental SCF's mixed_cycles)
    last_run: dict = field(default_factory=dict, init=False, repr=False)
    # this engine as the owner of shared operator buffers (_Operands)
    _token: int = field(default_factory=lambda: next(_OWNERS), init=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.init_guess not in ("sad", "hcore"):
            raise ValueError(f"init_guess must be 'sad' or 'hcore', got {self.init_guess!r}")
        if self.incremental_jk not in ("on", "off", "auto"):
            raise ValueError("incremental_jk must be 'on', 'off' or 'auto', "
                             f"got {self.incremental_jk!r}")
        if self.jit_kernel not in ("on", "off", "auto"):
            raise ValueError(f"jit_kernel must be 'on', 'off' or 'auto', got {self.jit_kernel!r}")
        if self.integrals_backend not in ("auto", "native", "torch", "jax"):
            raise ValueError("integrals_backend must be 'auto', 'native', 'torch' or 'jax', "
                             f"got {self.integrals_backend!r}")
        if self.dispatch_cycles is not None and int(self.dispatch_cycles) < 0:
            raise ValueError(f"dispatch_cycles must be >= 0, got {self.dispatch_cycles}")
        self.coords = np.asarray(self.mol.coords if self.coords is None else self.coords,
                                 dtype=np.float64)
        other = self.integrals_from
        if other is not None and not (
                other.mol is self.mol and np.array_equal(other.coords, self.coords)
                and other._torch_integrals == self._torch_integrals
                and other.device == self.device):
            raise ValueError("integrals_from must be an engine of the same molecule, "
                             "coordinates, integrals backend and device")

    def _tensor(self, array):
        return torch.as_tensor(array, dtype=DTYPE, device=self.device)

    # ---------------------------------------------------------- operators
    @property
    def _torch_integrals(self) -> bool:
        """Whether S, hcore and the ERIs come from the torch integrals."""
        return self.integrals_backend in ("torch", "jax")

    @property
    def _card_eri(self) -> bool:
        """Whether the ERIs come from the card's kernel: backend "auto" on a
        CUDA device, every shell within the kernel's."""
        return (self.integrals_backend == "auto" and self.device.type == "cuda"
                and md_eri.covers(self.mol))

    @cached_property
    def _native_1e(self):
        if self.integrals_from is not None:
            return self.integrals_from._native_1e
        with span("integrals.native"):
            return native.one_electron(self.mol, self.coords)

    @cached_property
    def s(self):
        if self.integrals_from is not None:
            return self.integrals_from.s
        if self._torch_integrals:
            return overlap(self.mol, self.coords, device=self.device)
        return self._tensor(self._native_1e[0])

    @cached_property
    def x(self):
        """S^-1/2 (Löwdin), the orthogonaliser of every SCF of the engine."""
        return lowdin_x(self.s)

    @cached_property
    def hcore(self):
        if self.integrals_from is not None:
            return self.integrals_from.hcore
        if self._torch_integrals:
            mol = self.mol
            h = (kinetic(mol, self.coords, device=self.device)
                 + nuclear_attraction(mol, self.coords, device=self.device))
            if mol.mm_coords is not None:
                h = h + point_charge_attraction(mol, mol.mm_coords, mol.mm_charges,
                                                mol.mm_radii, coords=self.coords,
                                                device=self.device)
            return h
        _, t, v = self._native_1e  # V includes the MM charges
        return self._tensor(t + v)

    @cached_property
    def eri(self):
        if self.integrals_from is not None:
            return self.integrals_from.eri
        if self._torch_integrals:  # the "eri" program under jit_kernel
            return eri_program(self.mol, self._tensor(self.coords), jit_kernel=self.jit_kernel)
        if self._card_eri:
            with span("integrals.card"):
                return md_eri.eri(self.mol, self._tensor(self.coords))
        with span("integrals.native"):
            return self._tensor(native.eri(self.mol, self.coords))

    @cached_property
    def eri_lr(self):
        """Long-range erf(omega*r12)/r12 AO ERIs of a range-separated hybrid."""
        _, omega = self._rsh
        if self._torch_integrals:
            return eri_program(self.mol, self._tensor(self.coords), omega=omega,
                               jit_kernel=self.jit_kernel)
        if self._card_eri:
            with span("integrals.card"):
                return md_eri.eri(self.mol, self._tensor(self.coords), omega)
        with span("integrals.native"):
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
                                    timings=self.df_timings, coords=self.coords)
        return self.df_b

    def df_factor_lr(self):
        """The long-range DF factor of a range-separated hybrid, built on
        first use (``nbed_tpu/scf/engine.py:588-594``)."""
        if self.df_b_lr is None:
            self.df_b_lr = df_b_factor(self.mol, self.df_beta, self.device,
                                       timings=self.df_lr_timings,
                                       omega=self._rsh[1], coords=self.coords)
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
        """(points, weights) of the XC grid; one replay of the shared "grid"
        program where ``jit_kernel`` graphs the engine's calls."""
        if self._takes_graphs(()):
            out = self._table_program("grid")
            return out["points"], out["w"]
        return build_grid(self.mol, self.coords, n_rad=self.grid_size[0],
                          n_theta=self.grid_size[1], scheme=self.grid_scheme,
                          level=self.grid_level, device=self.device)

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
        """(ao (G, nao), ao_grad (3, G, nao)) on the grid; one replay of the
        shared "aos" program where ``jit_kernel`` graphs the engine's
        calls."""
        if self._takes_graphs(()):
            out = self._table_program("aos")
            return out["ao"], out["ao_grad"]
        return eval_aos(self.mol, self._grid[0], self.coords)

    def _table_program(self, kind: str) -> dict:
        """This engine's grid ("grid": "points", "w") or AO tables ("aos":
        "ao", "ao_grad") from the shared program of ``kind`` (the
        reference's ``_shared_jit("grid")`` and ``_shared_jit("aos")``,
        ``engine.py:360-410``). The structure's constants (the grid's
        atom-relative points, owners, base weights and Bragg radii; the
        shell tables) are made once, outside the capture, so the captured
        body reads tensors only; the atoms' coordinates (and the grid
        points) are its input buffers. The grid program, keyed by (kind,
        ``_jit_spec``, card), writes buffers of its own; the AO program,
        a program of ``_shared_jit`` (its key has the grid points too),
        writes the structure's operator buffers "ao" and "ao_grad" that
        the SCF programs read, now this engine's. Either way the engine
        keeps a copy: its tables stay when another engine of its
        structure replays the program."""
        mol, device = self.mol, self.device

        def atoms():
            return torch.zeros((len(mol.atom_charges), 3), dtype=DTYPE, device=device)

        def build_grid_program():
            coords = atoms()
            consts = grid_constants(mol, self.grid_size[0], self.grid_size[1],
                                    self.grid_scheme, self.grid_level, device)
            n = consts["rel"].shape[0]
            out = {"points": torch.zeros((n, 3), dtype=DTYPE, device=device),
                   "w": torch.zeros(n, dtype=DTYPE, device=device)}

            def fn():
                points, w = grid_points(consts, coords)
                out["points"].copy_(points)
                out["w"].copy_(w)

            return self._table_fixed({"coords": coords}, out, _Captured(fn, device, [None]),
                                     None)

        def build_aos_program(ops):
            coords, g = atoms(), self._grid[0].shape[0]
            tables = shell_tables(mol, DTYPE, device)
            points = torch.zeros((g, 3), dtype=DTYPE, device=device)
            out = {"ao": ops.buffers.setdefault(
                       "ao", torch.zeros((g, mol.nao), dtype=DTYPE, device=device)),
                   "ao_grad": ops.buffers.setdefault(
                       "ao_grad", torch.zeros((3, g, mol.nao), dtype=DTYPE, device=device))}

            def fn():
                ao, ao_grad = ao_views(mol, points, coords, tables)
                out["ao"].copy_(ao)
                out["ao_grad"].copy_(ao_grad)

            return self._table_fixed({"coords": coords, "points": points}, out,
                                     _Captured(fn, device, ops.pool), ops)

        if kind == "grid":
            prog = _shared_program(("grid", self._jit_spec, _card(device)), build_grid_program)
        else:
            prog = self._shared_jit("aos", build_aos_program)
            prog.buffers["points"].copy_(self._grid[0])
        prog.buffers["coords"].copy_(self._tensor(self.coords))
        replay(prog.captured, f"{kind}_graph")
        if prog.operands is not None:  # the operator buffers hold this engine's tables
            prog.operands.owners.update({name: self._token for name in prog.outputs})
        return {name: prog.buffers[name].clone() for name in prog.outputs}

    @staticmethod
    def _table_fixed(inputs: dict, out: dict, captured: _Captured, operands) -> _FixedProgram:
        """A table program: reads no operator group, writes ``out``."""
        prog = _FixedProgram({**inputs, **out}, captured, operands)
        prog.needs, prog.outputs = (), tuple(out)
        return prog

    @property
    def _xc_streams(self) -> bool:
        """Whether the XC closures evaluate the AOs per grid chunk (above
        :attr:`_XC_TABLE_LIMIT`) instead of keeping whole-grid tables."""
        return self._grid[0].shape[0] * self.mol.nao > self._XC_TABLE_LIMIT

    def _build_xc(self, dtype, differentiable: bool = False, chunk=None):
        """The XC closure in ``dtype``: the AO-table quadrature, or the
        streaming one above :attr:`_XC_TABLE_LIMIT`, over grid chunks of
        ``chunk`` points (default: the path's, :data:`TABLE_CHUNK` or
        :data:`STREAM_CHUNK`); ``differentiable`` as in
        :func:`nbed_tpu_torch.dft.xc.make_xc_fn`. The SCF's closures are not
        differentiable: the differentiable form costs its SCF 28-37 % more
        wall time on the card (``scripts/bench_response.py``, PERF.md §6)."""
        points, weights = self._grid
        if self._xc_streams:
            return make_xc_fn_streaming(self.mol, points, weights, self.xc,
                                        chunk=chunk or STREAM_CHUNK, dtype=dtype,
                                        differentiable=differentiable, coords=self.coords)
        ao, ao_grad = self._ao_tables
        return make_xc_fn(ao.to(dtype), ao_grad.to(dtype), weights.to(dtype), self.xc,
                          chunk=chunk or TABLE_CHUNK, differentiable=differentiable)

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
        ERI supermatrices ``eri_j``/``eri_k``
        (``nbed_tpu/scf/engine.py:462-479``)."""
        f32 = torch.float32
        eri_j, eri_k = self.eri_j.to(f32).contiguous(), self.eri_k.to(f32).contiguous()
        jk = prepare_jk(eri_j, eri_k)
        return {
            "hcore": self.hcore.to(f32), "s": self.s.to(f32), "eri_j": eri_j, "eri_k": eri_k,
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
        fold, chunk = self._k_fold, self._df_chunk_elems
        return lambda dm: (_df_j(b32, dm[0] + dm[1]),
                           _df_k_folded(dm, b32, b32_lr, chunk, fold))

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
        device = _card(self.device)  # "cuda" and "cuda:0" alike
        for ia, z in enumerate(self.mol.atom_charges):
            blk = _atomic_density(Z_TO_SYMBOL[int(z)], self.mol.basis, str(device),
                                  self.jit_kernel)
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
        return self._jk_function(_spinify(dm))

    @cached_property
    def _jk_function(self):
        """``dm (2, n, n) -> (J, K)`` of :meth:`get_jk`, a closure over the
        operators alone: the engine's graphs hold it, and a reference back
        to the engine would keep a dropped engine, its graphs and their
        device memory alive until the cyclic garbage collector runs."""
        if not self.density_fitting:
            jk = self._jk_exact
            return lambda dm: jk(dm.contiguous())
        b, b_lr = self.df_factor(), None if self._rsh is None else self.df_factor_lr()
        fold = self._k_fold
        chunk = self._df_chunk_elems
        return lambda dm: (_df_j(b, dm[0] + dm[1]), _df_k_folded(dm, b, b_lr, chunk, fold))

    @property
    def _k_fold(self):
        """(hyb, beta) of the folded exchange hyb*K + beta*K_LR, or None
        without range separation."""
        return None if self._rsh is None else (self._xc_meta[1], self._rsh[0])

    def _df_k(self, dm):
        """(2, n, n) DF exchange of a spin density pair from the engine's
        factors, folded under range separation
        (``nbed_tpu/scf/engine.py:596-607``)."""
        b_lr = None if self._rsh is None else self.df_factor_lr()
        return _df_k_folded(dm, self.df_factor(), b_lr, self._df_chunk_elems, self._k_fold)

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

    # ------------------------------------------------------ graphed programs
    def _takes_graphs(self, inputs) -> bool:
        """Whether a call with tensors ``inputs`` runs as graphed programs
        (see ``jit_kernel``)."""
        if self.jit_kernel == "off":
            return False
        differentiable = any(carries_derivative(t) for t in inputs)
        if self.jit_kernel == "on":
            if differentiable:
                raise ValueError("jit_kernel='on' takes no input that carries requires_grad "
                                 "or a forward-mode tangent; use 'auto' or 'off'")
            return True
        return self.device.type == "cuda" and not differentiable

    def _dispatch_chunk(self, total: int) -> Optional[int]:
        """SCF cycles per graph replay for a ``total``-cycle SCF, or None
        for one replay of all ``total`` cycles (``dispatch_cycles`` 0, or
        K >= total)."""
        k = DISPATCH_CYCLES if self.dispatch_cycles is None else int(self.dispatch_cycles)
        return k if 0 < k < total else None

    @cached_property
    def _jit_spec(self) -> tuple:
        """The structure that keys shared programs (the reference's
        ``_jit_spec``, ``engine.py:657-670``, less its Pallas switch, which
        the port lacks): atoms, basis, charge, spin, MM charges present,
        method and the options that shape a program. Geometry enters
        through the operator buffers, so conformers and geometry steps of
        one molecule share programs."""
        mol = self.mol
        return (
            tuple(int(z) for z in mol.atom_charges), mol.basis, mol.charge, mol.spin,
            mol.mm_coords is not None,
            self.xc, self.rohf, self.density_fitting, float(self.df_beta),
            self.incremental_jk == "on", int(self.rebase_every),
            self.grid_scheme, tuple(self.grid_size), int(self.grid_level),
            self._df_chunk_elems, float(self._XC_TABLE_LIMIT),
        )

    @property
    def _operand_shapes(self) -> tuple:
        """The operand sizes a program is traced for where JAX would
        retrace: nao, the kept auxiliary functions of the DF factor(s) and
        the grid points (all of which can change with the geometry)."""
        naux = self.df_factor().shape[1] if self.density_fitting else None
        naux_lr = (self.df_factor_lr().shape[1]
                   if self.density_fitting and self._rsh is not None else None)
        points = self._grid[0].shape[0] if self._xc_meta[0] else None
        return self.mol.nao, naux, naux_lr, points

    def _shared_jit(self, kind: str, build, signature: tuple = ()):
        """The shared program of ``kind`` for this engine's structure,
        operand shapes, call ``signature`` and card, from the bounded LRU
        :data:`_JIT_PROGRAM_CACHE` (built by ``build(operands)`` on a miss),
        with this engine's operators in its buffers."""
        card = _card(self.device)
        ops = _operands((self._jit_spec, self._operand_shapes, card))
        prog = _shared_program((kind, self._jit_spec, self._operand_shapes, signature, card),
                               lambda: build(ops))
        ops.fill(self._token, self._operand_sources(prog.needs))
        return prog

    def _operand_sources(self, groups) -> dict:
        """{buffer name: () -> this engine's tensor} of the operator groups
        ``groups``: "f64" (hcore, S, X, J/K and XC operators), "f32" (the
        warm-up's float32 casts, exact J/K), "fast" (the incremental SCF's
        float32 J/K and XC operators)."""
        f32 = torch.float32
        out = {}
        streams = self._xc_streams if self._xc_meta[0] else False

        def xc(suffix, dtype):
            if not self._xc_meta[0]:
                return
            points, weights = self._grid
            if streams:
                out.update(points=lambda: points, atoms=lambda: self._tensor(self.coords))
                out["w" + suffix] = lambda: weights.to(dtype)
            else:
                out["ao" + suffix] = lambda: self._ao_tables[0].to(dtype)
                out["ao_grad" + suffix] = lambda: self._ao_tables[1].to(dtype)
                out["w" + suffix] = lambda: weights.to(dtype)

        if "f64" in groups:
            out.update(hcore=lambda: _stack_spins(self.hcore), s=lambda: self.s,
                       x=lambda: self.x)
            if self.density_fitting:
                out["b"] = self.df_factor
                if self._rsh is not None:
                    out["b_lr"] = self.df_factor_lr
            else:
                out.update(g_j=lambda: self.eri_j, g_k=lambda: self.eri_k)
            xc("", DTYPE)
        if "f32" in groups:
            out.update(hcore32=lambda: _stack_spins(self._f32_ops["hcore"]),
                       s32=lambda: self._f32_ops["s"],
                       x32=lambda: lowdin_x(self._f32_ops["s"]),
                       g_j32=lambda: self._f32_ops["eri_j"], g_k32=lambda: self._f32_ops["eri_k"])
            xc("32", f32)
        if "fast" in groups:
            if self.density_fitting:
                out["b32"] = lambda: self.df_factor().to(f32)
                if self._rsh is not None:
                    out["b_lr32"] = lambda: self.df_factor_lr().to(f32)
            else:
                out.update(g_j32=lambda: self._f32_ops["eri_j"],
                           g_k32=lambda: self._f32_ops["eri_k"])
            xc("32", f32)
        return out

    def _scf_graph(self, dtype, nelec, present, level_shift: float, cycles: int):
        """The shared :class:`_GraphedSCF` of one call signature: ``dtype``
        (the float32 warm-up or the float64 SCF), ``nelec``, which of v_emb,
        dm_env_occ, dm_env_virt are present, the level shift and the cycles
        per replay; with this engine's operators in its buffers."""
        nelec = tuple(int(v) for v in nelec)
        incremental = dtype == DTYPE and self.incremental_jk == "on"
        mol, xc, streams = self.mol, self.xc, self._xc_meta[0] and self._xc_streams
        density_fitting, fold, chunk = self.density_fitting, self._k_fold, self._df_chunk_elems
        hyb, rohf, rebase_every = self.hyb, self.rohf, self.rebase_every
        device = self.device

        def build(ops):
            # the closures read the buffers only: a cached program holds no
            # engine (a dropped engine goes at once, see _Captured.capture)
            needs = ("f64", "fast") if incremental else ("f64",) if dtype == DTYPE else ("f32",)
            ops.fill(self._token, self._operand_sources(needs))
            b = ops.buffers
            sfx = "" if dtype == DTYPE else "32"
            fast = {}
            if incremental:
                fast = dict(jk_fast=_jk_closure(b, "32", density_fitting, fold, chunk),
                            xc_fast=None if not self._xc_meta[0] else
                            _xc_closure(b, "32", mol, xc, streams, torch.float32),
                            rebase_every=rebase_every)
            program = SCFProgram(
                hcore=b["hcore" + sfx], s=b["s" + sfx], x=b["x" + sfx], nelec=nelec,
                jk_fn=_jk_closure(b, sfx, density_fitting and dtype == DTYPE, fold, chunk),
                xc_fn=None if not self._xc_meta[0] else
                _xc_closure(b, sfx, mol, xc, streams, dtype),
                hyb=hyb, huzinaga=present[1], level_shift=level_shift, rohf=rohf,
                failures=eigh_ops.failure_count(device) if device.type == "cuda" else None,
                **fast)
            return _GraphedSCF(program, cycles, ops.pool, ops, needs)

        key = (dtype, nelec, present, float(level_shift), cycles)
        return self._shared_jit("kernel", build, key)

    def _graphed_kernel(self, nelec, v_emb, dm_env_occ, dm_env_virt, dm0, conv_tol,
                        dm_conv_tol, max_cycle, level_shift, warmup, stats):
        """The SCF of :meth:`kernel` as graphed programs: the float32
        warm-up when ``warmup``, then the float64 SCF, incremental where
        ``incremental_jk`` is "on" (the reference's ``_jitted_kernel``,
        ``engine.py:764-851``)."""
        chunk = self._dispatch_chunk(max_cycle)
        cycles = max_cycle if chunk is None else chunk
        present = (v_emb is not None, dm_env_occ is not None, dm_env_virt is not None)
        if warmup:
            f32 = torch.float32

            def cast(t):
                return None if t is None else t.to(f32)

            with span("scf.setup"):
                graph = self._scf_graph(f32, nelec, present, 0.0, cycles)
            warm = graph.run(dict(v_emb=cast(v_emb), dm_env_occ=cast(dm_env_occ),
                                  dm_env_virt=cast(dm_env_virt), dm0=cast(dm0),
                                  conv_tol=1e-4, dm_conv_tol=1e-3, max_cycle=max_cycle), stats)
            stats["warmup_cycles"] = warm.n_iter
            dm0 = warm.dm.to(DTYPE)
        with span("scf.setup"):
            graph = self._scf_graph(DTYPE, nelec, present, level_shift, cycles)
        res = graph.run(dict(v_emb=v_emb, dm_env_occ=dm_env_occ, dm_env_virt=dm_env_virt,
                             dm0=dm0, conv_tol=conv_tol, dm_conv_tol=dm_conv_tol,
                             max_cycle=max_cycle), stats)
        stats["cycles_per_replay"] = cycles
        stats["launches_per_replay"] = graph.launches_per_replay()
        return res

    def _fixed_program(self, kind: str, make):
        """The shared veff or subsystem program: ``make(jk, xc_fn, hcore,
        device)`` over the float64 operator buffers returns (its input and
        output buffers, the function to capture)."""
        mol, xc, streams = self.mol, self.xc, self._xc_meta[0] and self._xc_streams
        density_fitting, fold, chunk = self.density_fitting, self._k_fold, self._df_chunk_elems
        device = self.device

        def build(ops):
            ops.fill(self._token, self._operand_sources(("f64",)))
            b = ops.buffers
            jk = _jk_closure(b, "", density_fitting, fold, chunk)
            xc_fn = None if not self._xc_meta[0] else _xc_closure(b, "", mol, xc, streams, DTYPE)
            buffers, fn = make(jk, xc_fn, b["hcore"][0])
            prog = _FixedProgram(buffers, _Captured(fn, device, ops.pool), ops)
            return prog

        return self._shared_jit(kind, build)

    def _veff_graph(self):
        """The shared ``get_veff`` program (the reference's
        ``_jitted_veff``, ``engine.py:857-870``): buffers "dm", "matrix",
        "e"."""
        n, hyb, veff_math, device = self.mol.nao, self.hyb, self._veff_math, self.device

        def make(jk, xc_fn, _h):
            dm_in = torch.zeros((2, n, n), dtype=DTYPE, device=device)
            out = {"dm": dm_in, "matrix": torch.zeros_like(dm_in),
                   "e": torch.zeros(2, dtype=DTYPE, device=device)}

            def fn():
                j, k = jk(dm_in)
                v = veff_math(dm_in, j, k, xc_fn, hyb)
                out["matrix"].copy_(v.matrix)
                out["e"].copy_(torch.stack([v.ecoul, v.exc]))

            return out, fn

        return self._fixed_program("veff", make)

    def _subsystem_graph(self):
        """The shared subsystem-DFT program: three J/K and XC builds in one
        graph (the reference's ``_jitted_subsys``, ``engine.py:904-937``):
        buffers "dm_act", "dm_env", "e", "v_emb"."""
        n, hyb, veff_math, device = self.mol.nao, self.hyb, self._veff_math, self.device

        def make(jk, xc_fn, h):
            dm_act = torch.zeros((2, n, n), dtype=DTYPE, device=device)
            dm_env = torch.zeros_like(dm_act)
            out = {"dm_act": dm_act, "dm_env": dm_env,
                   "e": torch.zeros(3, dtype=DTYPE, device=device),
                   "v_emb": torch.zeros_like(dm_act)}

            def comp(dm):
                j, k = jk(dm)
                v = veff_math(dm, j, k, xc_fn, hyb)
                return torch.einsum("ij,ji->", h, dm[0] + dm[1]) + v.ecoul + v.exc, v, j

            def fn():
                e_act, v_act, j_act = comp(dm_act)
                e_env, v_env, j_env = comp(dm_env)
                _, v_tot, _ = comp(dm_act + dm_env)
                j_cross = 0.5 * (torch.einsum("ij,ij", dm_act[0] + dm_act[1], j_env)
                                 + torch.einsum("ij,ij", dm_env[0] + dm_env[1], j_act))
                xc_cross = v_tot.exc - v_act.exc - v_env.exc
                out["e"].copy_(torch.stack([e_act, e_env, j_cross + xc_cross]))
                out["v_emb"].copy_(v_tot.matrix - v_act.matrix)

            return out, fn

        return self._fixed_program("subsys", make)

    def get_veff(self, dm) -> VeffResult:
        """J + Vxc - hyb*K with pyscf-compatible energy components; one
        graph replay where ``jit_kernel`` graphs the call."""
        dm = _spinify(self._tensor(dm))
        if self._takes_graphs((dm,)):
            prog = self._veff_graph()
            prog.buffers["dm"].copy_(dm)
            replay(prog.captured, "veff_graph")
            ecoul, exc = prog.buffers["e"].clone()
            return VeffResult(matrix=prog.buffers["matrix"].clone(), ecoul=ecoul, exc=exc)
        j, k = self.get_jk(dm)
        xc_fn, hyb = self._xc
        return self._veff_math(dm, j, k, xc_fn, hyb)

    def subsystem_decomposition(self, dm_act, dm_env):
        """(e_act, e_env, two_e_cross, embedding_potential) of the driver's
        subsystem-DFT stage (``nbed_tpu/scf/engine.py:939-968``); graphed,
        one replay and one host read of the three energies."""
        dm_act, dm_env = _spinify(self._tensor(dm_act)), _spinify(self._tensor(dm_env))
        if self._takes_graphs((dm_act, dm_env)):
            prog = self._subsystem_graph()
            prog.buffers["dm_act"].copy_(dm_act)
            prog.buffers["dm_env"].copy_(dm_env)
            replay(prog.captured, "subsystem_graph")
            e_act, e_env, cross = prog.buffers["e"].tolist()
            RUNS["host_reads"] += 1
            return e_act, e_env, cross, prog.buffers["v_emb"].clone()
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
        """Run SCF; all embedding terms are explicit arguments. Graphed or
        eager as ``jit_kernel`` says; ``last_run`` records which. The guess,
        the operators and the program are the span "scf.setup", the cycles
        "scf.run"."""
        with span("scf.setup"):
            nelec = self.mol.nelec if nelec is None else nelec
            if self.restricted and nelec[0] != nelec[1]:
                raise ValueError("Restricted reporting requires n_alpha == n_beta.")
            xc_fn, hyb = self._xc
            from_guess = False
            if (dm0 is None and self.init_guess == "sad"
                    and tuple(nelec) == tuple(self.mol.nelec) and v_emb is None):
                # full-molecule SCF: seed from atomic densities (embedded SCFs
                # keep the reference's modified-hcore guess)
                dm0 = self._sad_guess()
                from_guess = True
            max_cycle = self.max_cycle if max_cycle is None else max_cycle
            conv_tol = self.conv_tol if conv_tol is None else conv_tol
            dm_conv_tol = self.dm_conv_tol if dm_conv_tol is None else dm_conv_tol
            warmup = self.warmup_f32 and (dm0 is None or from_guess)
            v_emb_t = None if v_emb is None else self._tensor(v_emb)
            graphed = self._takes_graphs((v_emb_t, dm_env_occ, dm_env_virt, dm0))

        def opt(t, dtype=DTYPE):
            return None if t is None else _spinify(self._tensor(t)).to(dtype)

        stats = {"mode": "eager", "replays": 0, "host_reads": 0, "captures": 0,
                 "capture_s": 0.0}
        if graphed:
            stats["mode"] = "graph"
            v2 = v_emb_t if v_emb_t is None or v_emb_t.ndim == 3 else \
                torch.stack([v_emb_t, v_emb_t])
            res = self._graphed_kernel(nelec, v2, opt(dm_env_occ), opt(dm_env_virt), opt(dm0),
                                       conv_tol, dm_conv_tol, int(max_cycle), level_shift,
                                       warmup, stats)
        else:
            with span("scf.run"):
                if warmup:
                    f32 = torch.float32
                    ops = self._f32_ops
                    warm = run_scf(
                        hcore=ops["hcore"], s=ops["s"], jk_fn=ops["jk_fn"], nelec=nelec,
                        v_emb=None if v_emb_t is None else v_emb_t.to(f32),
                        xc_fn=ops["xc_fn"], hyb=ops["hyb"],
                        dm_env_occ=opt(dm_env_occ, f32), dm_env_virt=opt(dm_env_virt, f32),
                        dm0=opt(dm0, f32), conv_tol=1e-4, dm_conv_tol=1e-3,
                        max_cycle=max_cycle, rohf=self.rohf,
                    )
                    stats["warmup_cycles"] = warm.n_iter
                    dm0 = warm.dm.to(DTYPE)
                res = run_scf(
                    hcore=self.hcore, s=self.s, jk_fn=self.get_jk, nelec=nelec,
                    jk_fn_fast=self._jk_fast_fn, xc_fn_fast=self._xc_fast_fn,
                    rebase_every=self.rebase_every, v_emb=v_emb_t, xc_fn=xc_fn, hyb=hyb,
                    dm_env_occ=opt(dm_env_occ), dm_env_virt=opt(dm_env_virt), dm0=opt(dm0),
                    conv_tol=conv_tol, dm_conv_tol=dm_conv_tol, max_cycle=max_cycle,
                    level_shift=level_shift, rohf=self.rohf,
                )
        stats["cycles"] = res.n_iter
        if self.incremental_jk == "on":
            stats["mixed_cycles"] = res.n_mixed
        self.last_run = stats
        RUNS[stats["mode"]] += 1
        for key in ("replays", "host_reads", "captures", "capture_s", "cycles"):
            RUNS[key] += stats[key]
        if not res.converged:
            logger.warning("SCF has NOT converged (%s cycles).", res.n_iter)
        huz = res.huzinaga_op if dm_env_occ is not None else None
        mo_coeff, mo_energy, mo_occ = res.mo_coeff, res.mo_energy, res.mo_occ
        if self.restricted:
            mo_coeff, mo_energy, mo_occ = mo_coeff[0], mo_energy[0], 2.0 * mo_occ[0]
            huz = None if huz is None else huz[0]
        return SCFSolution(
            engine=self,
            nelec=tuple(int(x) for x in nelec),
            mo_coeff=mo_coeff,
            mo_energy=mo_energy,
            mo_occ=mo_occ,
            e_tot=res.e_elec + self.energy_nuc(),
            converged=res.converged,
            v_emb=v_emb_t,
            huzinaga_op=huz,
        )


@dataclass(eq=False)
class SCFSolution:
    """SCF result on the engine's device: unrestricted, or restricted-
    reported (one orbital set; see ``SCFEngine.restricted``). The driver
    edits the MO sets in place when it deletes environment orbitals and
    localizes virtuals."""

    engine: SCFEngine
    nelec: tuple
    mo_coeff: torch.Tensor  # (2, n, k); restricted (n, k)
    mo_energy: torch.Tensor  # (2, k); restricted (k,)
    mo_occ: torch.Tensor  # (2, k) of 0/1; restricted (k,) of 0/2
    e_tot: float
    converged: bool
    v_emb: Optional[torch.Tensor] = None  # (2, n, n)
    huzinaga_op: Optional[torch.Tensor] = None  # (2, n, n); restricted (n, n)

    @property
    def mol(self) -> Molecule:
        return self.engine.mol

    @property
    def restricted(self) -> bool:
        return self.mo_coeff.ndim == 2

    def per_spin(self):
        """(mo_coeff (2, n, k), mo_occ (2, k) of 0/1). A restricted
        solution's one orbital set serves both spins: a doubly occupied
        orbital is occupied in each, a singly occupied one in alpha."""
        if not self.restricted:
            return self.mo_coeff, self.mo_occ
        occ = self.mo_occ
        return (torch.stack([self.mo_coeff, self.mo_coeff]),
                torch.stack([(occ > 0.9).to(occ.dtype), (occ > 1.9).to(occ.dtype)]))

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
        """(2, n, n) per-spin density; restricted: the (n, n) total."""
        if self.restricted:
            c = self.mo_coeff
            return torch.einsum("pi,i,qi->pq", c, self.mo_occ, c)
        return make_rdm1(self.mo_coeff, self.mo_occ)

    def get_fock(self):
        """Fock matrix (incl. v_emb and the Huzinaga term) at the current
        density: (2, n, n), or (n, n) for a restricted solution."""
        veff = self.engine.get_veff(self.make_rdm1())
        h = self.get_hcore()
        if h.ndim == 2:
            h = h[None]
        f = h + veff.matrix
        if self.huzinaga_op is not None:
            huz = self.huzinaga_op
            f = f + (huz[None] if huz.ndim == 2 else huz)
        return f[0] if self.restricted else f

    def energy_nuc(self) -> float:
        return self.engine.energy_nuc()

    def energy_elec(self, dm=None):
        """(e_elec, e_2) at the given (default: current) density, with v_emb
        folded into the one-body term; e_2 is the Coulomb+exchange energy for
        HF and ecoul + exc for KS, as PySCF reports them."""
        dm = _spinify(self.engine._tensor(self.make_rdm1() if dm is None else dm))
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
        occupied orbitals (both spins' for a restricted solution)."""
        c, occ = self.per_spin()
        ca = c[0][:, occ[0] > 0.5]
        cb = c[1][:, occ[1] > 0.5]
        ovlp = ca.T @ self.engine.s @ cb
        na, nb = ovlp.shape
        sz = 0.5 * (na - nb)
        s2 = sz * (sz + 1.0) + nb - float(torch.sum(ovlp * ovlp))
        return s2, 2.0 * (s2 + 0.25) ** 0.5


def _lanes_take_graphs(jit_kernel: str, tensors, inputs, use_diis: bool,
                       tangent: bool = False) -> bool:
    """Whether a lane call runs as a program of the cache: "on", or "auto"
    on one CUDA device (:func:`~nbed_tpu_torch.ops.programs.takes_program`:
    never with inputs that require grad, and with forward-mode tangents
    only where the call has a ``tangent`` program); not without DIIS or over
    several devices, which run eagerly under "auto" and are refused under
    "on" (and under "auto" on a card for a ``tangent`` call, which has no
    eager route there)."""
    everything = [*tensors, *(t for t in inputs if t is not None)]
    if not takes_program(jit_kernel, everything, tangent=tangent):
        return False
    devices = {t.device for t in everything}
    if not use_diis or len(devices) != 1:
        if jit_kernel == "on" or tangent:
            raise ValueError(f"jit_kernel={jit_kernel!r} runs the lane program with DIIS on one "
                             "device; use 'off' for use_diis=False or operands on "
                             f"{len(devices)} devices")
        return False
    return True


def lane_scf(spec: tuple, operands: dict, build, *, nelec, hyb: float = 1.0, v_emb=None,
             dm_env_occ=None, dm_env_virt=None, dm0=None, conv_tol: float = 1e-6,
             dm_conv_tol: float = 1e-6, max_cycle: int = 50, level_shift: float = 0.0,
             grad_cycles: int = 0, diis_space: int = 8, use_diis: bool = True,
             jit_kernel: str = "auto", dispatch_cycles: Optional[int] = None):
    """The SCF of B lanes (:func:`nbed_tpu_torch.scf.hf.run_scf` over a lane
    axis) as a shared program of :data:`_JIT_PROGRAM_CACHE`: the batched
    energies, gradients and Hessians, the embedding program's primal lanes
    and ``hf_gradient``'s SCF (the reference's ``jax.jit(jax.vmap(...))``).

    ``operands``: "hcore" (B, n, n) or (B, 2, n, n), "s" (B, n, n) and the
    tensors ``build`` reads; ``build(tensors) -> (jk_fn, xc_fn)`` gives the
    lane closures over (B, 2, n, n) densities of any such dict, and must
    hold nothing else (it is called once on the program's own buffers).
    ``spec`` names the structure and the closures' constants (the lanes'
    ``_jit_spec``): programs are keyed by (spec, operand shapes, call
    signature), so every call of one structure and B shares one program and
    its graphs; each call copies its operators into the program's buffers.

    ``jit_kernel`` as ``SCFEngine``'s: "auto" runs the program on a CUDA
    device and :func:`run_scf` on the closures over ``operands`` elsewhere,
    "on" the program everywhere (uncaptured off CUDA), "off" ``run_scf``.
    Operands or inputs that carry forward-mode tangents take a tangent
    lane program (:class:`~nbed_tpu_torch.scf.hf.TangentSCFProgram`, its
    operators' primals and tangents copied into the buffers; ``build`` is
    then called on dual views of them inside every body, and its J/K must
    find the :class:`~nbed_tpu_torch.ops.jk.TangentJK` the program
    prepares) and return dual results. Inputs that require grad,
    ``use_diis=False`` and operands on several devices run ``run_scf``
    under "auto" and raise under "on" (a tangent call on a card raises).
    ``dispatch_cycles`` as ``SCFEngine``'s.
    Returns the lanes' :class:`~nbed_tpu_torch.scf.hf.SCFResult`."""
    hcore = operands["hcore"]
    tensors = dict(operands, hcore=_stack_spins(hcore) if hcore.ndim == 3 else hcore)
    if v_emb is not None and v_emb.ndim == 3:
        v_emb = _stack_spins(v_emb)
    scf_kw = dict(nelec=nelec, hyb=hyb, v_emb=v_emb, dm_env_occ=dm_env_occ,
                  dm_env_virt=dm_env_virt, dm0=dm0, conv_tol=conv_tol,
                  dm_conv_tol=dm_conv_tol, max_cycle=max_cycle, level_shift=level_shift,
                  grad_cycles=grad_cycles, diis_space=diis_space)
    inputs = (v_emb, dm_env_occ, dm_env_virt, dm0)
    tangent = any(has_tangent(t) for t in (*tensors.values(), *inputs))
    if not _lanes_take_graphs(jit_kernel, tensors.values(), inputs, use_diis, tangent):
        jk_fn, xc_fn = build(operands)
        RUNS["lanes_eager"] += 1
        return run_scf(hcore=hcore, s=operands["s"], jk_fn=jk_fn, xc_fn=xc_fn,
                       use_diis=use_diis, **scf_kw)
    s = tensors["s"]
    tensors["x"] = lowdin_x(s)
    k = DISPATCH_CYCLES if dispatch_cycles is None else int(dispatch_cycles)
    cycles = k if 0 < k < max_cycle else int(max_cycle)
    nelec = tuple(int(v) for v in nelec)
    present = (v_emb is not None, dm_env_occ is not None, dm_env_virt is not None)
    shapes = tuple(sorted((name, tuple(t.shape), str(t.dtype)) for name, t in tensors.items()))
    device = _card(s.device)
    route = ("tangent",) if tangent else ()
    ops = _operands(("lanes", spec, shapes, device, *route))
    failures = eigh_ops.failure_count(device) if device.type == "cuda" else None

    def make():
        b = ops.buffers
        if tangent:
            program = TangentSCFProgram(
                operands={name: (b[name], b[name + "_dot"]) for name in tensors}, build=build,
                nelec=nelec, hyb=hyb, huzinaga=present[1], level_shift=level_shift,
                diis_space=diis_space, grad_cycles=grad_cycles, failures=failures)
            return _GraphedSCF(program, cycles, ops.pool, ops)
        jk_fn, xc_fn = build(b)
        program = SCFProgram(
            hcore=b["hcore"], s=b["s"], x=b["x"], nelec=nelec, jk_fn=jk_fn, xc_fn=xc_fn,
            hyb=hyb, huzinaga=present[1], level_shift=level_shift, diis_space=diis_space,
            lanes=True, grad_cycles=grad_cycles, failures=failures)
        return _GraphedSCF(program, cycles, ops.pool, ops)

    owner = next(_OWNERS)  # a lane call's operators are its own
    sources = {name: (lambda t=t: t) for name, t in tensors.items()}
    if tangent:  # the primal and the tangent of every operator
        sources.update({name + "_dot": (lambda t=t: _tangent_of(t))
                        for name, t in tensors.items()})
    ops.fill(owner, sources)
    graph = _shared_program(
        ("lanes", spec, shapes, (nelec, present, float(level_shift), cycles,
                                 int(grad_cycles), float(hyb), int(diis_space)), device,
         *route),
        make)
    stats = {"replays": 0, "host_reads": 0, "captures": 0, "capture_s": 0.0}
    res = graph.run(dict(v_emb=v_emb, dm_env_occ=dm_env_occ, dm_env_virt=dm_env_virt,
                         dm0=None if dm0 is None else dm0.to(s.dtype),
                         conv_tol=conv_tol, dm_conv_tol=dm_conv_tol, max_cycle=max_cycle),
                    stats)
    RUNS["lanes_tangent" if tangent else "lanes_graph"] += 1
    for key, value in stats.items():
        RUNS[key] += value
    return res


def _tangent_of(t):
    """The forward-mode tangent of ``t`` (zeros where it has none)."""
    tangent = forward_ad.unpack_dual(t).tangent
    return torch.zeros_like(t) if tangent is None else tangent


def lane_spec(mol: Molecule, tag: str, *extra) -> tuple:
    """The structure key of a lane program: ``mol``'s atoms, basis, charge,
    spin and MM charges (the fields of ``SCFEngine._jit_spec`` that a
    molecule sets), the closures' kind ``tag`` and their constants."""
    return (tuple(int(z) for z in mol.atom_charges), mol.basis, mol.charge, mol.spin,
            mol.mm_coords is not None, tag, *extra)


def single_scf(spec: tuple, operands: dict, build, *, jit_kernel: str = "auto",
               use_diis: bool = True, **scf_kw):
    """One geometry's SCF as a program of the cache: :func:`lane_scf` of one
    lane. ``operands`` as there with "hcore" (n, n) or (2, n, n) and "s"
    (n, n); ``build`` gives single-geometry closures. Where the call does
    not take a program (see :func:`lane_scf`), :func:`run_scf` on the
    closures over ``operands``. Returns a single-geometry
    :class:`~nbed_tpu_torch.scf.hf.SCFResult`."""
    inputs = tuple(scf_kw.get(k) for k in ("v_emb", "dm_env_occ", "dm_env_virt", "dm0"))
    if not _lanes_take_graphs(jit_kernel, operands.values(), inputs, use_diis):
        jk_fn, xc_fn = build(operands)
        RUNS["lanes_eager"] += 1
        return run_scf(hcore=operands["hcore"], s=operands["s"], jk_fn=jk_fn, xc_fn=xc_fn,
                       use_diis=use_diis, **scf_kw)

    def lane_build(t):
        jk_fn, xc_fn = build(dict(t, hcore=t["hcore"][0], s=t["s"][0]))
        return _one_lane(jk_fn), _one_lane(xc_fn)

    for key in ("v_emb", "dm_env_occ", "dm_env_virt", "dm0"):
        if scf_kw.get(key) is not None:
            scf_kw[key] = scf_kw[key][None]
    return _first_lane(lane_scf(
        spec, dict(operands, hcore=operands["hcore"][None], s=operands["s"][None]),
        lane_build, jit_kernel=jit_kernel, **scf_kw))
