"""Spin-generic SCF with DIIS (port of ``nbed_tpu/scf/hf.py``).

Density matrices carry a leading spin axis ``(2, n, n)``; the DIIS history
is a fixed ring buffer, as in the reference. The reference's
``lax.while_loop`` becomes a Python loop whose convergence test reads two
scalars back to the host each cycle. One J/K build per cycle goes through
the ``jk_fn`` hook (the engine passes the fused J/K kernel of
:mod:`nbed_tpu_torch.ops.jk`).

``rohf=True`` runs ROHF/ROKS: Roothaan's single effective Fock replaces the
per-spin pair before the DIIS error and the diagonalisation, so both spins
share spatial orbitals; energies still come from the per-spin Fock.

Mixed precision (``jk_fn_fast``, ``xc_fn_fast``): the incremental loop
contracts each cycle's density *change* in float32 and adds it to the
float64 J/K of the previous cycle, rebuilding J/K in float64 every
``rebase_every`` cycles; coarse cycles may take float32 XC. A short
float64 polish loop then lands on the float64 fixed point
(``nbed_tpu/scf/hf.py:299-429``). The reference's ``lax.cond`` branches
become a per-cycle choice of cycle variant from the cycle's host read (or
``torch.where`` over both builds, see :func:`_lane_ops`).

Lanes: an ``s`` of shape (B, n, n) runs B SCFs at once (a batch of
conformers), the reference's ``vmap`` of its ``while_loop``. Every operator
and the DIIS history carry the lane axis, the Fock diagonalisation and the
DIIS solve are batched eigh calls (:func:`scf_eigh`), and the loop reads
one (B,) convergence tensor per cycle. A converged lane is frozen: as the
vmapped loop selects the old carry where a lane's condition is false, each
cycle's update is taken only on the lanes still running, so lane b ends
where the same geometry run alone ends, in the same number of cycles. The
lane form takes the float64 operators of HF, KS and Huzinaga SCFs; ROHF
and the mixed precision modes run over lanes for one geometry only.

One cycle of the lane form is a function of device state alone
(:func:`_lane_ops`): the DIIS slot, the fill count, the cycle counter and
the convergence test are device tensors, and the cycle reads nothing back
to the host. The lane loop reads its (B,) convergence tensor after each
cycle; :class:`SCFProgram` runs the same cycle on fixed buffers, K cycles
at a time, which is what the engine captures as CUDA graphs
(``SCFEngine(jit_kernel=...)`` and the lane programs of
:func:`nbed_tpu_torch.scf.engine.lane_scf`, the port of the reference's
compiled programs). Every SCF of the port runs this one cycle: a
single-geometry :func:`run_scf`, float64, float32 or incremental, eager or
not, runs the lane loop over one lane, so that it takes the programs'
iterates (float32 rounding compounds over the cycles). A one-lane DIIS
solve drops its lane axis, so that one geometry rounds as the reference's
single-geometry loop does (:func:`_diis_extrapolate`).

``grad_cycles`` (``nbed_tpu/scf/hf.py:431-455``) adds that many DIIS-free
cycles, damped by 0.5, after a converged loop: a no-op on the converged
density, which lets forward-mode tangents (``torch.autograd.forward_ad``)
settle on the implicit-function derivative. The DIIS mixing coefficients
are detached, as the reference stops their gradient: at the fixed point
they carry no derivative, and differentiating the ``eigh`` of the padded
DIIS matrix, whose empty slots are degenerate, makes every tangent NaN.

Not ported: the TPU-only Newton refinement of ``eigh`` (a no-op off the TPU,
``hf.py:63-66``).
"""

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch
from torch.autograd import forward_ad

from ..ops import eigh as eigh_ops
from ..ops.jk import prepare_jk
from ..ops.programs import dual_scope, write_dual

__all__ = ["SCFResult", "SCFProgram", "TangentSCFProgram", "run_scf", "make_rdm1",
           "lowdin_x", "huzinaga_operator"]


@dataclass
class SCFResult:
    """Converged SCF data (always spin-resolved). A lane run's result has a
    lane axis in front of every tensor, and ``e_elec`` (B,), ``converged``
    (B,) and ``n_iter`` (B,) are tensors."""

    mo_coeff: torch.Tensor  # (2, n, n)
    mo_energy: torch.Tensor  # (2, n)
    mo_occ: torch.Tensor  # (2, n) of 0/1 (electrons per spin orbital)
    dm: torch.Tensor  # (2, n, n)
    e_elec: float  # electronic energy (add nuclear repulsion for e_tot)
    converged: bool
    fock: torch.Tensor  # (2, n, n) final Fock (incl. v_emb + huzinaga)
    huzinaga_op: torch.Tensor  # (2, n, n) final Huzinaga operator (zeros if off)
    n_iter: int
    n_mixed: int = 0  # of n_iter, the incremental mixed loop's cycles (0 without one)


def make_rdm1(mo_coeff, mo_occ):
    """D_sigma = C diag(occ) C^T with 0/1 spin-orbital occupations; leading
    lane axes ride along."""
    return torch.einsum("...spi,...si,...sqi->...spq", mo_coeff, mo_occ, mo_coeff)


def lowdin_x(s):
    """S^{-1/2} via eigh, of (n, n) or (B, n, n), one matrix at a time (a
    batched eigh rounds differently, and a float32 SCF from another X
    takes other cycles)."""
    if s.ndim == 3:
        return torch.stack([lowdin_x(m) for m in s])
    w, v = torch.linalg.eigh(s)
    return (v * (1.0 / torch.sqrt(w))[..., None, :]) @ v.transpose(-1, -2)


def huzinaga_operator(fock, dm_occ_s, dm_virt_s):
    """-(F D S + S D F) per spin, plus the virtual-space variant
    (``nbed_tpu/scf/hf.py:91-106``); leading lane axes ride along."""
    fds_occ = torch.einsum("...sij,...sjk->...sik", fock, dm_occ_s)
    huz = -(fds_occ + fds_occ.transpose(-1, -2))
    fds_virt = torch.einsum("...sij,...sjk->...sik", fock, dm_virt_s)
    huz_virt = -(
        fds_virt
        + fds_virt.transpose(-1, -2)
        - 2.0 * torch.einsum("...sij,...sjk->...sik", dm_virt_s.transpose(-1, -2), fds_virt)
    )
    return huz + huz_virt


def roothaan_effective(f, dm, s):
    """Roothaan's effective Fock for ROHF/ROKS, stacked on the spin axis
    (``nbed_tpu/scf/hf.py:232-247``). Projector form with closed = beta
    occupied, open = alpha minus beta, virtual = alpha unoccupied: the
    diagonal blocks couple through (Fa+Fb)/2, closed-open through Fb,
    open-virtual through Fa, closed-virtual through (Fa+Fb)/2. Leading lane
    axes ride along: f, dm ([B,] 2, n, n), s ([B,] n, n)."""
    n = s.shape[-1]

    def t(a):
        return a.transpose(-1, -2)

    fa, fb = f[..., 0, :, :], f[..., 1, :, :]
    da, db = dm[..., 0, :, :], dm[..., 1, :, :]
    fc = 0.5 * (fa + fb)
    pc = db @ s
    po = (da - db) @ s
    pv = torch.eye(n, dtype=f.dtype, device=f.device) - da @ s
    feff = (0.5 * (t(pc) @ fc @ pc + t(po) @ fc @ po + t(pv) @ fc @ pv)
            + t(po) @ fb @ pc + t(po) @ fa @ pv + t(pv) @ fc @ pc)
    feff = feff + t(feff)
    return torch.stack([feff, feff], dim=-3)


def _diis_extrapolate(hist_f, hist_e, nfill, eigh=torch.linalg.eigh, count=None):
    """Pulay extrapolation of the history Focks ([B,] m, 2, n, n) over the
    ``nfill`` (an int or a device integer) filled slots of the ring buffer,
    with the reference's eigh pseudo-inverse and relative cut
    (``hf.py:260-292``), per lane; ``eigh`` solves the padded system (with
    ``count``, the (B,) lanes whose solver failures count, and a retry of
    failed solves, where given).
    The coefficients come from the detached errors, so no derivative
    reaches them."""
    if hist_e.ndim == 5 and hist_e.shape[0] == 1:
        # one lane is solved without its lane axis, as the reference's
        # single-geometry SCF solves it: the batched products round
        # otherwise, and on water that rounding flips the signs of
        # orbitals, which the Jacobi-sweep localizers follow (IBO's
        # embedded energies moved by 7e-8 Ha)
        return _diis_extrapolate(hist_f[0], hist_e[0], nfill, eigh, count)[None]
    hist_e = hist_e.detach()
    m = hist_e.shape[-4]
    lead = tuple(hist_e.shape[:-4])
    dtype, device = hist_e.dtype, hist_e.device
    flat_e = hist_e.reshape(*lead, m, -1)
    b = flat_e @ flat_e.transpose(-1, -2)
    filled = (torch.arange(m, device=device) < nfill).to(dtype)
    b = b * (filled[:, None] * filled[None, :]) + torch.diag(1.0 - filled)
    big = torch.zeros((*lead, m + 1, m + 1), dtype=dtype, device=device)
    big[..., :m, :m] = b
    big[..., :m, m] = filled
    big[..., m, :m] = filled
    # e_m, built on the device (a host scalar written into a device tensor
    # is a copy that a CUDA graph capture refuses)
    rhs = (torch.arange(m + 1, device=device) == m).to(dtype)
    # the lane SCFs' eigh retries a failed solve shifted (a nearly converged
    # SCF's DIIS system: see nbed_tpu_torch.ops.eigh.eigh_retry)
    ew, ev = eigh(big) if count is None else eigh(big, count, retry=True)
    cut = torch.amax(torch.abs(ew), dim=-1, keepdim=True) * max(
        1e-12, (m + 1) * torch.finfo(dtype).eps)
    inv_ew = torch.where(torch.abs(ew) > cut, 1.0 / ew, torch.zeros_like(ew))
    proj = ev.transpose(-1, -2) @ rhs
    if lead:  # a column per lane
        proj = proj[..., None]
    coef = ((ev * inv_ew[..., None, :]) @ proj).reshape(*lead, m + 1)[..., :m] * filled
    return torch.einsum("...h,...hsij->...sij", coef, hist_f)


def run_scf(
    *,
    hcore,  # (n, n) or (2, n, n)
    s,  # (n, n)
    nelec,  # (n_alpha, n_beta)
    eri_j=None,  # (n*n, n*n) supermatrix for J: (ij|kl)
    eri_k=None,  # (n*n, n*n) supermatrix for K: (ik|jl)
    jk_fn: Optional[Callable] = None,  # dm (2,n,n) -> (j (n,n), k (2,n,n))
    jk_fn_fast: Optional[Callable] = None,  # float32 J/K of density changes
    rebase_every: int = 8,  # full-precision J/K rebuild period (incremental)
    xc_fn_fast: Optional[Callable] = None,  # float32 XC for coarse cycles
    xc_switch_tol: float = 1e-4,  # |dDM| below which the loop's XC is f64
    v_emb=None,  # (2, n, n) embedding potential added to hcore
    xc_fn: Optional[Callable] = None,  # dm -> (exc, vxc (2,n,n))
    hyb: float = 1.0,  # HF-exchange fraction (1.0 = HF, 0.2 = B3LYP)
    dm_env_occ=None,  # (2, n, n) Huzinaga occupied env density (per spin)
    dm_env_virt=None,  # (2, n, n) Huzinaga virtual env density (per spin)
    dm0=None,  # (2, n, n) initial guess
    conv_tol: float = 1e-6,
    dm_conv_tol: float = 1e-6,
    max_cycle: int = 50,
    diis_space: int = 8,  # Pulay history length
    level_shift: float = 0.0,  # virtual-orbital level shift (Ha)
    rohf: bool = False,  # restricted open shell: shared spatial orbitals
    use_diis: bool = True,  # False: plain Roothaan iterations
    grad_cycles: int = 0,  # damped DIIS-free cycles after convergence (tangents)
) -> SCFResult:
    """Run SCF to convergence.

    Fock matrix: ``F_s = hcore + v_emb + J(D_tot) + Vxc_s - hyb*K(D_s)
    + Huz(F)``; energies follow the reference's embedded conventions (the
    Huzinaga term enters the one-body energy in full, ``v_emb`` is part of
    the core Hamiltonian). The loop runs in the dtype of the operators:
    float32 operators give the mixed-precision warm-up. One geometry runs
    as one lane of the lane loop (the cycle of :func:`_lane_ops`, which the
    graphed programs run), and its result is returned without the lane
    axis, ``e_elec`` a float, ``converged`` a bool and ``n_iter`` an int.

    J and K come from ``jk_fn``, or, where it is None, from the
    supermatrices ``eri_j`` and ``eri_k`` through the fused J/K kernel
    (its plain version on the CPU), as the reference's default ``get_jk``
    contracts them (``nbed_tpu/scf/hf.py:190-199``).

    With ``jk_fn_fast`` each cycle takes ``J(D) = J(D_ref) + J32(D -
    D_ref)`` (likewise K), D_ref the previous cycle's density, and every
    ``rebase_every``-th cycle (the first included) builds J/K in full with
    ``jk_fn``. With ``xc_fn_fast`` a cycle whose previous density change
    exceeded ``xc_switch_tol`` evaluates XC in float32. Either option ends
    with a pure full-precision polish loop from the mixed loop's density,
    which sets the returned convergence flag; ``n_iter`` counts both loops.

    An ``s`` of shape (B, n, n) runs B lanes (see the module docstring):
    ``hcore`` (B, n, n) or (B, 2, n, n), ``v_emb``, ``dm_env_*`` and ``dm0``
    (B, 2, n, n), ``jk_fn`` maps (B, 2, n, n) densities to (J (B, n, n),
    K (B, 2, n, n)) and ``xc_fn`` to (exc (B,), vxc (B, 2, n, n)).
    """
    if jk_fn is None:
        if eri_j is None or eri_k is None:
            raise ValueError("run_scf needs jk_fn, or both eri_j and eri_k")
        if s.ndim == 3:
            raise ValueError("run_scf over lanes takes jk_fn, not supermatrices")
        fused = prepare_jk(eri_j.contiguous(), eri_k.contiguous())

        def jk_fn(dm):
            return fused(dm.contiguous())
    if s.ndim == 3:
        if rohf or jk_fn_fast is not None or xc_fn_fast is not None:
            raise ValueError("run_scf over lanes takes neither rohf nor the mixed-precision "
                             "options")
        return _run_scf_lanes(
            hcore=hcore, s=s, nelec=nelec, jk_fn=jk_fn, v_emb=v_emb, xc_fn=xc_fn, hyb=hyb,
            dm_env_occ=dm_env_occ, dm_env_virt=dm_env_virt, dm0=dm0, conv_tol=conv_tol,
            dm_conv_tol=dm_conv_tol, max_cycle=max_cycle, diis_space=diis_space,
            level_shift=level_shift, use_diis=use_diis, grad_cycles=grad_cycles)
    # one geometry runs as one lane of the cycle the graphed programs run,
    # so that the eager and graphed SCFs take the same iterates (float32
    # rounding compounds over the cycles)
    def lane(t):
        return None if t is None else t[None]

    return _first_lane(_run_scf_lanes(
        hcore=lane(hcore), s=s[None], nelec=nelec, jk_fn=_one_lane(jk_fn),
        v_emb=lane(v_emb), xc_fn=_one_lane(xc_fn), hyb=hyb, dm_env_occ=lane(dm_env_occ),
        dm_env_virt=lane(dm_env_virt), dm0=lane(dm0), conv_tol=conv_tol,
        dm_conv_tol=dm_conv_tol, max_cycle=max_cycle, diis_space=diis_space,
        level_shift=level_shift, use_diis=use_diis, grad_cycles=grad_cycles, rohf=rohf,
        jk_fn_fast=_one_lane(jk_fn_fast), xc_fn_fast=_one_lane(xc_fn_fast),
        rebase_every=rebase_every, xc_switch_tol=xc_switch_tol))


def _one_lane(fn):
    """A single-geometry J/K or XC closure as a lane closure of one lane."""
    if fn is None:
        return None

    def lane_fn(dm):
        a, b = fn(dm[0])
        return a.reshape((1,) + tuple(a.shape)), b[None]

    return lane_fn


def _first_lane(res: "SCFResult") -> "SCFResult":
    """The single-geometry :class:`SCFResult` of a one-lane result (one
    host read of the energy, flag and counts)."""
    e_elec, conv, n_iter = torch.stack([res.e_elec[0].detach().to(torch.float64),
                                        res.converged[0].to(torch.float64),
                                        res.n_iter[0].to(torch.float64)]).tolist()
    return SCFResult(mo_coeff=res.mo_coeff[0], mo_energy=res.mo_energy[0],
                     mo_occ=res.mo_occ[0], dm=res.dm[0], e_elec=e_elec, converged=bool(conv),
                     fock=res.fock[0], huzinaga_op=res.huzinaga_op[0], n_iter=int(n_iter),
                     n_mixed=int(res.n_mixed))


def carries_derivative(t) -> bool:
    """Whether ``t`` is a tensor that autograd follows or a forward-mode
    dual tensor."""
    if not isinstance(t, torch.Tensor):
        return False
    from torch.autograd import forward_ad

    return t.requires_grad or forward_ad.unpack_dual(t).tangent is not None


# whether the eager route diagonalises a matrix that carries a forward-mode
# tangent as the tangent programs do (eigh_jvp), not with torch.linalg.eigh:
# a private switch for holding a graph against an eager run of the same
# arithmetic on the card, where the embedding program's 1e6 mu shift turns
# two eigensolvers' rounding into energy differences above the graph's
# gate and other SCF cycle counts
_EAGER_EIGH_JVP = False


def scf_eigh(a, count=None, retry: bool = False, program: bool = False):
    """The lane SCF's eigh, graphed and eager: the capturable cuSOLVER call
    of :func:`nbed_tpu_torch.ops.eigh.eigh` (``eigh_retry`` with ``retry``;
    ``torch.linalg.eigh`` on the CPU). A matrix that carries a derivative
    takes ``torch.linalg.eigh`` on the eager route, and inside a tangent
    program (``program``) the same cuSOLVER call with its forward-mode rule
    (:func:`nbed_tpu_torch.ops.eigh.eigh_jvp`), which a graph captures.
    ``count`` as there."""
    if carries_derivative(a):
        if program or _EAGER_EIGH_JVP:
            return eigh_ops.eigh_jvp(a, count, retry)
        return torch.linalg.eigh(a)
    return (eigh_ops.eigh_retry if retry else eigh_ops.eigh)(a, count)


def _lane_ops(*, h_eff, s, x, occ, jk_fn, xc_fn, hyb, dm_occ_s=None, dm_virt_s=None,
              level_shift=0.0, rohf=False, use_diis=True, diis_space=8,
              eigh=None, jk_fast=None, xc_fast=None, rebase_every=8,
              xc_switch_tol=1e-4):
    """(assemble_fock, eig_fock, cycle, grad_step) of an SCF over a leading
    lane axis: ``h_eff`` (B, 2, n, n), ``s`` and ``x`` (B, n, n), ``occ``
    (B, 2, n), ``jk_fn`` and ``xc_fn`` over (B, 2, n, n) densities, the
    Huzinaga products ``dm_occ_s``/``dm_virt_s`` (B, 2, n, n) or None, and
    ``eigh`` for the Fock diagonalisation and the DIIS solve.

    ``cycle(st, conv_tol, dm_conv_tol, max_cycle, variant=None)`` is one SCF
    cycle of the state ``st`` (:func:`_initial_state`) and returns the next
    state. It reads nothing back to the host: the DIIS slot and fill count
    follow the device counter ``it``, the extrapolation is selected from
    cycle 1 on by ``torch.where``, and a lane that has converged, or has run
    ``max_cycle`` cycles (an int or a device integer), keeps its state, as
    the reference's vmapped loop selects the old carry.

    With ``jk_fast`` (float32 J/K of a density change) a ``variant`` =
    (rebase, xc32) makes the cycle one of the incremental loop's
    (``nbed_tpu/scf/hf.py:302-389``): J/K in full with ``jk_fn`` (``rebase``
    True), or the float32 contraction of the change since the previous
    cycle added to that cycle's J/K (False); the float32 XC ``xc_fast``
    (``xc32`` True) or ``xc_fn`` (False). None selects on the device, as the
    reference's ``lax.cond`` does, from ``it % rebase_every == 0`` and from
    the previous cycle's density change against ``xc_switch_tol``, at the
    cost of both builds. ``variant`` None is the plain cycle.

    ``grad_step(dm, c, mo_e, conv)`` is one damped DIIS-free cycle of the
    lanes in ``conv`` (see ``grad_cycles``). ``eigh(a, count)`` defaults
    to :func:`scf_eigh`."""
    m = diis_space
    eigh = scf_eigh if eigh is None else eigh

    def assemble_fock(dm, j, k, xc=xc_fn):
        """(F incl. huz, huz, e_elec (B,) of dm) from dm and its J/K pair."""
        vhf = j[:, None] - hyb * k
        if xc is not None:
            exc, vxc = xc(dm)
            vhf = vhf + vxc
        else:
            exc = 0.0
        f0 = h_eff + vhf
        if dm_occ_s is not None:
            huz = huzinaga_operator(f0, dm_occ_s, dm_virt_s)
            f = f0 + huz
        else:
            huz = torch.zeros_like(f0)
            f = f0
        e1 = torch.einsum("bsij,bsji->b", h_eff + huz, dm)
        ecoul = 0.5 * torch.einsum("bij,bji->b", j, dm[:, 0] + dm[:, 1])
        ex_hf = -0.5 * hyb * torch.einsum("bsij,bsji->b", k, dm)
        return f, huz, e1 + ecoul + ex_hf + exc

    def eig_fock(f, count=None):
        f_ortho = torch.einsum("bpi,bspq,bqj->bsij", x, f, x)
        if count is None:
            mo_e, c_ortho = eigh(f_ortho)
        else:
            mo_e, c_ortho = eigh(f_ortho, count[:, None].expand(f.shape[:2]))
        return mo_e, torch.einsum("bpi,bsij->bspj", x, c_ortho)

    def xc32(dm):
        exc, vxc = xc_fast(dm.to(torch.float32))
        return exc.to(dm.dtype), vxc.to(dm.dtype)

    def incremental_jk(st, rebase):
        """J/K of the incremental cycle (see ``variant``)."""
        dm = st["dm"]
        if rebase is not False:
            j_full, k_full = jk_fn(dm)
            if rebase:
                return j_full, k_full
        jd, kd = jk_fast((dm - st["dm_ref"]).to(torch.float32))
        j_inc = st["j_ref"] + jd.to(dm.dtype)
        k_inc = st["k_ref"] + kd.to(dm.dtype)
        if rebase is False:
            return j_inc, k_inc
        full = st["it"] % rebase_every == 0
        return torch.where(full, j_full, j_inc), torch.where(full, k_full, k_inc)

    def incremental_xc(st, use32):
        """The XC closure of the incremental cycle (see ``variant``)."""
        if xc_fast is None or xc_fn is None or use32 is False:
            return xc_fn
        if use32:
            return xc32

        def select(dm):
            coarse = st["ddm"] > xc_switch_tol
            e32, v32 = xc32(dm)
            e64, v64 = xc_fn(dm)
            return torch.where(coarse, e32, e64), _take(coarse, v32, v64)

        return select

    def cycle(st, conv_tol, dm_conv_tol, max_cycle, variant=None):
        dm, it = st["dm"], st["it"]
        active = ~st["conv"] & (it < max_cycle)  # the lanes this cycle updates
        if variant is None:
            j, k = jk_fn(dm)
            f, _, e_cur = assemble_fock(dm, j, k)
        else:
            j, k = incremental_jk(st, variant[0])
            f, _, e_cur = assemble_fock(dm, j, k, incremental_xc(st, variant[1]))
        if rohf:
            # the per-spin error of F_eff covers every coupling block:
            # D_beta tests closed-open and closed-virtual, D_alpha
            # open-virtual
            f = roothaan_effective(f, dm, s)
        fds = torch.einsum("bsij,bsjk,bkl->bsil", f, dm, s)
        err = torch.einsum("bpi,bspq,bqj->bsij", x, fds - fds.transpose(-1, -2), x)
        slot = (torch.arange(m, device=it.device) == it % m).reshape(1, m, 1, 1, 1)
        hist_f = torch.where(slot, f[:, None], st["hist_f"])
        hist_e = torch.where(slot, err[:, None], st["hist_e"])
        f_use = f
        # solver failures count on the lanes this cycle updates only: a
        # converged lane's near-zero DIIS errors can keep cuSOLVER's batched
        # eigh from meeting its tolerance, and its results are not taken
        if use_diis:
            f_use = torch.where(it > 0, _diis_extrapolate(
                hist_f, hist_e, torch.clamp(it + 1, max=m), eigh, active), f)
        if level_shift:
            # F' = F + lambda (S - S D_s S) shifts only the virtual
            # eigenvalues, damping occupied<->virtual oscillation
            sds = torch.einsum("bij,bsjk,bkl->bsil", s, dm, s)
            f_use = f_use + level_shift * (s[:, None] - sds)
        mo_e_new, c_new = eig_fock(f_use, active)
        dm_new = make_rdm1(c_new, occ)
        # the test in float64, as the reference's single-geometry loop
        # takes it: float32 loops compare their energy and density changes
        # in float64 too
        e_cur = e_cur.to(st["e"].dtype)
        de = torch.abs(e_cur - st["e"])
        ddm = torch.amax(torch.linalg.matrix_norm(dm_new - dm), dim=-1).to(st["e"].dtype)
        now = (de < conv_tol) & (ddm < dm_conv_tol)
        out = {
            **st,
            "dm": _take(active, dm_new, dm), "e": _take(active, e_cur, st["e"]),
            "c": _take(active, c_new, st["c"]), "mo_e": _take(active, mo_e_new, st["mo_e"]),
            "conv": st["conv"] | (active & now),
            "cycles": st["cycles"] + active.to(st["cycles"].dtype),
            "it": it + 1, "hist_f": hist_f, "hist_e": hist_e,
            "ddm": _take(active, ddm, st["ddm"]),
        }
        if variant is not None:
            out.update(dm_ref=_take(active, dm, st["dm_ref"]),
                       j_ref=_take(active, j, st["j_ref"]), k_ref=_take(active, k, st["k_ref"]))
        return out

    def grad_step(dm, c, mo_e, conv):
        j, k = jk_fn(dm)
        f, _, _ = assemble_fock(dm, j, k)
        mo_e_new, c_new = eig_fock(f)
        return (_take(conv, 0.5 * make_rdm1(c_new, occ) + 0.5 * dm, dm),
                _take(conv, c_new, c), _take(conv, mo_e_new, mo_e))

    return assemble_fock, eig_fock, cycle, grad_step


def _take(mask, new, old):
    """``new`` on the lanes of the (B,) ``mask``, ``old`` elsewhere."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _initial_state(dm0, diis_space: int, incremental: bool = False) -> dict:
    """The SCF state of :func:`_lane_ops` at cycle 0 from the (B, 2, n, n)
    density ``dm0``: energies and density changes in float64 whatever the
    loop's dtype; ``incremental`` adds the incremental loop's reference
    density and J/K (cycle 0 rebuilds in full, so their zeros are never
    used)."""
    nb, n = dm0.shape[0], dm0.shape[-1]
    dtype, device = dm0.dtype, dm0.device
    hist = torch.zeros((nb, diis_space, 2, n, n), dtype=dtype, device=device)
    st = {
        "dm": dm0, "e": torch.full((nb,), float("inf"), dtype=torch.float64, device=device),
        "c": torch.zeros((nb, 2, n, n), dtype=dtype, device=device),
        "mo_e": torch.zeros((nb, 2, n), dtype=dtype, device=device),
        "conv": torch.zeros(nb, dtype=torch.bool, device=device),
        "cycles": torch.zeros(nb, dtype=torch.int64, device=device),
        "it": torch.zeros((), dtype=torch.int64, device=device),
        "hist_f": hist, "hist_e": torch.zeros_like(hist),
        "ddm": torch.full((nb,), float("inf"), dtype=torch.float64, device=device),
    }
    if incremental:
        st.update(dm_ref=torch.zeros_like(dm0),
                  j_ref=torch.zeros((nb, n, n), dtype=dtype, device=device),
                  k_ref=torch.zeros_like(dm0))
    return st


def _huzinaga_products(dm_env_occ, dm_env_virt, s):
    """(D_occ S, D_virt S) per lane and spin; zeros for an absent D_virt."""
    dm_occ_s = torch.einsum("bsij,bjk->bsik", dm_env_occ, s)
    dm_virt_s = (torch.zeros_like(dm_occ_s) if dm_env_virt is None
                 else torch.einsum("bsij,bjk->bsik", dm_env_virt, s))
    return dm_occ_s, dm_virt_s


def _occupations(nelec, nb: int, n: int, dtype, device):
    ar = torch.arange(n, device=device)
    occ = torch.stack([(ar < int(nelec[0])).to(dtype), (ar < int(nelec[1])).to(dtype)])
    return occ.expand(nb, 2, n)


def _restart(st: dict) -> dict:
    """The polish loop's start: ``st``'s density, energy and orbitals with a
    new DIIS history and counters (``SCFProgram.start_polish``)."""
    zero = {key: torch.zeros_like(st[key]) for key in ("hist_f", "hist_e", "conv", "cycles",
                                                        "it")}
    return {**st, **zero, "ddm": torch.full_like(st["ddm"], float("inf"))}


def _run_scf_lanes(*, hcore, s, nelec, jk_fn, v_emb, xc_fn, hyb, dm_env_occ, dm_env_virt,
                   dm0, conv_tol, dm_conv_tol, max_cycle, diis_space, level_shift, use_diis,
                   grad_cycles, rohf=False, jk_fn_fast=None, xc_fn_fast=None,
                   rebase_every=8, xc_switch_tol=1e-4) -> SCFResult:
    """:func:`run_scf` over a leading lane axis (see the module docstring):
    the cycles of :func:`_lane_ops`, with one host read after each. The
    incremental loop (``jk_fn_fast``, ``xc_fn_fast``: one lane) picks each
    cycle's variant from that read, as the graphed program does at one
    cycle per replay, then restarts for the float64 polish."""
    nb, n = s.shape[0], s.shape[-1]
    dtype = s.dtype
    if hcore.ndim == 3:
        hcore = torch.stack([hcore, hcore], dim=1)
    if v_emb is None:
        v_emb = torch.zeros_like(hcore)
    elif v_emb.ndim == 3:
        v_emb = torch.stack([v_emb, v_emb], dim=1)
    x = lowdin_x(s)
    h_eff = hcore + v_emb.to(hcore.dtype)
    dm_occ_s = dm_virt_s = None
    if dm_env_occ is not None:
        dm_occ_s, dm_virt_s = _huzinaga_products(dm_env_occ, dm_env_virt, s)
    occ = _occupations(nelec, nb, n, dtype, s.device)
    mixed = jk_fn_fast is not None or (xc_fn_fast is not None and xc_fn is not None)
    assemble_fock, eig_fock, cycle, grad_step = _lane_ops(
        h_eff=h_eff, s=s, x=x, occ=occ, jk_fn=jk_fn, xc_fn=xc_fn, hyb=hyb, dm_occ_s=dm_occ_s,
        dm_virt_s=dm_virt_s, level_shift=level_shift, rohf=rohf, use_diis=use_diis,
        diis_space=diis_space, eigh=scf_eigh, jk_fast=jk_fn_fast, xc_fast=xc_fn_fast,
        rebase_every=rebase_every, xc_switch_tol=xc_switch_tol)

    if dm0 is None:
        # core-Hamiltonian guess (+projectors), as the reference's
        # Huzinaga loop does
        f_init = h_eff
        if dm_occ_s is not None:
            f_init = f_init + huzinaga_operator(f_init, dm_occ_s, dm_virt_s)
        dm0 = make_rdm1(eig_fock(f_init)[1], occ)

    def loop(st, variant):
        it, ddm = 0, float("inf")
        while it < max_cycle:
            v = None if variant is None else variant(it, ddm)
            st = cycle(st, conv_tol, dm_conv_tol, max_cycle, v)
            it += 1
            # the cycle's one host read
            done, ddm = torch.stack([st["conv"].all().to(torch.float64),
                                     st["ddm"].max().detach()]).tolist()
            if done:
                break
        return st

    st = _initial_state(dm0.to(dtype), diis_space, mixed)
    n_mixed = 0
    if mixed:
        coarse = xc_fn_fast is not None and xc_fn is not None
        st = loop(st, lambda it, ddm: (jk_fn_fast is None or it % rebase_every == 0,
                                       coarse and ddm > xc_switch_tol))
        n_mixed = st["cycles"]
        st = _restart(st)
    st = loop(st, None)
    dm, c, mo_e, conv = st["dm"], st["c"], st["mo_e"], st["conv"]
    if grad_cycles and bool(conv.any()):
        for _ in range(grad_cycles):
            dm, c, mo_e = grad_step(dm, c, mo_e, conv)

    j, k = jk_fn(dm)
    f_fin, huz_fin, e_fin = assemble_fock(dm, j, k)
    if s.device.type == "cuda":
        failures = eigh_ops.failure_count(s.device)
        if int(failures):
            n_bad = int(failures)
            failures.zero_()
            raise RuntimeError(f"eigh: cuSOLVER failed on {n_bad} matrices in an SCF")
    return SCFResult(
        mo_coeff=c, mo_energy=mo_e, mo_occ=occ, dm=dm, e_elec=e_fin, converged=conv,
        fock=f_fin, huzinaga_op=huz_fin, n_iter=st["cycles"] + n_mixed,
        n_mixed=int(n_mixed.max()) if mixed else 0,
    )


def _write_flags(st: dict, failures, flags, status):
    """The flags of a program's state ``st``: [all converged, most cycles of
    a lane, eigh ``failures``] into ``flags``; the same and [largest
    density change, any converged] as float64 into ``status``, for the one
    host read of a replay."""
    values = torch.stack([st["conv"].all().to(torch.int64), st["cycles"].max(), failures])
    flags.copy_(values)
    status.copy_(torch.cat([values.to(torch.float64),
                            torch.stack([st["ddm"].max(), st["conv"].any().to(torch.float64)])]))


class SCFProgram:
    """An SCF on fixed device buffers: the cycle of :func:`_lane_ops`,
    advanced in place, so that a chunk of cycles and the final Fock build
    can each be captured once as a CUDA graph and replayed
    (``SCFEngine(jit_kernel=...)``, the lane SCFs of
    :func:`nbed_tpu_torch.scf.engine.lane_scf`).

    One geometry (``lanes`` False): ``hcore`` (n, n) or (2, n, n), ``s``,
    ``x`` = S^-1/2 and the single-geometry ``jk_fn`` and ``xc_fn`` of
    :func:`run_scf`, run as one lane. B geometries (``lanes`` True):
    ``hcore`` (B, n, n) or (B, 2, n, n), ``s`` and ``x`` (B, n, n), and lane
    closures over (B, 2, n, n) densities, each lane frozen once it has
    converged. The program reads its operators from the tensors it was
    given (a (2, n, n) or (B, 2, n, n) ``hcore``, ``s`` and ``x`` of its
    dtype are kept as views, so a caller that owns them as buffers can copy
    another geometry's operators in); ``nelec``, whether Huzinaga projectors
    are present, the level shift, ROHF, the DIIS length and ``grad_cycles``
    are fixed at construction.

    :meth:`load` copies one call's inputs into the input buffers and resets
    the state (eager work); :meth:`run_cycles` advances ``k`` cycles and
    writes the flags; :meth:`finish` builds the final J/K and Fock of the
    density reached; :meth:`grad_polish` runs the ``grad_cycles`` damped
    cycles of the converged lanes. None reads anything back to the host.
    State carries from one :meth:`run_cycles` to the next (density, energy,
    DIIS history, counters), so K cycles at a time give the iterates of one
    uninterrupted loop, whatever K is; a converged state no longer changes.

    ``jk_fast`` (with ``xc_fast``, ``rebase_every``, ``xc_switch_tol``)
    makes the program the incremental SCF of :func:`run_scf`: the mixed
    loop's cycles run through :meth:`run_cycles` with a ``variant`` (see
    :func:`_lane_ops`), :meth:`start_polish` restarts the DIIS history and
    the counters from the mixed loop's state, and the polish loop's cycles
    are the plain ones.
    """

    def __init__(self, *, hcore, s, x, nelec, jk_fn, xc_fn=None, hyb=1.0,
                 huzinaga=False, level_shift=0.0, rohf=False, diis_space=8,
                 eigh=None, failures=None, lanes=False, grad_cycles=0,
                 jk_fast=None, xc_fast=None, rebase_every=8, xc_switch_tol=1e-4):
        n = s.shape[-1]
        dtype, device = s.dtype, s.device
        self.dtype, self.device, self.nelec = dtype, device, tuple(int(v) for v in nelec)
        self.lanes = lanes
        if not lanes:
            hcore, s, x = hcore[None], s[None], x[None]
        if hcore.ndim == 3:
            hcore = torch.stack([hcore, hcore], dim=1)
        nb = s.shape[0]
        self.hcore = hcore.to(dtype).contiguous()
        self.s, self.x = s.contiguous(), x.to(dtype).contiguous()
        self.occ = _occupations(nelec, nb, n, dtype, device)
        self.diis_space = diis_space
        self.grad_cycles = int(grad_cycles)
        self.incremental = jk_fast is not None
        self.xc_fast = self.incremental and xc_fast is not None and xc_fn is not None
        self.rebase_every, self.xc_switch_tol = int(rebase_every), xc_switch_tol
        self._failures = (torch.zeros((), dtype=torch.int64, device=device)
                          if failures is None else failures)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        # inputs of one call, and what load() derives from them
        self.v_emb = zeros(nb, 2, n, n)
        self.h_eff = zeros(nb, 2, n, n)
        self.huzinaga = huzinaga
        if huzinaga:
            self.dm_env_occ, self.dm_env_virt = zeros(nb, 2, n, n), zeros(nb, 2, n, n)
            self.dm_occ_s, self.dm_virt_s = zeros(nb, 2, n, n), zeros(nb, 2, n, n)
        self.conv_tol = torch.zeros((), dtype=torch.float64, device=device)
        self.dm_conv_tol = torch.zeros((), dtype=torch.float64, device=device)
        self.max_cycle = torch.zeros((), dtype=torch.int64, device=device)
        self.state = _initial_state(zeros(nb, 2, n, n), diis_space, self.incremental)
        # outputs: the flags [all converged, most cycles of a lane, eigh
        # failures]; the same and [largest density change, any converged]
        # as float64 for the one host read of a replay; the final build
        self.flags = torch.zeros(3, dtype=torch.int64, device=device)
        self.status = torch.zeros(5, dtype=torch.float64, device=device)
        self.fock, self.huz = zeros(nb, 2, n, n), zeros(nb, 2, n, n)
        self.e_fin = torch.zeros(nb, dtype=dtype, device=device)

        def single(fn):
            return fn if lanes else _one_lane(fn)

        self._assemble, self._eig_fock, self._cycle, self._grad_step = _lane_ops(
            h_eff=self.h_eff, s=self.s, x=self.x, occ=self.occ, jk_fn=single(jk_fn),
            xc_fn=single(xc_fn), hyb=hyb,
            dm_occ_s=self.dm_occ_s if huzinaga else None,
            dm_virt_s=self.dm_virt_s if huzinaga else None,
            level_shift=level_shift, rohf=rohf, diis_space=diis_space, eigh=eigh,
            jk_fast=single(jk_fast), xc_fast=single(xc_fast), rebase_every=rebase_every,
            xc_switch_tol=xc_switch_tol)
        self._jk = single(jk_fn)

    def _lane(self, t):
        return t if t is None or self.lanes else t[None]

    def buffers(self) -> list:
        """The state and output buffers, which a capture's warm-up call must
        leave as they were."""
        return [*self.state.values(), self.flags, self.status, self.fock, self.huz, self.e_fin]

    def load(self, *, v_emb=None, dm_env_occ=None, dm_env_virt=None, dm0=None,
             conv_tol, dm_conv_tol, max_cycle):
        """Copy one call's inputs ((2, n, n) tensors of the program's dtype,
        (B, 2, n, n) for lanes, or None) into the buffers, derive h_eff and
        the projector products, and reset the state at ``dm0`` or, where it
        is None, the core guess (``h_eff`` plus the projectors,
        diagonalised with ``eigh``)."""
        if (dm_env_occ is not None) != self.huzinaga:
            raise ValueError("this SCFProgram was built "
                             f"{'with' if self.huzinaga else 'without'} Huzinaga projectors")
        v_emb, dm_env_occ, dm_env_virt, dm0 = map(self._lane,
                                                  (v_emb, dm_env_occ, dm_env_virt, dm0))
        if v_emb is None:
            self.v_emb.zero_()
        else:
            self.v_emb.copy_(v_emb)
        self.h_eff.copy_(self.hcore + self.v_emb)
        if self.huzinaga:
            self.dm_env_occ.copy_(dm_env_occ)
            if dm_env_virt is None:
                self.dm_env_virt.zero_()
            else:
                self.dm_env_virt.copy_(dm_env_virt)
            occ_s, virt_s = _huzinaga_products(
                self.dm_env_occ, None if dm_env_virt is None else self.dm_env_virt, self.s)
            self.dm_occ_s.copy_(occ_s)
            self.dm_virt_s.copy_(virt_s)
        self.conv_tol.fill_(conv_tol)
        self.dm_conv_tol.fill_(dm_conv_tol)
        self.max_cycle.fill_(int(max_cycle))
        if dm0 is None:
            f_init = self.h_eff
            if self.huzinaga:
                f_init = f_init + huzinaga_operator(f_init, self.dm_occ_s, self.dm_virt_s)
            dm0 = make_rdm1(self._eig_fock(f_init)[1], self.occ)
        for key, value in _initial_state(dm0.to(self.dtype), self.diis_space,
                                         self.incremental).items():
            self.state[key].copy_(value)

    def run_cycles(self, k: int, variant=None):
        """``k`` cycles in place (of the incremental ``variant``, see
        :func:`_lane_ops`; None: plain cycles), then the flags."""
        st = dict(self.state)
        for _ in range(k):
            st = self._cycle(st, self.conv_tol, self.dm_conv_tol, self.max_cycle, variant)
        for key, value in st.items():
            self.state[key].copy_(value)
        _write_flags(st, self._failures, self.flags, self.status)

    def start_polish(self):
        """The polish loop's start (eager): the mixed loop's density,
        energy and orbitals, with a new DIIS history and counters."""
        st = self.state
        for key in ("hist_f", "hist_e", "conv", "cycles", "it"):
            st[key].zero_()
        st["ddm"].fill_(float("inf"))

    @property
    def polish_replays(self) -> int:
        """Calls of :meth:`grad_polish` that run the ``grad_cycles``: one."""
        return 1

    def grad_polish(self):
        """``grad_cycles`` damped DIIS-free cycles of the converged lanes
        (``run_scf(grad_cycles=...)``), in place."""
        st = self.state
        dm, c, mo_e = st["dm"], st["c"], st["mo_e"]
        for _ in range(self.grad_cycles):
            dm, c, mo_e = self._grad_step(dm, c, mo_e, st["conv"])
        st["dm"].copy_(dm)
        st["c"].copy_(c)
        st["mo_e"].copy_(mo_e)

    def finish(self):
        """The final J/K, Fock, Huzinaga operator and energy of the state's
        density."""
        dm = self.state["dm"]
        j, k = self._jk(dm)
        f, huz, e = self._assemble(dm, j, k)
        self.fock.copy_(f)
        self.huz.copy_(huz)
        self.e_fin.copy_(e)

    def result(self, extra_cycles: int = 0) -> SCFResult:
        """The :class:`SCFResult` of the state after :meth:`finish`, on
        copies of the buffers (the next call overwrites them), with
        ``extra_cycles`` (the incremental mixed loop's) added to the cycle
        count. One
        geometry: one host read (the energy and the flags); lanes: tensors
        (B,) as :func:`run_scf` returns them, no host read."""
        st = self.state
        if self.lanes:
            return SCFResult(
                mo_coeff=st["c"].clone(), mo_energy=st["mo_e"].clone(),
                mo_occ=self.occ.clone(), dm=st["dm"].clone(), e_elec=self.e_fin.clone(),
                converged=st["conv"].clone(), fock=self.fock.clone(),
                huzinaga_op=self.huz.clone(), n_iter=st["cycles"] + extra_cycles)
        e_fin, conv, cycles = torch.cat([self.e_fin.to(torch.float64),
                                         self.flags[:2].to(torch.float64)]).tolist()
        return SCFResult(
            mo_coeff=st["c"][0].clone(), mo_energy=st["mo_e"][0].clone(),
            mo_occ=self.occ[0].clone(), dm=st["dm"][0].clone(), e_elec=e_fin,
            converged=bool(conv), fock=self.fock[0].clone(), huzinaga_op=self.huz[0].clone(),
            n_iter=int(cycles) + extra_cycles, n_mixed=extra_cycles)


class TangentSCFProgram:
    """:class:`SCFProgram`'s lane SCF under forward-mode AD: the tangent
    state (density, orbitals, energies, DIIS history) beside the primal one
    in device buffers, each cycle the jvp of the primal cycle, as the
    eager lane loop (:func:`run_scf` on dual operators) runs it: J/K
    through :class:`nbed_tpu_torch.ops.jk.TangentJK`, the differentiable
    XC closure, the Fock eigh through
    :func:`nbed_tpu_torch.ops.eigh.eigh_jvp`, DIIS coefficients without a
    tangent (the reference's ``stop_gradient``), and the ``grad_cycles``
    damped polish carrying the tangent. Convergence is read on the primal
    alone, through the same flags and status buffers.

    ``operands``: {name: (primal, tangent)} buffers of "hcore" (B, 2, n,
    n), "s", "x" (B, n, n) and the tensors ``build`` reads; ``build(duals)
    -> (jk_fn, xc_fn)`` gives the lane closures over dual views of them,
    and is called inside every body (a dual tensor lives in its level),
    so it must prepare nothing: its J/K finds the
    :class:`~nbed_tpu_torch.ops.jk.TangentJK` made here on "g_j"/"g_k".
    Every method reads and writes buffers only and runs in the caller's
    forward-mode level (or one of its own), so a chunk of cycles, the
    polish and the final build are captured as CUDA graphs by
    :class:`nbed_tpu_torch.scf.engine._GraphedSCF`, as the primal ones
    are. The lane form only (``lanes`` True), float64, no incremental
    loop, no ROHF."""

    incremental = False
    xc_fast = False
    lanes = True

    def __init__(self, *, operands: dict, build, nelec, hyb=1.0, huzinaga=False,
                 level_shift=0.0, diis_space=8, grad_cycles=0, failures=None):
        from ..ops.jk import TangentJK

        s = operands["s"][0]
        nb, n = s.shape[0], s.shape[-1]
        dtype, device = s.dtype, s.device
        self.dtype, self.device, self.nelec = dtype, device, tuple(int(v) for v in nelec)
        self.operands, self.build = operands, build
        self.hyb, self.huzinaga, self.level_shift = hyb, huzinaga, level_shift
        self.diis_space, self.grad_cycles = diis_space, int(grad_cycles)
        self.occ = _occupations(nelec, nb, n, dtype, device)
        self._failures = (torch.zeros((), dtype=torch.int64, device=device)
                          if failures is None else failures)
        # the J/K of the supermatrices and their tangents, prepared once on
        # the buffers; build's forward_ad_jk finds it by their memory
        self._jk = TangentJK(operands["g_j"][0], operands["g_k"][0], operands["g_j"][1],
                             operands["g_k"][1])

        def pair(*shape):
            return (torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))

        self.v_emb, self.h_eff = pair(nb, 2, n, n), pair(nb, 2, n, n)
        if huzinaga:
            self.dm_env_occ, self.dm_env_virt = pair(nb, 2, n, n), pair(nb, 2, n, n)
            self.dm_occ_s, self.dm_virt_s = pair(nb, 2, n, n), pair(nb, 2, n, n)
        self.conv_tol = torch.zeros((), dtype=torch.float64, device=device)
        self.dm_conv_tol = torch.zeros((), dtype=torch.float64, device=device)
        self.max_cycle = torch.zeros((), dtype=torch.int64, device=device)
        self.state = _initial_state(torch.zeros((nb, 2, n, n), dtype=dtype, device=device),
                                    diis_space)
        self.state_dot = {key: torch.zeros_like(t) for key, t in self.state.items()
                          if t.is_floating_point()}
        self.flags = torch.zeros(3, dtype=torch.int64, device=device)
        self.status = torch.zeros(5, dtype=torch.float64, device=device)
        self.fock, self.huz = pair(nb, 2, n, n), pair(nb, 2, n, n)
        self.e_fin = pair(nb)

    def buffers(self) -> list:
        pairs = [self.fock, self.huz, self.e_fin]
        return [*self.state.values(), *self.state_dot.values(), self.flags, self.status,
                *(t for p in pairs for t in p)]

    @staticmethod
    def _dual(pair):
        return forward_ad.make_dual(*pair)

    def _ops(self):
        """(:func:`_lane_ops`, jk_fn) over dual views of the buffers (inside
        a forward-mode level)."""
        duals = {name: self._dual(p) for name, p in self.operands.items()}
        jk_fn, xc_fn = self.build(duals)
        products = {}
        if self.huzinaga:
            products = dict(dm_occ_s=self._dual(self.dm_occ_s),
                            dm_virt_s=self._dual(self.dm_virt_s))
        return _lane_ops(h_eff=self._dual(self.h_eff), s=duals["s"], x=duals["x"],
                         occ=self.occ, jk_fn=jk_fn, xc_fn=xc_fn, hyb=self.hyb,
                         level_shift=self.level_shift, diis_space=self.diis_space,
                         eigh=partial(scf_eigh, program=True), **products), jk_fn

    def _state(self) -> dict:
        return {key: (forward_ad.make_dual(t, self.state_dot[key]) if key in self.state_dot
                      else t) for key, t in self.state.items()}

    def _store(self, st: dict):
        for key, value in st.items():
            if key in self.state_dot:
                write_dual((self.state[key], self.state_dot[key]), value)
            else:
                self.state[key].copy_(value)

    def load(self, *, v_emb=None, dm_env_occ=None, dm_env_virt=None, dm0=None,
             conv_tol, dm_conv_tol, max_cycle):
        """:meth:`SCFProgram.load` for (B, 2, n, n) inputs that may carry
        tangents (eager work)."""
        if (dm_env_occ is not None) != self.huzinaga:
            raise ValueError("this TangentSCFProgram was built "
                             f"{'with' if self.huzinaga else 'without'} Huzinaga projectors")
        with dual_scope():
            hcore, s = self._dual(self.operands["hcore"]), self._dual(self.operands["s"])
            v = torch.zeros_like(self.v_emb[0]) if v_emb is None else v_emb
            write_dual(self.v_emb, v)
            write_dual(self.h_eff, hcore + self._dual(self.v_emb))
            if self.huzinaga:
                write_dual(self.dm_env_occ, dm_env_occ)
                write_dual(self.dm_env_virt, torch.zeros_like(dm_env_occ)
                           if dm_env_virt is None else dm_env_virt)
                occ_s, virt_s = _huzinaga_products(
                    self._dual(self.dm_env_occ),
                    None if dm_env_virt is None else self._dual(self.dm_env_virt), s)
                write_dual(self.dm_occ_s, occ_s)
                write_dual(self.dm_virt_s, virt_s)
            self.conv_tol.fill_(conv_tol)
            self.dm_conv_tol.fill_(dm_conv_tol)
            self.max_cycle.fill_(int(max_cycle))
            if dm0 is None:
                (_, eig_fock, _, _), _ = self._ops()
                f_init = self._dual(self.h_eff)
                if self.huzinaga:
                    f_init = f_init + huzinaga_operator(f_init, self._dual(self.dm_occ_s),
                                                        self._dual(self.dm_virt_s))
                dm0 = make_rdm1(eig_fock(f_init)[1], self.occ)
            self._store(_initial_state(dm0.to(self.dtype), self.diis_space))

    def run_cycles(self, k: int, variant=None):
        """``k`` cycles in place, then the flags (of the primal state)."""
        with dual_scope():
            (_, _, cycle, _), _ = self._ops()
            st = self._state()
            for _ in range(k):
                st = cycle(st, self.conv_tol, self.dm_conv_tol, self.max_cycle)
            self._store(st)
        _write_flags(self.state, self._failures, self.flags, self.status)

    @property
    def polish_replays(self) -> int:
        """Calls of :meth:`grad_polish` that run the ``grad_cycles``: one
        each, so that a graph of one cycle is captured, not of all."""
        return self.grad_cycles

    def grad_polish(self):
        """One of the ``grad_cycles`` damped cycles of the converged lanes,
        primal and tangent, in place."""
        with dual_scope():
            (_, _, _, grad_step), _ = self._ops()
            st = self._state()
            dm, c, mo_e = grad_step(st["dm"], st["c"], st["mo_e"], st["conv"])
            self._store({"dm": dm, "c": c, "mo_e": mo_e})

    def finish(self):
        """The final J/K, Fock, Huzinaga operator and energy of the state's
        density, primal and tangent."""
        with dual_scope():
            (assemble, _, _, _), jk_fn = self._ops()
            dm = self._state()["dm"]
            j, k = jk_fn(dm)
            f, huz, e = assemble(dm, j, k)
            write_dual(self.fock, f)
            write_dual(self.huz, huz)
            write_dual(self.e_fin, e)

    def result(self, extra_cycles: int = 0) -> SCFResult:
        """The lanes' :class:`SCFResult` as dual tensors of the caller's
        forward-mode level (copies of the buffers), no host read."""
        st = self.state

        def dual(primal, tangent):
            return forward_ad.make_dual(primal.clone(), tangent.clone())

        return SCFResult(
            mo_coeff=dual(st["c"], self.state_dot["c"]),
            mo_energy=dual(st["mo_e"], self.state_dot["mo_e"]), mo_occ=self.occ.clone(),
            dm=dual(st["dm"], self.state_dot["dm"]), e_elec=dual(*self.e_fin),
            converged=st["conv"].clone(), fock=dual(*self.fock),
            huzinaga_op=dual(*self.huz), n_iter=st["cycles"] + extra_cycles)
