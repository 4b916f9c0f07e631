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
become Python ``if`` on host scalars.

Lanes: an ``s`` of shape (B, n, n) runs B SCFs at once (a batch of
conformers), the reference's ``vmap`` of its ``while_loop``. Every operator
and the DIIS history carry the lane axis, ``eigh`` and the DIIS solve are
batched ``torch.linalg`` calls, and the loop reads one (B,) convergence
tensor per cycle. A converged lane is frozen: as the vmapped loop selects
the old carry where a lane's condition is false, each cycle's update is
taken only on the lanes still running, so lane b ends where the same
geometry run alone ends, in the same number of cycles. The lane form takes
the float64 operators of HF, KS and Huzinaga SCFs; ROHF and the mixed
precision modes stay single-geometry.

One cycle of the lane form is a function of device state alone
(:func:`_lane_ops`): the DIIS slot, the fill count, the cycle counter and
the convergence test are device tensors, and the cycle reads nothing back
to the host. The lane loop reads its (B,) convergence tensor after each
cycle; :class:`SCFProgram` runs the same cycle at B = 1 on fixed buffers,
K cycles at a time, which is what the engine captures as a CUDA graph
(``SCFEngine(jit_kernel=...)``, the port of the reference's one compiled
program per SCF). The single-geometry loop of :func:`run_scf` keeps its own
per-cycle host reads.

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
from typing import Callable, Optional

import torch

from ..ops.jk import prepare_jk

__all__ = ["SCFResult", "SCFProgram", "run_scf", "make_rdm1", "lowdin_x",
           "huzinaga_operator"]


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


def make_rdm1(mo_coeff, mo_occ):
    """D_sigma = C diag(occ) C^T with 0/1 spin-orbital occupations; leading
    lane axes ride along."""
    return torch.einsum("...spi,...si,...sqi->...spq", mo_coeff, mo_occ, mo_coeff)


def lowdin_x(s):
    """S^{-1/2} via eigh, of (n, n) or (B, n, n)."""
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


def _diis_extrapolate(hist_f, hist_e, nfill, eigh=torch.linalg.eigh):
    """Pulay extrapolation of the history Focks ([B,] m, 2, n, n) over the
    ``nfill`` (an int or a device integer) filled slots of the ring buffer,
    with the reference's eigh pseudo-inverse and relative cut
    (``hf.py:260-292``), per lane; ``eigh`` solves the padded system. The
    coefficients come from the detached errors, so no derivative reaches
    them."""
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
    ew, ev = eigh(big)
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
    the core Hamiltonian). The loop runs in the dtype of ``hcore``: float32
    operators give the mixed-precision warm-up.

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
    n = s.shape[-1]
    if hcore.ndim == 2:
        hcore = torch.stack([hcore, hcore])
    if v_emb is None:
        v_emb = torch.zeros((2, n, n), dtype=hcore.dtype, device=hcore.device)
    elif v_emb.ndim == 2:
        v_emb = torch.stack([v_emb, v_emb])
    v_emb = v_emb.to(hcore.dtype)
    x = lowdin_x(s)
    h_eff = hcore + v_emb

    use_huz = dm_env_occ is not None
    if use_huz:
        dm_occ_s = torch.einsum("sij,jk->sik", dm_env_occ, s)
        if dm_env_virt is None:
            dm_virt_s = torch.zeros_like(dm_occ_s)
        else:
            dm_virt_s = torch.einsum("sij,jk->sik", dm_env_virt, s)

    na, nb = int(nelec[0]), int(nelec[1])
    ar = torch.arange(n, device=s.device)
    occ = torch.stack([(ar < na).to(s.dtype), (ar < nb).to(s.dtype)])

    def assemble_fock(dm, j, k, xc=xc_fn):
        """(F incl. huz, huz, e_elec of dm) from dm and its J/K pair."""
        vhf = j[None] - hyb * k
        if xc is not None:
            exc, vxc = xc(dm)
            vhf = vhf + vxc
        else:
            exc = 0.0
        f0 = h_eff + vhf
        if use_huz:
            huz = huzinaga_operator(f0, dm_occ_s, dm_virt_s)
            f = f0 + huz
        else:
            huz = torch.zeros_like(f0)
            f = f0
        e1 = torch.einsum("sij,sji->", h_eff + huz, dm)
        ecoul = 0.5 * torch.einsum("ij,ji->", j, dm[0] + dm[1])
        ex_hf = -0.5 * hyb * torch.einsum("sij,sji->", k, dm)
        return f, huz, e1 + ecoul + ex_hf + exc

    def xc_f32(dm):
        exc, vxc = xc_fn_fast(dm.to(torch.float32))
        return exc.to(dm.dtype), vxc.to(dm.dtype)

    def eig_fock(f):
        f_ortho = torch.einsum("pi,spq,qj->sij", x, f, x)
        mo_e, c_ortho = torch.linalg.eigh(f_ortho)
        return mo_e, torch.einsum("pi,sij->spj", x, c_ortho)

    if dm0 is None:
        # core-Hamiltonian guess (+projectors), as the reference's
        # Huzinaga loop does
        f_init = h_eff
        if use_huz:
            f_init = f_init + huzinaga_operator(f_init, dm_occ_s, dm_virt_s)
        _, c0 = eig_fock(f_init)
        dm0 = make_rdm1(c0, occ)

    def step(dm, j, k, xc, damp: float = 0.0):
        """(dm', e of dm, c, mo_e) of one DIIS-free cycle with ``dm``'s J/K,
        ``dm`` mixed in by ``damp``: the tangent polish's step."""
        f, _, e_cur = assemble_fock(dm, j, k, xc)
        mo_e, c = eig_fock(f)
        dm_new = make_rdm1(c, occ)
        return (1.0 - damp) * dm_new + damp * dm, e_cur, c, mo_e

    def loop(dm, e_prev, c, mo_e, inc: bool, xcfast: bool):
        """SCF cycles from ``dm`` until convergence or ``max_cycle``, with a
        fresh DIIS history; returns (dm, e, c, mo_e, converged, cycles)."""
        m = diis_space
        hist_f = torch.zeros((m, 2, n, n), dtype=dm.dtype, device=dm.device)
        hist_e = torch.zeros_like(hist_f)
        nfill = 0
        ddm = float("inf")
        conv = False
        cycle = 0
        while cycle < max_cycle and not conv:
            xc = xc_f32 if xcfast and ddm > xc_switch_tol else xc_fn
            if inc:
                if cycle % rebase_every == 0:
                    j, k = jk_fn(dm)
                else:
                    jd, kd = jk_fn_fast((dm - dm_ref).to(torch.float32))
                    j = j_ref + jd.to(dm.dtype)
                    k = k_ref + kd.to(dm.dtype)
                dm_ref, j_ref, k_ref = dm, j, k
            else:
                j, k = jk_fn(dm)
            f, _, e_cur = assemble_fock(dm, j, k, xc)
            if rohf:
                # the per-spin error of F_eff covers every coupling block:
                # D_beta tests closed-open and closed-virtual, D_alpha
                # open-virtual
                f = roothaan_effective(f, dm, s)
            fds = torch.einsum("sij,sjk,kl->sil", f, dm, s)
            err = torch.einsum("pi,spq,qj->sij", x, fds - fds.transpose(-1, -2), x)
            slot = cycle % m
            hist_f[slot] = f
            hist_e[slot] = err
            nfill = min(nfill + 1, m)
            f_use = f
            if cycle > 0 and use_diis:
                f_use = _diis_extrapolate(hist_f, hist_e, nfill)
            if level_shift:
                # F' = F + lambda (S - S D_s S) shifts only the virtual
                # eigenvalues, damping occupied<->virtual oscillation
                sds = torch.einsum("ij,sjk,kl->sil", s, dm, s)
                f_use = f_use + level_shift * (s[None] - sds)
            mo_e, c = eig_fock(f_use)
            dm_new = make_rdm1(c, occ)
            e_cur = float(e_cur)
            de = abs(e_cur - e_prev)
            ddm = float(torch.max(torch.linalg.matrix_norm(dm_new - dm)))
            conv = de < conv_tol and ddm < dm_conv_tol
            e_prev = e_cur
            dm = dm_new
            cycle += 1
        return dm, e_prev, c, mo_e, conv, cycle

    dm = dm0.to(h_eff.dtype)
    c = torch.zeros((2, n, n), dtype=dm.dtype, device=dm.device)
    mo_e = torch.zeros((2, n), dtype=dm.dtype, device=dm.device)
    inc = jk_fn_fast is not None
    xcfast = xc_fn_fast is not None and xc_fn is not None
    dm, e_prev, c, mo_e, conv, cycles = loop(dm, float("inf"), c, mo_e, inc, xcfast)
    if inc or xcfast:
        # full-precision polish: the mixed loop's fixed point carries its
        # float32 contraction noise, and a few pure cycles from its density
        # land on the float64 fixed point
        dm, e_prev, c, mo_e, conv, more = loop(dm, e_prev, c, mo_e, False, False)
        cycles += more
    if grad_cycles and conv:
        for _ in range(grad_cycles):
            j, k = jk_fn(dm)
            dm, _, c, mo_e = step(dm, j, k, xc_fn, damp=0.5)

    j, k = jk_fn(dm)
    f_fin, huz_fin, e_fin = assemble_fock(dm, j, k)
    return SCFResult(
        mo_coeff=c, mo_energy=mo_e, mo_occ=occ, dm=dm, e_elec=float(e_fin),
        converged=conv, fock=f_fin, huzinaga_op=huz_fin, n_iter=cycles,
    )


def _lane_ops(*, h_eff, s, x, occ, jk_fn, xc_fn, hyb, dm_occ_s=None, dm_virt_s=None,
              level_shift=0.0, rohf=False, use_diis=True, diis_space=8,
              eigh=torch.linalg.eigh):
    """(assemble_fock, eig_fock, cycle) of an SCF over a leading lane axis:
    ``h_eff`` (B, 2, n, n), ``s`` and ``x`` (B, n, n), ``occ`` (B, 2, n),
    ``jk_fn`` and ``xc_fn`` over (B, 2, n, n) densities, the Huzinaga
    products ``dm_occ_s``/``dm_virt_s`` (B, 2, n, n) or None, and ``eigh``
    for the Fock diagonalisation and the DIIS solve.

    ``cycle(st, conv_tol, dm_conv_tol, max_cycle)`` is one SCF cycle of the
    state ``st`` (:func:`_initial_state`) and returns the next state. It
    reads nothing back to the host: the DIIS slot and fill count follow
    the device counter ``it``, the extrapolation is selected from cycle 1
    on by ``torch.where``, and a lane that has converged, or has run
    ``max_cycle`` cycles (an int or a device integer), keeps its state, as
    the reference's vmapped loop selects the old carry."""
    m = diis_space

    def assemble_fock(dm, j, k):
        """(F incl. huz, huz, e_elec (B,) of dm) from dm and its J/K pair."""
        vhf = j[:, None] - hyb * k
        if xc_fn is not None:
            exc, vxc = xc_fn(dm)
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

    def eig_fock(f):
        f_ortho = torch.einsum("bpi,bspq,bqj->bsij", x, f, x)
        mo_e, c_ortho = eigh(f_ortho)
        return mo_e, torch.einsum("bpi,bsij->bspj", x, c_ortho)

    def cycle(st, conv_tol, dm_conv_tol, max_cycle):
        dm, it = st["dm"], st["it"]
        active = ~st["conv"] & (it < max_cycle)  # the lanes this cycle updates
        j, k = jk_fn(dm)
        f, _, e_cur = assemble_fock(dm, j, k)
        if rohf:
            # the per-spin error of F_eff covers every coupling block (see
            # run_scf)
            f = roothaan_effective(f, dm, s)
        fds = torch.einsum("bsij,bsjk,bkl->bsil", f, dm, s)
        err = torch.einsum("bpi,bspq,bqj->bsij", x, fds - fds.transpose(-1, -2), x)
        slot = (torch.arange(m, device=it.device) == it % m).reshape(1, m, 1, 1, 1)
        hist_f = torch.where(slot, f[:, None], st["hist_f"])
        hist_e = torch.where(slot, err[:, None], st["hist_e"])
        f_use = f
        if use_diis:
            f_use = torch.where(it > 0, _diis_extrapolate(
                hist_f, hist_e, torch.clamp(it + 1, max=m), eigh), f)
        if level_shift:
            sds = torch.einsum("bij,bsjk,bkl->bsil", s, dm, s)
            f_use = f_use + level_shift * (s[:, None] - sds)
        mo_e_new, c_new = eig_fock(f_use)
        dm_new = make_rdm1(c_new, occ)
        # the test in float64, as the single-geometry loop takes it on the
        # host: float32 loops compare their energy and density changes in
        # float64 too
        e_cur = e_cur.to(st["e"].dtype)
        de = torch.abs(e_cur - st["e"])
        ddm = torch.amax(torch.linalg.matrix_norm(dm_new - dm), dim=-1).to(st["e"].dtype)
        now = (de < conv_tol) & (ddm < dm_conv_tol)
        return {
            "dm": _take(active, dm_new, dm), "e": _take(active, e_cur, st["e"]),
            "c": _take(active, c_new, st["c"]), "mo_e": _take(active, mo_e_new, st["mo_e"]),
            "conv": st["conv"] | (active & now),
            "cycles": st["cycles"] + active.to(st["cycles"].dtype),
            "it": it + 1, "hist_f": hist_f, "hist_e": hist_e,
        }

    return assemble_fock, eig_fock, cycle


def _take(mask, new, old):
    """``new`` on the lanes of the (B,) ``mask``, ``old`` elsewhere."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _initial_state(dm0, diis_space: int) -> dict:
    """The SCF state of :func:`_lane_ops` at cycle 0 from the (B, 2, n, n)
    density ``dm0``: energies in float64 whatever the loop's dtype."""
    nb, n = dm0.shape[0], dm0.shape[-1]
    dtype, device = dm0.dtype, dm0.device
    hist = torch.zeros((nb, diis_space, 2, n, n), dtype=dtype, device=device)
    return {
        "dm": dm0, "e": torch.full((nb,), float("inf"), dtype=torch.float64, device=device),
        "c": torch.zeros((nb, 2, n, n), dtype=dtype, device=device),
        "mo_e": torch.zeros((nb, 2, n), dtype=dtype, device=device),
        "conv": torch.zeros(nb, dtype=torch.bool, device=device),
        "cycles": torch.zeros(nb, dtype=torch.int64, device=device),
        "it": torch.zeros((), dtype=torch.int64, device=device),
        "hist_f": hist, "hist_e": torch.zeros_like(hist),
    }


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


def _run_scf_lanes(*, hcore, s, nelec, jk_fn, v_emb, xc_fn, hyb, dm_env_occ, dm_env_virt,
                   dm0, conv_tol, dm_conv_tol, max_cycle, diis_space, level_shift, use_diis,
                   grad_cycles) -> SCFResult:
    """:func:`run_scf` over a leading lane axis (see the module docstring):
    the cycles of :func:`_lane_ops`, with one (B,) host read after each."""
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
    assemble_fock, eig_fock, cycle = _lane_ops(
        h_eff=h_eff, s=s, x=x, occ=occ, jk_fn=jk_fn, xc_fn=xc_fn, hyb=hyb, dm_occ_s=dm_occ_s,
        dm_virt_s=dm_virt_s, level_shift=level_shift, use_diis=use_diis,
        diis_space=diis_space)

    if dm0 is None:
        f_init = h_eff
        if dm_occ_s is not None:
            f_init = f_init + huzinaga_operator(f_init, dm_occ_s, dm_virt_s)
        dm0 = make_rdm1(eig_fock(f_init)[1], occ)

    st = _initial_state(dm0.to(dtype), diis_space)
    it = 0
    running = True
    while it < max_cycle and running:
        st = cycle(st, conv_tol, dm_conv_tol, max_cycle)
        it += 1
        running = not bool(st["conv"].all().cpu())  # the cycle's one host read
    dm, c, mo_e, conv = st["dm"], st["c"], st["mo_e"], st["conv"]
    if grad_cycles and bool(conv.any()):
        for _ in range(grad_cycles):
            j, k = jk_fn(dm)
            f, _, _ = assemble_fock(dm, j, k)
            mo_e_new, c_new = eig_fock(f)
            dm = _take(conv, 0.5 * make_rdm1(c_new, occ) + 0.5 * dm, dm)
            c = _take(conv, c_new, c)
            mo_e = _take(conv, mo_e_new, mo_e)

    j, k = jk_fn(dm)
    f_fin, huz_fin, e_fin = assemble_fock(dm, j, k)
    return SCFResult(
        mo_coeff=c, mo_energy=mo_e, mo_occ=occ, dm=dm, e_elec=e_fin, converged=conv,
        fock=f_fin, huzinaga_op=huz_fin, n_iter=st["cycles"],
    )


class SCFProgram:
    """One geometry's SCF on fixed device buffers: the cycle of
    :func:`_lane_ops` at B = 1, advanced in place, so that a chunk of
    cycles and the final Fock build can each be captured once as a CUDA
    graph and replayed (``SCFEngine(jit_kernel=...)``).

    The operators (``hcore`` (n, n) or (2, n, n), ``s``, ``x`` = S^-1/2,
    the single-geometry ``jk_fn`` and ``xc_fn`` of :func:`run_scf`) are
    fixed at construction, as are ``nelec``, whether Huzinaga projectors
    are present, the level shift, ROHF and the DIIS length. :meth:`load`
    copies one call's inputs into the input buffers and resets the state
    (eager work); :meth:`run_cycles` advances ``k`` cycles and writes the
    flags [converged, cycles, eigh failures]; :meth:`finish` builds the
    final J/K and Fock of the density reached. Neither reads anything back
    to the host. State carries from one :meth:`run_cycles` to the next
    (density, energy, DIIS history, counters), so K cycles at a time give
    the iterates of one uninterrupted loop, whatever K is; a converged
    state no longer changes.
    """

    def __init__(self, *, hcore, s, x, nelec, jk_fn, xc_fn=None, hyb=1.0,
                 huzinaga=False, level_shift=0.0, rohf=False, diis_space=8,
                 eigh=torch.linalg.eigh, failures=None):
        n = s.shape[-1]
        dtype, device = s.dtype, s.device
        self.dtype, self.device, self.nelec = dtype, device, tuple(int(v) for v in nelec)
        if hcore.ndim == 2:
            hcore = torch.stack([hcore, hcore])
        self.hcore = hcore[None].to(dtype).contiguous()
        self.s, self.x = s[None].contiguous(), x[None].to(dtype).contiguous()
        self.occ = _occupations(nelec, 1, n, dtype, device)
        self.diis_space = diis_space
        self.eigh = eigh
        self._failures = (torch.zeros((), dtype=torch.int64, device=device)
                          if failures is None else failures)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        # inputs of one call, and what load() derives from them
        self.v_emb = zeros(1, 2, n, n)
        self.h_eff = zeros(1, 2, n, n)
        self.huzinaga = huzinaga
        if huzinaga:
            self.dm_env_occ, self.dm_env_virt = zeros(1, 2, n, n), zeros(1, 2, n, n)
            self.dm_occ_s, self.dm_virt_s = zeros(1, 2, n, n), zeros(1, 2, n, n)
        self.conv_tol = torch.zeros((), dtype=torch.float64, device=device)
        self.dm_conv_tol = torch.zeros((), dtype=torch.float64, device=device)
        self.max_cycle = torch.zeros((), dtype=torch.int64, device=device)
        self.state = _initial_state(zeros(1, 2, n, n), diis_space)
        # outputs: [converged, cycles, eigh failures] and the final build
        self.flags = torch.zeros(3, dtype=torch.int64, device=device)
        self.fock, self.huz = zeros(1, 2, n, n), zeros(1, 2, n, n)
        self.e_fin = torch.zeros(1, dtype=dtype, device=device)

        def jk_lanes(dm):
            j, k = jk_fn(dm[0])
            return j[None], k[None]

        def xc_lanes(dm):
            exc, vxc = xc_fn(dm[0])
            return exc.reshape(1), vxc[None]

        self._assemble, self._eig_fock, self._cycle = _lane_ops(
            h_eff=self.h_eff, s=self.s, x=self.x, occ=self.occ, jk_fn=jk_lanes,
            xc_fn=None if xc_fn is None else xc_lanes, hyb=hyb,
            dm_occ_s=self.dm_occ_s if huzinaga else None,
            dm_virt_s=self.dm_virt_s if huzinaga else None,
            level_shift=level_shift, rohf=rohf, diis_space=diis_space, eigh=eigh)
        self._jk = jk_lanes

    def load(self, *, v_emb=None, dm_env_occ=None, dm_env_virt=None, dm0=None,
             conv_tol, dm_conv_tol, max_cycle):
        """Copy one call's inputs ((2, n, n) tensors of the program's dtype,
        or None) into the buffers, derive h_eff and the projector products,
        and reset the state at ``dm0`` or, where it is None, the core guess
        (``h_eff`` plus the projectors, diagonalised with ``eigh``)."""
        if (dm_env_occ is not None) != self.huzinaga:
            raise ValueError("this SCFProgram was built "
                             f"{'with' if self.huzinaga else 'without'} Huzinaga projectors")
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
        else:
            dm0 = dm0[None]
        for key, value in _initial_state(dm0.to(self.dtype), self.diis_space).items():
            self.state[key].copy_(value)

    def run_cycles(self, k: int):
        """``k`` cycles in place, then the flags."""
        st = dict(self.state)
        for _ in range(k):
            st = self._cycle(st, self.conv_tol, self.dm_conv_tol, self.max_cycle)
        for key, value in st.items():
            self.state[key].copy_(value)
        self.flags.copy_(torch.stack([st["conv"][0].to(torch.int64), st["cycles"][0],
                                      self._failures]))

    def finish(self):
        """The final J/K, Fock, Huzinaga operator and energy of the state's
        density."""
        dm = self.state["dm"]
        j, k = self._jk(dm)
        f, huz, e = self._assemble(dm, j, k)
        self.fock.copy_(f)
        self.huz.copy_(huz)
        self.e_fin.copy_(e)

    def result(self) -> SCFResult:
        """The :class:`SCFResult` of the state after :meth:`finish`, on
        copies of the buffers (the next call overwrites them); one host
        read (the energy and the flags)."""
        st = self.state
        e_fin, conv, cycles = torch.cat([self.e_fin.to(torch.float64),
                                         self.flags[:2].to(torch.float64)]).tolist()
        return SCFResult(
            mo_coeff=st["c"][0].clone(), mo_energy=st["mo_e"][0].clone(),
            mo_occ=self.occ[0].clone(), dm=st["dm"][0].clone(), e_elec=e_fin,
            converged=bool(conv), fock=self.fock[0].clone(), huzinaga_op=self.huz[0].clone(),
            n_iter=int(cycles))
