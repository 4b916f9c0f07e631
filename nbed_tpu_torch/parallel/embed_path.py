"""The whole mu-embedding pipeline as one function of geometry (port of
``nbed_tpu/parallel/embed_path.py``).

``make_mu_embed_energy`` builds ``coords -> dict``: global KS -> SPADE
partition -> subsystem-DFT energy decomposition -> embedded HF (mu shift or
Huzinaga) -> embedded total energy, as the host driver assembles it
(``nbed_tpu/parallel/embed_path.py:1-31``):

    e_rhf = e_tot(embedded HF with v_emb) + e_env + two_e_cross
            - sum_s Tr(v_emb_s D_act_s)

The reference compiles it into one XLA program and ``vmap``s it over
conformers. Here the program runs over a lane axis: (B, natm, 3)
coordinates run every stage for the B conformers at once (batched
integrals, lane SCFs whose every cycle makes one fused J/K launch for the
batch, batched ``eigh``), and (natm, 3) coordinates are one lane.

SPADE's data-dependent choice of the active-space size cannot be made per
lane without changing shapes, so the active-MO count is a static argument,
as in the reference: fix it with one host-driver (or ACE) run, then scan
geometries with this program.

Geometry derivatives run in forward mode through
``torch.autograd.forward_ad`` (dual coordinates): the SCF loops read their
convergence flags on the host, which ``torch.func.jvp`` refuses inside its
transform while ``forward_ad`` reads the primal. The fused J/K kernel then
runs under :class:`nbed_tpu_torch.ops.jk.TangentJK` (the tangent is two
more launches), the XC closure in its differentiable form, and the SPADE
split through :func:`_topk_projector`'s gap-only tangent. Pass
``grad_cycles`` > 0 for tangents that settle on the implicit-function
derivative (``nbed_tpu/scf/hf.py:432-441``).

On a card (``jit_kernel`` "auto", or "on" anywhere) dual coordinates run
as forward-mode programs, the counterpart of the reference's
``jax.jit(jax.jvp(...))``: the integrals and grid tables ("core_jvp",
"eri_jvp", "grid_jvp"), the two SCFs as tangent lane programs
(:class:`nbed_tpu_torch.scf.hf.TangentSCFProgram`, a replay per chunk of
cycles, convergence read on the primal) and SPADE with the subsystem
decomposition ("embed_subsystem"), each captured once per structure and
lane count and replayed at every later geometry and tangent direction.
Their numbers are the eager dual route's (``jit_kernel="off"``) in as
many SCF cycles.
"""

from functools import partial

import numpy as np
import torch
from torch.autograd import forward_ad

from .._device import DTYPE, resolve_device
from ..chem.molecule import Molecule, _nuclear_tables
from ..grids.grid import tables_program
from ..integrals.core import core_program
from ..integrals.eri import eri_program, eri_tensor
from ..ops import eigh as eigh_ops
from ..ops.jk import TangentJK, forward_ad_jk
from ..ops.programs import (RUNS, TangentProgram, derivative_program, has_tangent, structure_key,
                            takes_program)
from ..profiling import span
from ..scf import hf
from ..scf.engine import lane_scf, lane_spec
from .sharding import _lane_groups, _lanes_jk, _supermatrices

__all__ = ["make_mu_embed_energy", "batched_embedding_energies"]

_KEYS = ("e_emb_rhf", "e_global", "e_act", "e_env", "two_e_cross", "converged")


class _TopK(torch.autograd.Function):
    """The projector onto the top-k eigenspace of symmetric ``m`` ([B,] n,
    n), with the reference's custom tangent (``embed_path.py:46-81``).

    SPADE needs the active subspace, not its singular vectors, and the
    subspace projector stays differentiable under degeneracies inside the
    active or the environment block (water: the O 1s and the out-of-plane
    lone pair both lie entirely on O, two singular values exactly 1, where
    the plain eigh tangent divides by a zero gap and gives NaN). The
    tangent keeps only the cross-gap response

        dP = sum_{i in act, a in env} (v_i v_a^T + h.c.)
             (v_i^T dM v_a) / (lam_i - lam_a),

    the exact derivative of the projector, which needs only the SPADE gap
    lam_k > lam_{k+1} open. The backward is the same map's adjoint.
    ``eigh`` diagonalises ``m``: ``torch.linalg.eigh`` eagerly, the
    capturable cuSOLVER call inside a program."""

    @staticmethod
    def forward(ctx, m, k, eigh):
        w, v = eigh(m)
        ctx.k = k
        ctx.save_for_backward(w, v)
        ctx.save_for_forward(w, v)
        vk = v[..., m.shape[-1] - k:]
        return vk @ vk.transpose(-1, -2)

    @staticmethod
    def _parts(ctx):
        w, v = ctx.saved_tensors
        nk = w.shape[-1] - ctx.k
        denom = w[..., None, nk:] - w[..., :nk, None]  # (n-k, k): the gap only
        return v[..., nk:], v[..., :nk], denom

    @staticmethod
    def jvp(ctx, m_dot, _k, _eigh):
        vk, vr, denom = _TopK._parts(ctx)
        g = (vr.transpose(-1, -2) @ m_dot @ vk) / denom
        half = vr @ g @ vk.transpose(-1, -2)
        return half + half.transpose(-1, -2)

    @staticmethod
    def backward(ctx, p_bar):
        vk, vr, denom = _TopK._parts(ctx)
        h = vr.transpose(-1, -2) @ (p_bar + p_bar.transpose(-1, -2)) @ vk
        m_bar = vr @ (h / denom) @ vk.transpose(-1, -2)
        return 0.5 * (m_bar + m_bar.transpose(-1, -2)), None, None


def _topk_projector(m, k: int, eigh=torch.linalg.eigh):
    """Projector onto the top-k eigenspace of symmetric ``m`` (see
    :class:`_TopK`)."""
    return _TopK.apply(m, k, eigh)


def _lane_build(n: int, xc, dual: bool):
    """``build`` of :func:`~nbed_tpu_torch.scf.engine.lane_scf` for the
    program's SCFs: J/K of "g_j"/"g_k" through the lane kernel (with
    forward-mode tangents where the operands carry them), and the XC of the
    AO tables "ao", "ao_grad", "w" where ``xc`` has grid terms, in its
    differentiable form for ``dual`` operands."""
    from ..dft.xc import make_xc_fn

    def build(t):
        xc_fn = None
        if xc is not None:
            xc_fn = make_xc_fn(t["ao"], t["ao_grad"], t["w"], xc, differentiable=dual)
        return _lanes_jk(forward_ad_jk(t["g_j"], t["g_k"]), n), xc_fn

    return build


def make_mu_embed_energy(mol: Molecule, n_active_atoms: int, n_act_mos, xc: str = "b3lyp",
                         mu_level_shift: float = 1e6, conv_tol: float = 1e-9,
                         dm_conv_tol: float = 1e-7, max_cycle: int = 100,
                         grid_level: int = 3, projector: str = "mu", grad_cycles: int = 0,
                         device="cuda", jit_kernel: str = "auto"):
    """Build ``energy(coords) -> dict``, the embedding program.

    Args:
        mol: molecule (atom and basis structure; the geometry comes per call).
        n_active_atoms: leading atoms forming the active fragment.
        n_act_mos: static active-MO count: an int, or a per-spin ``(n_alpha,
            n_beta)`` tuple (open shell).
        xc: environment functional: pure, global hybrid, or range-separated
            hybrid (the long-range exchange folded into the global KS's
            exchange as hyb * K + beta * K_LR, the engine's convention; the
            embedded HF keeps the unfolded K).
        mu_level_shift: the mu projector's shift.
        projector: "mu" (the level-shift projector in v_emb) or "huzinaga"
            (the -(FDS + SDF) operator inside the embedded SCF; its converged
            value is frozen into v_emb for the correction, as the driver
            does).
        grad_cycles: damped DIIS-free cycles after each SCF converges, for
            forward-mode tangents (see the module docstring).
        device: where the program runs; ``"cuda"`` unless the caller asks
            for the CPU.
        jit_kernel: how the program runs, as ``SCFEngine``'s: on a card
            (``"auto"``) primal coordinates run the global KS and the
            embedded HF as shared lane programs (CUDA graphs), and dual
            ones every stage as forward-mode programs (see the module
            docstring); "on" runs the programs uncaptured off a card,
            "off" everything eagerly.

    ``energy`` takes (natm, 3) or (B, natm, 3) coordinates in bohr (a
    tensor, dual under ``forward_ad`` for derivatives) and returns
    ``{"e_emb_rhf", "e_global", "e_act", "e_env", "two_e_cross",
    "converged"}``, 0-d or (B,) tensors.

    Raises:
        ValueError: for an unknown projector, or an ``n_act_mos`` above the
            occupied count or above the active-AO count (the SPADE block
            cannot have that many nonzero singular values: a zero gap and
            NaN derivatives).
    """
    if projector not in ("mu", "huzinaga"):
        raise ValueError(f"unknown projector {projector!r}")
    from ..dft.functionals import resolve_functional

    terms, hyb, rsh = resolve_functional(xc) if xc else ([], 1.0, None)
    dev = resolve_device(device)
    n_act_aos = int(mol.aoslice_by_atom()[n_active_atoms - 1][-1])
    n_occ = tuple(int(x) for x in mol.nelec)
    if np.ndim(n_act_mos) == 0:
        n_act = (int(n_act_mos), int(n_act_mos))
    else:
        n_act = (int(n_act_mos[0]), int(n_act_mos[1]))
    if any(n_act[s] > n_occ[s] for s in range(2)):
        raise ValueError(f"n_act_mos {n_act} exceeds occupied {n_occ}.")
    if any(n_act[s] > n_act_aos for s in range(2)):
        raise ValueError(
            f"n_act_mos {n_act} exceeds the active-AO count {n_act_aos}: "
            "the SPADE overlap block cannot have that many nonzero "
            "singular values (zero gap -> NaN geometry derivatives).")
    scf_kw = dict(conv_tol=conv_tol, dm_conv_tol=dm_conv_tol, max_cycle=max_cycle,
                  grad_cycles=grad_cycles)
    n = mol.nao
    hyb_xc = 1.0 if rsh is not None else hyb
    grid_terms = xc if terms else None
    ks_spec = lane_spec(mol, "embed_ks", xc, grid_level, hyb_xc)
    hf_spec = lane_spec(mol, "embed_hf")
    run = dict(jit_kernel=jit_kernel, **scf_kw)

    def operators(x, program: bool) -> dict:
        """The operators at (B, natm, 3) ``x``: "s", "hcore", "g_j", "g_k"
        (HF exchange), "g_k_xc" (the global KS's, the long range folded
        in), and the grid's "ao", "ao_grad", "w" where ``xc`` has grid
        terms; with ``program`` from the forward-mode programs of the
        integrals and tables, else eagerly."""
        jit = jit_kernel if program else "off"

        def eris(omega=None):
            if program:
                return eri_program(mol, x, omega=omega, jit_kernel=jit)
            return eri_tensor(mol, x, omega=omega, device=dev)

        with span("lanes.core"):
            s, hcore = core_program(mol, x, jit)
        with span("lanes.eri"):
            eri = eris()
        with span("lanes.supermatrices"):
            g_j, g_k = _supermatrices(eri)
        ops = {"s": s, "hcore": hcore, "g_j": g_j, "g_k": g_k, "g_k_xc": g_k}
        if rsh is not None:
            with span("lanes.eri"):
                eri_lr = eris(rsh[1])
            with span("lanes.supermatrices"):
                ops["g_k_xc"] = hyb * g_k + rsh[0] * _supermatrices(eri_lr)[1]
        if terms:
            with span("lanes.tables"):
                tables = tables_program(mol, x, level=grid_level, jit_kernel=jit)
            ops.update(ao=tables["ao"], ao_grad=tables["ao_grad"], w=tables["w"])
        return ops

    def subsystem(c, s, hcore, g_j, g_k, x, eigh, dual, ao=None, ao_grad=None,
                  w=None) -> dict:
        """SPADE and the subsystem-DFT decomposition from the global KS
        orbitals ``c`` (B, 2, n, n): the active and environment densities,
        the embedded HF's potential ("v_emb": the mu shift's, or the
        Huzinaga SCF's frozen part), e_act, e_env, two_e_cross and the
        nuclear repulsion. Tensors only (a tangent program's body);
        ``eigh`` diagonalises S and the SPADE block, ``dual`` takes the
        differentiable XC closure."""
        jk_xc, xc_fn = _lane_build(n, grid_terms, dual)(
            {"g_j": g_j, "g_k": g_k, "ao": ao, "ao_grad": ao_grad, "w": w})
        # SPADE with a static active count: the top-k right-singular
        # subspace of the active-AO rows, as a projector
        w_s, v_s = eigh(s)
        s_half = (v_s * torch.sqrt(w_s)[..., None, :]) @ v_s.transpose(-1, -2)

        def spade(c_spin, n_o, k):
            occ_c = c_spin[..., :n_o]
            a = (s_half @ occ_c)[:, :n_act_aos, :]
            p = _topk_projector(a.transpose(-1, -2) @ a, k, eigh)
            dm_a = occ_c @ p @ occ_c.transpose(-1, -2)
            return dm_a, occ_c @ occ_c.transpose(-1, -2) - dm_a

        parts = [spade(c[:, sp], n_occ[sp], n_act[sp]) for sp in range(2)]
        dm_act = torch.stack([p[0] for p in parts], dim=1)
        dm_env = torch.stack([p[1] for p in parts], dim=1)
        e_nuc = mol.energy_nuc_tensor(x)

        def veff_parts(dm):
            j, k = jk_xc(dm)
            if xc_fn is not None:
                exc, vxc = xc_fn(dm)
            else:
                exc, vxc = torch.zeros_like(e_nuc), torch.zeros_like(dm)
            v = j[:, None] + vxc - hyb_xc * k
            d_tot = dm[:, 0] + dm[:, 1]
            ecoul = 0.5 * torch.einsum("bij,bji->b", j, d_tot)
            exc = exc - 0.5 * hyb_xc * torch.einsum("bsij,bsji->b", k, dm)
            e = torch.einsum("bij,bji->b", hcore, d_tot) + ecoul + exc
            return e, v, exc, j

        e_act, v_act, exc_act, j_act = veff_parts(dm_act)
        e_env, v_env, exc_env, j_env = veff_parts(dm_env)
        _, v_tot, exc_tot, _ = veff_parts(dm_act + dm_env)
        j_cross = 0.5 * (torch.einsum("bsij,bij->b", dm_act, j_env)
                         + torch.einsum("bsij,bij->b", dm_env, j_act))
        two_e_cross = j_cross + (exc_tot - exc_act - exc_env)
        v_emb = v_tot - v_act
        if projector == "mu":
            p_env = torch.einsum("bij,bsjk,bkl->bsil", s, dm_env, s)
            v_emb = mu_level_shift * p_env + v_emb
        return {"dm_act": dm_act, "dm_env": dm_env, "v_emb": v_emb, "e_act": e_act,
                "e_env": e_env, "two_e_cross": two_e_cross, "e_nuc": e_nuc}

    def subsystem_program(inputs: dict) -> dict:
        """:func:`subsystem` as the tangent program of kind "embed_subsystem"
        (one per structure, functional and lane count), its J/K prepared on
        its own supermatrix buffers."""
        shapes = tuple((name, tuple(t.shape)) for name, t in inputs.items())
        key = ("embed_subsystem", structure_key(mol), shapes, xc, grid_level, n_active_atoms,
               n_act, projector, float(mu_level_shift))

        def build(device, pool):
            prog = TangentProgram("embed_subsystem", inputs,
                                  partial(subsystem, eigh=eigh_ops.eigh_jvp, dual=True), device,
                                  pool)
            b = prog.inputs
            # the J/K that the body's forward_ad_jk finds, and the nuclear
            # repulsion's tables, which the graph reads by address
            prog.holds = (TangentJK(b["g_j"][0], b["g_k"][0], b["g_j"][1], b["g_k"][1]),
                          _nuclear_tables(mol, device))
            return prog

        return derivative_program(key, dev, build)(**inputs)

    def energy(coords):
        x = torch.as_tensor(coords, dtype=DTYPE).to(dev)
        single = x.ndim == 2
        if single:
            x = x[None]
        dual = has_tangent(x)
        # forward-mode tangents run as programs where jit_kernel takes them
        program = dual and takes_program(jit_kernel, (x,), tangent=True)
        if dual:
            RUNS["embed_tangent_program" if program else "embed_tangent_eager"] += 1
        with span("embed.operators"):
            ops = operators(x, program)
        ks_ops = {"hcore": ops["hcore"], "s": ops["s"], "g_j": ops["g_j"],
                  "g_k": ops["g_k_xc"]}
        ks_ops.update({name: ops[name] for name in ("ao", "ao_grad", "w") if name in ops})
        hf_ops = {name: ops[name] for name in ("hcore", "s", "g_j", "g_k")}

        # global KS (the driver's _global_ks)
        with span("embed.global_ks"):
            glob = lane_scf(ks_spec, ks_ops, _lane_build(n, grid_terms, dual), hyb=hyb_xc,
                            nelec=n_occ, **run)

        with span("embed.spade_subsystem"):
            inputs = {"c": glob.mo_coeff, "x": x, **ks_ops}
            if program:
                sub = subsystem_program(inputs)
            else:
                eigh = eigh_ops.eigh_jvp if dual and hf._EAGER_EIGH_JVP else torch.linalg.eigh
                sub = subsystem(eigh=eigh, dual=dual, **inputs)
        e_global = glob.e_elec + sub["e_nuc"]

        # embedded HF
        with span("embed.embedded_hf"):
            hf_build = _lane_build(n, None, dual)
            if projector == "mu":
                emb = lane_scf(hf_spec, hf_ops, hf_build, nelec=n_act, v_emb=sub["v_emb"],
                               dm0=sub["dm_act"], **run)
                v_corr = sub["v_emb"]
            else:
                emb = lane_scf(hf_spec, hf_ops, hf_build, nelec=n_act, v_emb=sub["v_emb"],
                               dm_env_occ=sub["dm_env"], dm0=sub["dm_act"], **run)
                v_corr = emb.huzinaga_op + sub["v_emb"]
        corr = torch.einsum("bsij,bsij->b", v_corr, sub["dm_act"])
        e_emb = emb.e_elec + sub["e_nuc"] + sub["e_env"] + sub["two_e_cross"] - corr
        out = dict(zip(_KEYS, (e_emb, e_global, sub["e_act"], sub["e_env"],
                               sub["two_e_cross"], glob.converged & emb.converged)))
        # copies: a program's outputs are its buffers, which its next call
        # overwrites
        return {k: (v[0] if single else v).clone() for k, v in out.items()}

    return energy


def batched_embedding_energies(mol: Molecule, coords_batch, n_active_atoms: int, n_act_mos,
                               mesh=None, device="cuda", **kwargs):
    """Embedded energies of a conformer batch: ``coords_batch`` (B, natm, 3)
    bohr in lane groups over the mesh's 'batch' axis (all on ``device``
    without a mesh), each group one run of :func:`make_mu_embed_energy`'s
    program over its lanes. Returns the dict of (B,) outputs, on the
    mesh's first device (or ``device``). Coordinates that carry a
    forward-mode tangent keep it: each group's B tangents run in one pass,
    and the outputs carry theirs."""
    if has_tangent(coords_batch):
        x = coords_batch.to(DTYPE)
        devices = [resolve_device(device)] if mesh is None else \
            [mesh.devices[i, 0] for i in range(mesh.shape["batch"])]
        groups = [(dev, part.to(dev)) for dev, part in
                  zip(devices, torch.tensor_split(x, len(devices))) if len(part)]
    else:
        groups = _lane_groups(coords_batch, mesh, device)
    parts = [make_mu_embed_energy(mol, n_active_atoms, n_act_mos, device=dev, **kwargs)(x)
             for dev, x in groups]
    out_dev = resolve_device(device) if mesh is None else mesh.devices[0, 0]
    return {k: torch.cat([p[k].to(out_dev) for p in parts]) for k in _KEYS}
