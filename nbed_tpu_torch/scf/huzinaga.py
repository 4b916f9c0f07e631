"""Standalone Huzinaga SCF (port of ``nbed_tpu/scf/huzinaga.py``).

The Huzinaga projector is a term of the SCF loop, so this routes through
:func:`nbed_tpu_torch.scf.hf.run_scf` with the engine's J/K (the fused
kernel on the exact route, DF on a density-fitted engine) and reshapes
restricted inputs (total densities, one potential) to the spin-resolved
convention and back.
"""

import torch

from .hf import run_scf

__all__ = ["huzinaga_scf"]


def huzinaga_scf(
    scf_engine,
    embedding_potential,
    dm_environment_occupied,
    dm_environment_virtual=None,
    dm_conv_tol: float = 1e-6,
    dm_initial_guess=None,
    use_diis: bool = True,
    nelec=None,
):
    """Run SCF with the Huzinaga projector -(FDS + SDF).

    Args:
        scf_engine: an :class:`nbed_tpu_torch.scf.SCFEngine` (HF or KS); the
            run takes its device, operators, ``conv_tol`` and ``max_cycle``.
        embedding_potential: (n, n) for restricted, or (2, n, n).
        dm_environment_occupied: environment density, the *total* (n, n)
            for restricted (halved per spin) or per-spin (2, n, n).
        dm_environment_virtual: optional virtual-space projector density,
            in the same convention.
        dm_initial_guess: optional density guess, in the same convention.
        use_diis: Pulay DIIS on the Fock matrix (False: plain Roothaan).
        nelec: optional (n_alpha, n_beta) override.

    Returns:
        (mo_coeff, mo_energy, density_matrix, huzinaga_op, converged) on the
        engine's device: for restricted inputs the alpha orbitals, energies
        and operator with the spin-summed density, as the reference returns
        them (``nbed_tpu/scf/huzinaga.py:77-84``); else per spin.
    """
    eng = scf_engine
    v_emb = eng._tensor(embedding_potential)
    restricted = v_emb.ndim == 2
    if restricted:
        v_emb = torch.stack([v_emb, v_emb])  # the same potential, both spins

    def expand(x):
        if x is None:
            return None
        x = eng._tensor(x)
        return torch.stack([x, x]) * 0.5 if x.ndim == 2 else x

    xc_fn, hyb = eng._xc
    res = run_scf(
        hcore=eng.hcore, s=eng.s, jk_fn=eng.get_jk,
        nelec=eng.mol.nelec if nelec is None else nelec,
        v_emb=v_emb, xc_fn=xc_fn, hyb=hyb,
        dm_env_occ=expand(dm_environment_occupied),
        dm_env_virt=expand(dm_environment_virtual),
        dm0=expand(dm_initial_guess),
        conv_tol=eng.conv_tol, dm_conv_tol=dm_conv_tol,
        max_cycle=eng.max_cycle, use_diis=use_diis,
    )
    conv = bool(res.converged)
    if restricted:
        return (res.mo_coeff[0], res.mo_energy[0], res.dm[0] + res.dm[1],
                res.huzinaga_op[0], conv)
    return res.mo_coeff, res.mo_energy, res.dm, res.huzinaga_op, conv
