"""Ideal-gas RRHO thermochemistry from harmonic frequencies (port of
``nbed_tpu/solvers/thermo.py``; host numpy, as there).

Standard rigid-rotor / harmonic-oscillator partition functions: ZPE,
thermal corrections to U/H/G and entropies per degree of freedom. Energies
are returned in Hartree (per molecule), entropies in Hartree/K; the
conventional cal/(mol K) value is ``s * HA_PER_K_TO_CAL_MOL_K``.
"""

from __future__ import annotations

import numpy as np

from ..chem.masses import AMU_TO_ME, atom_masses_me

__all__ = ["thermochemistry", "HA_PER_K_TO_CAL_MOL_K"]

# physical constants (SI, CODATA 2018)
_H_SI = 6.62607015e-34  # J s
_KB_SI = 1.380649e-23  # J / K
_NA = 6.02214076e23
_AMU_KG = 1.66053906660e-27
_BOHR_M = 0.529177210903e-10
_HARTREE_J = 4.3597447222071e-18

KB_HA = _KB_SI / _HARTREE_J  # Hartree per Kelvin
CM_TO_HA = 1.0 / 219474.6313705
HA_PER_K_TO_CAL_MOL_K = _HARTREE_J * _NA / 4.184  # -> cal/(mol K)


def _principal_moments_si(mol, coords):
    """Principal moments of inertia in kg m^2."""
    m = (atom_masses_me(mol) / AMU_TO_ME) * _AMU_KG
    r = np.asarray(coords) * _BOHR_M
    com = (m @ r) / m.sum()
    r = r - com
    inertia = np.zeros((3, 3))
    for ma, ra in zip(m, r):
        inertia += ma * (np.dot(ra, ra) * np.eye(3) - np.outer(ra, ra))
    return np.linalg.eigvalsh(inertia)


def thermochemistry(
    mol,
    freqs_cm,
    coords=None,
    temperature: float = 298.15,
    pressure: float = 101325.0,
    symmetry_number: int = 1,
    spin_degeneracy: int = 1,
    freq_cutoff: float = 30.0,
):
    """RRHO thermochemistry from harmonic frequencies (cm^-1).

    ``freqs_cm`` is the full (3N,) spectrum from
    :func:`~nbed_tpu_torch.solvers.hessian.harmonic_frequencies`; entries with
    ``|f| < freq_cutoff`` (the projected TR modes) are skipped and
    imaginary (negative) frequencies are ignored with the count reported.
    Returns a dict of Hartree quantities: ``zpe``, ``e_therm`` (U - E_elec),
    ``h_therm``, ``g_therm``, per-dof entropies ``s_trans/s_rot/s_vib/
    s_elec`` and ``s_tot`` (Hartree/K), plus ``n_imaginary``.
    """
    t = temperature
    x0 = np.asarray(mol.coords if coords is None else coords, dtype=np.float64)
    freqs = np.asarray(freqs_cm, dtype=np.float64)
    vib = freqs[np.abs(freqs) >= freq_cutoff]
    n_imag = int(np.sum(vib < 0))
    vib = vib[vib > 0]

    # --- translation (Sackur-Tetrode) ---
    m_kg = float((atom_masses_me(mol) / AMU_TO_ME).sum()) * _AMU_KG
    q_trans = (2.0 * np.pi * m_kg * _KB_SI * t / _H_SI**2) ** 1.5 * (
        _KB_SI * t / pressure
    )
    s_trans = KB_HA * (np.log(q_trans) + 2.5)
    u_trans = 1.5 * KB_HA * t

    # --- rotation (classical RR) ---
    moments = _principal_moments_si(mol, x0)
    theta = np.array([
        _H_SI**2 / (8.0 * np.pi**2 * _KB_SI * mi) if mi > 1e-60 else np.inf
        for mi in moments
    ])
    linear = bool(np.min(moments) < 1e-3 * np.max(moments)) or mol.natm <= 2
    if mol.natm == 1:
        s_rot = 0.0
        u_rot = 0.0
    elif linear:
        i_perp = float(np.max(moments))
        theta_r = _H_SI**2 / (8.0 * np.pi**2 * _KB_SI * i_perp)
        q_rot = t / (symmetry_number * theta_r)
        s_rot = KB_HA * (np.log(q_rot) + 1.0)
        u_rot = KB_HA * t
    else:
        q_rot = (np.sqrt(np.pi) / symmetry_number) * np.sqrt(
            t**3 / float(np.prod(theta))
        )
        s_rot = KB_HA * (np.log(q_rot) + 1.5)
        u_rot = 1.5 * KB_HA * t

    # --- vibration (HO per mode) ---
    theta_v = vib * CM_TO_HA / KB_HA  # K
    x = theta_v / t
    expm1 = np.expm1(x)
    zpe = float(0.5 * np.sum(vib) * CM_TO_HA)
    u_vib = float(zpe + KB_HA * np.sum(theta_v / expm1))
    s_vib = float(KB_HA * np.sum(x / expm1 - np.log1p(-np.exp(-x))))

    s_elec = KB_HA * np.log(float(spin_degeneracy))

    e_therm = u_trans + u_rot + u_vib
    h_therm = e_therm + KB_HA * t
    s_tot = s_trans + s_rot + s_vib + s_elec
    g_therm = h_therm - t * s_tot
    return {
        "temperature": t,
        "pressure": pressure,
        "zpe": zpe,
        "e_therm": e_therm,
        "h_therm": h_therm,
        "g_therm": g_therm,
        "s_trans": float(s_trans),
        "s_rot": float(s_rot),
        "s_vib": s_vib,
        "s_elec": float(s_elec),
        "s_tot": float(s_tot),
        "n_imaginary": n_imag,
    }
