"""Smoke run of nbed_tpu_torch on one CUDA card.

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card (the fused J/K kernel also on
CAM-B3LYP's range-separated exchange operator), then drives the embedding
pipeline end to end through ``nbed_tpu_torch.nbed(..., device="cuda")`` on
water (both projectors, CCSD and FCI) and on the acetonitrile configuration
of the PRA 109, 022418 notebook (28-qubit embedded register).

The functional surface follows: water's global UKS for every registered
functional, a composition string and B2PLYP's PT2 term; ROHF and ROKS of
the methyl radical; water embedded beside a TIP3P water of MM charges; the
acetonitrile configuration with CAM-B3LYP (exact ERIs, folded exchange
through the fused kernel); and pfoa (C8HF15O2, 126 AOs, where density
fitting switches itself on) with wB97X, whose DF route builds a second,
long-range factor. Last comes pfoa with B3LYP; on its converged global
density the script also holds streaming XC against table XC and the
chunked DF exchange against the unchunked one, and times DF J, DF K and
both XC paths. Every energy is checked against the reference values.

    python3 chip_smoke.py

Every phase raises on failure. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit, and the one before that lists each kernel with its launches in
the pipeline runs, its error against the plain version and both times.
Exits non-zero, printing no result, where CUDA is unavailable.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the package sits beside this script; nothing is installed
sys.path.insert(0, str(Path(__file__).resolve().parent))

MOLECULES = Path(__file__).resolve().parent / "tests" / "molecules"
WATER = MOLECULES / "water.xyz"
PFOA = MOLECULES / "pfoa.xyz"
METHYL = MOLECULES / "methyl_radical.xyz"

# acetonitrile exactly as in scripts/qubit_reduction.py (the notebook input)
ACETONITRILE = """6

N\t1.2608\t0\t0
C\t0.1006\t0\t0
C\t-1.3613\t0\t0
H\t-1.75\t-0.8301\t0.5974
H\t-1.7501\t-0.1022\t-1.0175
H\t-1.75\t0.9324\t0.4202
"""

# Reference oracles (tests/test_driver.py:18,70,97; BASELINE.md).
E_UKS_WATER = -75.3091447400438
E_CCSD_WATER = -75.1285849238916
E_FCI_WATER = -75.12858550813999
# nbed_tpu (JAX, float64, CPU) on the acetonitrile config below, from
#   JAX_PLATFORMS=cpu python -c "from nbed_tpu.driver import NbedDriver;
#   from nbed_tpu.config import NbedConfig; d = NbedDriver(NbedConfig(
#   geometry=<ACETONITRILE>, n_active_atoms=2, basis='STO-3G',
#   xc_functional='b3lyp5', projector='huzinaga', localization='spade',
#   convergence=1e-6, run_ccsd_emb=True)); d.embed();
#   print(d.huzinaga['e_rhf'], d.huzinaga['e_ccsd'])"
E_RHF_PRA = -130.51128805379804
E_CCSD_PRA = -130.6684176145549
# nbed_tpu (JAX, float64, CPU; density fitting on by itself at nao 126) on
# the pfoa config of run_pfoa, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "from nbed_tpu.driver import
#   NbedDriver; from nbed_tpu.config import NbedConfig; d = NbedDriver(
#   NbedConfig(geometry=open('tests/molecules/pfoa.xyz').read(),
#   n_active_atoms=4, basis='STO-3G', xc_functional='b3lyp', projector='mu',
#   localization='spade', convergence=1e-6, run_ccsd_emb=True)); d.embed();
#   print(d._global_ks.e_tot, d.mu['e_rhf'], d.mu['classical_energy'],
#   d.mu['e_ccsd'])"
E_UKS_PFOA = -1925.6431337201911
E_RHF_PFOA = -1924.6777805286401
E_CLASSICAL_PFOA = -1581.701690045898
E_CCSD_PFOA = -1924.6909046358996
# nbed_tpu on the same pfoa config with xc_functional='wb97x' (the same
# command with that one change; 390 s on the development host's CPU)
E_UKS_PFOA_WB97X = -1923.966896517335
E_RHF_PFOA_WB97X = -1922.9938095727239
E_CLASSICAL_PFOA_WB97X = -1579.8907780051159
E_CCSD_PFOA_WB97X = -1923.0074018645487
# nbed_tpu, water/STO-3G global UKS of every registered functional and of
# one composition string, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "from nbed_tpu.chem import
#   build_molecule; from nbed_tpu.scf.engine import SCFEngine; mol =
#   build_molecule(open('tests/molecules/water.xyz').read(), 'sto-3g');
#   print(SCFEngine(mol, xc=NAME, **WATER_SCF).kernel().e_tot)"
# and, for B2PLYP, nbed_tpu.solvers.run_double_hybrid of that solution
WATER_SCF = dict(conv_tol=1e-9, dm_conv_tol=1e-7, max_cycle=100)
COMPOSITION = "0.25*HF + 0.75*PBE, PBE"
E_WATER = {
    "b2gpplyp": -75.16876905139277, "b2plyp": -75.19605821116586,
    "b3lyp": -75.3091448156704, "b3lyp5": -75.2718529416598,
    "blyp": -75.27355414131857, "camb3lyp": -75.27651129206019,
    "hf": -74.96099960308739, "lcblyp": -75.13156528260443,
    "lda": -74.72858356085497, "pbe": -74.64894147268018,
    "pbe0": -74.81294460685496, "pw92": -74.72565834359791,
    "scan": -75.29136854906154, "scan0": -75.28859970884325,
    "svwn": -74.72858356085497, "tpss": -75.32293726424626,
    "tpssh": -75.32113489427081, "wb97": -75.29774409315307,
    "wb97x": -75.25030270029812, COMPOSITION: -74.81294460685496,
}
E_B2PLYP_DH_WATER = -75.2077787408571
# nbed_tpu, methyl radical/STO-3G (spin 1) with rohf=True: ROHF at
# conv_tol=1e-10, dm_conv_tol=1e-8 and ROKS (xc='b3lyp') at WATER_SCF, the
# settings of tests/test_rohf.py, max_cycle=100
ROHF_SCF = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)
E_ROHF_METHYL = -37.6723280856005
E_ROKS_METHYL = -37.94155764249537
# nbed_tpu's NbedDriver on CONFIGS["water_qmmm"] and
# CONFIGS["acetonitrile_camb3lyp"] (the commands above with those configs)
E_UKS_QMMM = -75.3172751129991
E_RHF_QMMM = -75.13101779540804
E_CCSD_QMMM = -75.13566086596478
E_RHF_PRA_CAM = -130.51789932942617
E_CCSD_PRA_CAM = -130.67543341307274

# the nbed() arguments of each pipeline phase (scripts/profile_port.py
# profiles the same configurations)
CONFIGS = {
    "water": dict(geometry=str(WATER), n_active_atoms=1, basis="STO-3G",
                  xc_functional="b3lyp", projector="both", localization="spade",
                  convergence=1e-6, run_ccsd_emb=True, run_fci_emb=True),
    # the PRA 109, 022418 notebook (scripts/qubit_reduction.py:42-50)
    "acetonitrile": dict(geometry=ACETONITRILE, n_active_atoms=2, basis="STO-3G",
                         xc_functional="b3lyp5", projector="huzinaga",
                         localization="spade", convergence=1e-6, run_ccsd_emb=True),
    # scripts/pfoa_pipeline.py:40-50 with CCSD on
    "pfoa": dict(geometry=str(PFOA), n_active_atoms=4, basis="STO-3G",
                 xc_functional="b3lyp", projector="mu", localization="spade",
                 convergence=1e-6, run_ccsd_emb=True),
}
# water in the field of a TIP3P water (O -0.834, H +0.417; Jorgensen et al.,
# JCP 79, 926 (1983)), O-O 2.9 angstrom, Gaussian radii as given
CONFIGS["water_qmmm"] = dict(
    geometry=str(WATER), n_active_atoms=1, basis="STO-3G", xc_functional="b3lyp",
    projector="mu", localization="spade", convergence=1e-6, run_ccsd_emb=True,
    mm_coords=[[0.0, 0.0, 3.0], [0.0, 0.0, 2.0428], [0.9266, 0.0, 3.2397]],
    mm_charges=[-0.834, 0.417, 0.417], mm_radii=[0.8, 0.4, 0.4])
CONFIGS["acetonitrile_camb3lyp"] = {**CONFIGS["acetonitrile"], "xc_functional": "camb3lyp"}
CONFIGS["pfoa_wb97x"] = {**CONFIGS["pfoa"], "xc_functional": "wb97x"}

# kernel-vs-plain tolerances, as in tests/test_ops.py:25-26 for float32
TOLERANCES = {torch.float64: (1e-12, 1e-10), torch.float32: (1e-5, 1e-4)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median per-call time of ``fn`` on the card, with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def jk_cases():
    """(label, g_j, g_k, dm) in float64 on the card: the real ERI
    supermatrices of water and acetonitrile STO-3G, acetonitrile's
    CAM-B3LYP exchange operator 0.19 (ik|jl) + 0.46 (ik|jl)_LR(0.33), the
    methyl radical's (M = 64, the shape of its ROHF/ROKS launches), the
    supermatrices of pfoa's SAD atoms (C, F, O: M = 25; H: M = 1, the shapes
    of pfoa's launches), and seeded random symmetric ones at nao = 64."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import SCFEngine

    rng = np.random.default_rng(11)
    cases = []
    atoms = tuple((f"pfoa SAD {el}", f"1\n\n{el} 0.0 0.0 0.0", 0) for el in "CFOH")
    for label, xyz, spin in (("water", WATER.read_text(), 0),
                             ("acetonitrile", ACETONITRILE, 0),
                             ("methyl radical", METHYL.read_text(), 1), *atoms):
        eng = SCFEngine(build_molecule(xyz, "sto-3g", spin=spin), device="cuda")
        n = eng.mol.nao
        dm = rng.standard_normal((2, n, n))
        dm = 0.5 * (dm + dm.swapaxes(-1, -2))
        cases.append((label, eng.eri_j, eng.eri_k,
                      torch.tensor(dm, dtype=torch.float64, device="cuda")))
        if label == "acetonitrile":
            cam = SCFEngine(eng.mol, xc="camb3lyp", device="cuda")
            cases.append(("acetonitrile camb3lyp folded K", cam.eri_j, cam.eri_k,
                          cases[-1][3]))
    n = 64
    m = n * n
    g = rng.standard_normal((2, m, m))
    g = 0.5 * (g + g.swapaxes(-1, -2))
    dm = rng.standard_normal((2, n, n))
    dm = 0.5 * (dm + dm.swapaxes(-1, -2))
    cases.append(("random nao=64",
                  torch.tensor(g[0], device="cuda"), torch.tensor(g[1], device="cuda"),
                  torch.tensor(dm, device="cuda")))
    return cases


def check_kernels() -> list:
    """Kernel against plain version at every case and dtype; returns rows."""
    from nbed_tpu_torch.ops.jk import fused_jk, fused_jk_reference

    rows = []
    for label, gj64, gk64, dm64 in jk_cases():
        for dtype in (torch.float64, torch.float32):
            gj, gk, dm = (t.to(dtype).contiguous() for t in (gj64, gk64, dm64))
            j, k = fused_jk(gj, gk, dm)
            j_ref, k_ref = fused_jk_reference(gj, gk, dm)
            torch.cuda.synchronize()
            rtol, atol = TOLERANCES[dtype]
            err = max(float(torch.max(torch.abs(j - j_ref))),
                      float(torch.max(torch.abs(k - k_ref))))
            if not (torch.isfinite(j).all() and torch.isfinite(k).all()):
                raise RuntimeError(f"fused_jk {label} {dtype}: non-finite output")
            if not (torch.allclose(j, j_ref, rtol=rtol, atol=atol)
                    and torch.allclose(k, k_ref, rtol=rtol, atol=atol)):
                raise RuntimeError(f"fused_jk {label} {dtype}: max abs err {err} "
                                   f"exceeds rtol={rtol}, atol={atol}")
            ms = median_ms(lambda: fused_jk(gj, gk, dm))
            plain_ms = median_ms(lambda: fused_jk_reference(gj, gk, dm))
            row = {"case": label, "m": int(dm.shape[-1]) ** 2,
                   "dtype": str(dtype).removeprefix("torch."),
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            print("fused_jk", json.dumps(row), flush=True)
            rows.append(row)
    return rows


def _gate(label, pairs, tol):
    """Raise unless every (key, ours, reference) pair is finite and within
    ``tol``."""
    for key, ours, ref in pairs:
        if not np.isfinite(ours) or abs(ours - ref) > tol:
            raise RuntimeError(f"{label} {key} {ours} vs reference {ref} (tol {tol})")


def run_water():
    from nbed_tpu_torch import nbed

    t0 = time.perf_counter()
    driver = nbed(**CONFIGS["water"], device="cuda")
    wall = time.perf_counter() - t0
    e_uks = driver._global_ks.e_tot
    _gate("water", [("global UKS", e_uks, E_UKS_WATER)], 2e-7)
    for name, res in (("mu", driver.mu), ("huzinaga", driver.huzinaga)):
        _gate(f"water {name}", [("e_ccsd", res["e_ccsd"], E_CCSD_WATER),
                                ("e_fci", res["e_fci"], E_FCI_WATER)], 1e-5)
        _, h1, h2 = res["second_quantised"]
        k = h1.shape[0]
        if tuple(h2.shape) != (k, k, k, k) or not torch.isfinite(h2).all():
            raise RuntimeError(f"water {name}: malformed second-quantised output")
    mu_scf, huz_scf = driver.embedded_scf
    if not (mu_scf.converged and huz_scf.converged) or \
            abs(mu_scf.e_tot - huz_scf.e_tot) > 1e-5:
        raise RuntimeError(f"water mu/huzinaga embedded SCFs disagree: "
                           f"{mu_scf.e_tot} vs {huz_scf.e_tot}")
    print("water", json.dumps({
        "wall_s": wall, "e_uks": e_uks,
        "mu": {k: driver.mu[k] for k in ("e_rhf", "e_ccsd", "e_fci")},
        "huzinaga": {k: driver.huzinaga[k] for k in ("e_rhf", "e_ccsd", "e_fci")},
        "stages_s": driver.timings}), flush=True)
    return driver


def run_pfoa():
    """pfoa as scripts/pfoa_pipeline.py runs it, with CCSD on."""
    from nbed_tpu_torch import nbed

    t0 = time.perf_counter()
    driver = nbed(**CONFIGS["pfoa"], device="cuda")
    wall = time.perf_counter() - t0
    ks, hf = driver._ks_engine, driver._hf_engine
    if not (driver._use_df and ks.density_fitting and hf.density_fitting):
        raise RuntimeError("pfoa (nao 126) did not switch density fitting on")
    if hf.df_b is not ks.df_b:
        raise RuntimeError("pfoa: the HF and KS engines built two DF factors")
    res = driver.mu
    if not (driver._global_ks.converged and res["scf"].converged):
        raise RuntimeError("pfoa: global UKS or embedded SCF did not converge")
    qubits = res["second_quantised"][1].shape[0]
    if qubits != 78:
        raise RuntimeError(f"pfoa embedded register {qubits} spin orbitals, expected 78")
    _gate("pfoa", [("e_uks", driver._global_ks.e_tot, E_UKS_PFOA),
                   ("e_rhf", res["e_rhf"], E_RHF_PFOA),
                   ("classical_energy", res["classical_energy"], E_CLASSICAL_PFOA),
                   ("e_ccsd", res["e_ccsd"], E_CCSD_PFOA)], 1e-6)
    b = ks.df_b
    print("pfoa", json.dumps({
        "wall_s": wall, "nao": ks.mol.nao, "naux": b.shape[1],
        "df_b_gb": b.numel() * b.element_size() / 1e9,
        "df_build_s": ks.df_timings, "qubits": qubits,
        "e_uks": driver._global_ks.e_tot, "e_rhf": res["e_rhf"],
        "classical_energy": res["classical_energy"], "e_ccsd": res["e_ccsd"],
        "stages_s": driver.timings}), flush=True)
    return driver


def check_pfoa_df_and_xc(driver):
    """At pfoa's factor and converged global density: chunked against
    unchunked DF exchange, streaming against table XC, and the times of
    DF J, DF K and both XC paths."""
    from nbed_tpu_torch.dft import make_xc_fn_streaming
    from nbed_tpu_torch.scf.engine import _df_j, _df_k_spin

    eng = driver._ks_engine
    b, chunk = eng.df_b, eng._df_chunk_elems
    nao, naux = b.shape[0], b.shape[1]
    dm = driver._global_ks.make_rdm1()
    k_err = max(float(torch.max(torch.abs(
        _df_k_spin(b, dm[s], chunk) - _df_k_spin(b, dm[s], nao * nao * naux))))
        for s in (0, 1))
    if not k_err <= 1e-10:
        raise RuntimeError(f"pfoa chunked DF-K vs unchunked: max abs {k_err}")

    points, weights = eng._grid
    if points.shape[0] * nao > eng._XC_TABLE_LIMIT:
        raise RuntimeError("pfoa's engine is not on the table XC path")
    table = eng.xc_fn
    stream = make_xc_fn_streaming(eng.mol, points, weights, eng.xc)
    exc_t, vxc_t = table(dm)
    exc_s, vxc_s = stream(dm)
    exc_err = abs(float(exc_t - exc_s))
    vxc_err = float(torch.max(torch.abs(vxc_t - vxc_s)))
    if not (exc_err <= 1e-10 and vxc_err <= 1e-10):
        raise RuntimeError(f"pfoa streaming vs table XC: |dexc| {exc_err}, "
                           f"max |dvxc| {vxc_err}")
    print("pfoa_df_xc", json.dumps({
        "k_chunk_aux": naux if nao * nao * naux <= chunk else max(256, chunk // (nao * nao)),
        "k_chunked_vs_unchunked": k_err,
        "exc_stream_vs_table": exc_err, "vxc_stream_vs_table": vxc_err,
        "grid_points": points.shape[0],
        "df_j_ms": median_ms(lambda: _df_j(b, dm[0] + dm[1]), reps=20),
        "df_k_ms": median_ms(lambda: (_df_k_spin(b, dm[0], chunk),
                                      _df_k_spin(b, dm[1], chunk)), reps=20),
        "xc_table_ms": median_ms(lambda: table(dm), reps=5, warmup=1),
        "xc_stream_ms": median_ms(lambda: stream(dm), reps=5, warmup=1),
    }), flush=True)


def run_acetonitrile():
    from nbed_tpu_torch import nbed

    t0 = time.perf_counter()
    driver = nbed(**CONFIGS["acetonitrile"], device="cuda")
    wall = time.perf_counter() - t0
    res = driver.huzinaga
    qubits = res["second_quantised"][1].shape[0]
    if qubits != 28:
        raise RuntimeError(f"acetonitrile embedded register {qubits} qubits, expected 28")
    _gate("acetonitrile", [("e_rhf", res["e_rhf"], E_RHF_PRA),
                           ("e_ccsd", res["e_ccsd"], E_CCSD_PRA)], 1e-6)
    print("acetonitrile", json.dumps({
        "wall_s": wall, "qubits": qubits, "e_rhf": res["e_rhf"],
        "e_ccsd": res["e_ccsd"], "stages_s": driver.timings}), flush=True)
    return driver


def run_water_functionals():
    """Global UKS of water on the card for every registered functional and
    a composition string, each against nbed_tpu's CPU energy within 1e-7,
    and B2PLYP's double-hybrid total through run_double_hybrid."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.dft.functionals import FUNCTIONALS
    from nbed_tpu_torch.scf import SCFEngine
    from nbed_tpu_torch.solvers import run_double_hybrid

    mol = build_molecule(WATER.read_text(), "sto-3g")
    energies, seconds = {}, {}
    for name in [*sorted(FUNCTIONALS), COMPOSITION]:
        t0 = time.perf_counter()
        sol = SCFEngine(mol, xc=name, device="cuda", **WATER_SCF).kernel()
        seconds[name] = time.perf_counter() - t0
        if not sol.converged:
            raise RuntimeError(f"water {name}: SCF did not converge")
        energies[name] = sol.e_tot
        if name == "b2plyp":
            energies["b2plyp+pt2"] = run_double_hybrid(sol)[0]
    _gate("water", [(k, energies[k], E_WATER[k]) for k in E_WATER]
          + [("b2plyp+pt2", energies["b2plyp+pt2"], E_B2PLYP_DH_WATER)], 1e-7)
    print("water_functionals", json.dumps({
        "e_tot": energies, "max_abs_dev": max(
            abs(energies[k] - E_WATER[k]) for k in E_WATER),
        "scf_s": seconds}), flush=True)


def run_methyl_rohf():
    """ROHF and ROKS (B3LYP) of the methyl radical against nbed_tpu within
    1e-7, spin-pure (<S^2> = 0.75) with shared spatial orbitals."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import SCFEngine

    mol = build_molecule(METHYL.read_text(), "sto-3g", spin=1)
    out = {}
    for label, xc, kw, ref in (("rohf", None, ROHF_SCF, E_ROHF_METHYL),
                               ("roks", "b3lyp", WATER_SCF, E_ROKS_METHYL)):
        sol = SCFEngine(mol, xc=xc, rohf=True, device="cuda", **kw).kernel()
        s2 = sol.spin_square()[0]
        # the spins' orbitals agree column by column up to sign
        c_a, c_b = sol.mo_coeff
        split = float(torch.max(torch.minimum(torch.abs(c_a - c_b).amax(0),
                                              torch.abs(c_a + c_b).amax(0))))
        if not sol.converged or abs(s2 - 0.75) > 1e-10 or split > 1e-10:
            raise RuntimeError(f"methyl {label}: converged {sol.converged}, "
                               f"<S^2> {s2}, or the spins' orbitals differ")
        _gate(f"methyl {label}", [("e_tot", sol.e_tot, ref)], 1e-7)
        out[label] = {"e_tot": sol.e_tot, "s2": s2}
    print("methyl_rohf", json.dumps(out), flush=True)


def run_water_qmmm():
    from nbed_tpu_torch import nbed

    t0 = time.perf_counter()
    driver = nbed(**CONFIGS["water_qmmm"], device="cuda")
    wall = time.perf_counter() - t0
    if not driver.run_qmmm or driver._mol.mm_coords is None:
        raise RuntimeError("water_qmmm ran without its MM charges")
    res = driver.mu
    _gate("water_qmmm", [("e_uks", driver._global_ks.e_tot, E_UKS_QMMM),
                         ("e_rhf", res["e_rhf"], E_RHF_QMMM),
                         ("e_ccsd", res["e_ccsd"], E_CCSD_QMMM)], 1e-6)
    print("water_qmmm", json.dumps({
        "wall_s": wall, "e_uks": driver._global_ks.e_tot, "e_rhf": res["e_rhf"],
        "e_ccsd": res["e_ccsd"], "stages_s": driver.timings}), flush=True)
    return driver


def run_acetonitrile_camb3lyp():
    """The PRA config with CAM-B3LYP: exact ERIs, the folded exchange
    operator through the fused kernel."""
    from nbed_tpu_torch import nbed

    t0 = time.perf_counter()
    driver = nbed(**CONFIGS["acetonitrile_camb3lyp"], device="cuda")
    wall = time.perf_counter() - t0
    ks = driver._ks_engine
    if ks.density_fitting or ks._rsh is None or ks.hyb != 1.0:
        raise RuntimeError("acetonitrile CAM-B3LYP is not on the folded exact route")
    res = driver.huzinaga
    qubits = res["second_quantised"][1].shape[0]
    if qubits != 28:
        raise RuntimeError(f"acetonitrile CAM-B3LYP register {qubits} qubits, expected 28")
    _gate("acetonitrile_camb3lyp", [("e_rhf", res["e_rhf"], E_RHF_PRA_CAM),
                                    ("e_ccsd", res["e_ccsd"], E_CCSD_PRA_CAM)], 1e-6)
    print("acetonitrile_camb3lyp", json.dumps({
        "wall_s": wall, "qubits": qubits, "e_uks": driver._global_ks.e_tot,
        "e_rhf": res["e_rhf"], "e_ccsd": res["e_ccsd"],
        "stages_s": driver.timings}), flush=True)
    return driver


def run_pfoa_wb97x():
    """pfoa with wB97X: DF on by itself, the KS engine's ordinary and
    long-range factors, the HF engine sharing only the ordinary one."""
    from nbed_tpu_torch import nbed

    t0 = time.perf_counter()
    driver = nbed(**CONFIGS["pfoa_wb97x"], device="cuda")
    wall = time.perf_counter() - t0
    ks, hf = driver._ks_engine, driver._hf_engine
    if not (driver._use_df and ks.density_fitting and ks.df_b_lr is not None):
        raise RuntimeError("pfoa wB97X did not build both DF factors")
    if hf.df_b is not ks.df_b or hf.df_b_lr is not None:
        raise RuntimeError("pfoa wB97X: the HF engine must share only the ordinary factor")
    res = driver.mu
    if not (driver._global_ks.converged and res["scf"].converged):
        raise RuntimeError("pfoa wB97X: global UKS or embedded SCF did not converge")
    qubits = res["second_quantised"][1].shape[0]
    if qubits != 78:
        raise RuntimeError(f"pfoa wB97X register {qubits} spin orbitals, expected 78")
    _gate("pfoa_wb97x", [
        ("e_uks", driver._global_ks.e_tot, E_UKS_PFOA_WB97X),
        ("e_rhf", res["e_rhf"], E_RHF_PFOA_WB97X),
        ("classical_energy", res["classical_energy"], E_CLASSICAL_PFOA_WB97X),
        ("e_ccsd", res["e_ccsd"], E_CCSD_PFOA_WB97X)], 1e-6)
    dm = driver._global_ks.make_rdm1()
    print("pfoa_wb97x", json.dumps({
        "wall_s": wall, "naux": ks.df_b.shape[1], "naux_lr": ks.df_b_lr.shape[1],
        "df_build_s": ks.df_timings, "df_lr_build_s": ks.df_lr_timings,
        "qubits": qubits, "e_uks": driver._global_ks.e_tot, "e_rhf": res["e_rhf"],
        "classical_energy": res["classical_energy"], "e_ccsd": res["e_ccsd"],
        "df_k_folded_ms": median_ms(lambda: ks._df_k(dm), reps=20),
        "xc_table_ms": median_ms(lambda: ks.xc_fn(dm), reps=5, warmup=1),
        "stages_s": driver.timings}), flush=True)
    return driver


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    from nbed_tpu_torch._reference_files import native_integrals_library
    from nbed_tpu_torch.ops import jk
    from nbed_tpu_torch.scf.engine import _atomic_density

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    phase_s = {}
    t0 = time.perf_counter()
    jk.build_kernels()
    native_integrals_library()
    phase_s["build"] = time.perf_counter() - t0
    print(f"build_s {phase_s['build']:.3f}", flush=True)

    t0 = time.perf_counter()
    rows = check_kernels()
    phase_s["kernel_check"] = time.perf_counter() - t0

    # each pipeline is a cold run (its atoms' SAD SCFs included), with the
    # launch counts set to 0 just before it and read just after
    per_phase, peak_gb = {}, {}
    for name, run in (("water", run_water), ("acetonitrile", run_acetonitrile),
                      ("water_functionals", run_water_functionals),
                      ("methyl_rohf", run_methyl_rohf), ("water_qmmm", run_water_qmmm),
                      ("acetonitrile_camb3lyp", run_acetonitrile_camb3lyp),
                      ("pfoa_wb97x", run_pfoa_wb97x), ("pfoa", run_pfoa)):
        driver = None  # the previous pipeline's memory is not this one's peak
        _atomic_density.cache_clear()
        torch.cuda.reset_peak_memory_stats()
        jk.LAUNCHES.clear()
        t0 = time.perf_counter()
        driver = run()
        phase_s[name] = time.perf_counter() - t0
        per_phase[name] = jk.LAUNCHES["fused_jk"]
        peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
        if per_phase[name] == 0:
            raise RuntimeError(f"the {name} pipeline ran without launching fused_jk")
    launches = sum(per_phase.values())
    print(f"fused_jk launches: {json.dumps(per_phase)}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    check_pfoa_df_and_xc(driver)  # the pfoa driver, run last
    phase_s["pfoa_df_xc_check"] = time.perf_counter() - t0
    peak_gb["pfoa_df_xc_check"] = torch.cuda.max_memory_allocated() / 1e9
    print("max_memory_allocated_gb", json.dumps(peak_gb), flush=True)
    print("phase_s", json.dumps(phase_s), flush=True)

    main_row = next(r for r in rows
                    if r["case"] == "acetonitrile" and r["dtype"] == "float64")
    print(json.dumps({"kernels": [{
        "name": "fused_jk", "route": "cuda",
        "source": "nbed_tpu_torch/csrc/fused_jk.cu",
        "replaces": "nbed_tpu/ops/pallas_jk.py:82",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "float64"),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "m": main_row["m"], "dtype": "float64",
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
