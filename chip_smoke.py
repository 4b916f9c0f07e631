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

The mixed-precision and quantum phases follow the pipelines they extend:
water and acetonitrile again with the float32 warm-up (the fused kernel's
float32 entry), acetonitrile's global UKS with incremental float32 J/K, the
PRA register mapped (JW, BK, parity) and Z2-tapered, water's embedded VQE
and DFT-in-DFT check, one value-and-gradient of the VQE objective on a
20-qubit acetonitrile register, and pfoa's DF-UKS with incremental float32
J/K on the factor already built.

    python3 chip_smoke.py

Every phase raises on failure. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit, and the one before that lists each kernel (the fused J/K
build's float64 and float32 entries) with its launches in the pipeline
runs, its error against the plain version, its time beside the plain
version's and one library call's, its self device time and its bound.
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
# nbed_tpu's NbedDriver on CONFIGS["acetonitrile_taper"] with
# qubit_mapping=M for M in jw, bk, parity (the commands above with that
# config), reading d.huzinaga["tapered"]: its counts, sector, sum |c|^2
# (Tr H^2 / 2^n, invariant under the MO rotations the two packages may
# differ by), identity coefficient and sum |c| (not invariant: held loosely)
TAPER_PRA = {
    "jw": {"n_qubits_raw": 28, "n_qubits": 26, "n_terms_raw": 50399, "n_terms": 50399,
           "n_symmetries": 2, "sector": [-1, -1], "abs_sum": 229.87272570940354},
    "bk": {"n_qubits_raw": 28, "n_qubits": 26, "n_terms_raw": 50399, "n_terms": 50399,
           "n_symmetries": 2, "sector": [-1, 1], "abs_sum": 229.87272570940348},
    "parity": {"n_qubits_raw": 28, "n_qubits": 26, "n_terms_raw": 50399,
               "n_terms": 50399, "n_symmetries": 2, "sector": [-1, 1],
               "abs_sum": 229.8727257094035},
}
SQ_SUM_PRA = 8959.038268011253
IDENTITY_PRA = -93.25715345113377
# nbed_tpu's NbedDriver on CONFIGS["water_vqe"] with projector=P for P in
# mu, huzinaga (the commands above), reading getattr(d, P)["e_vqe"] and
# ["e_dft_in_dft"]
E_VQE_WATER = {"mu": -75.1285919012455, "huzinaga": -75.12859115945318}
E_DFT_IN_DFT_WATER = {"mu": -75.30914551752402, "huzinaga": -75.3091448156704}

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
CONFIGS["water_mixed"] = {**CONFIGS["water"], "warmup_f32": True}
CONFIGS["acetonitrile_mixed"] = {**CONFIGS["acetonitrile"], "warmup_f32": True}
CONFIGS["acetonitrile_taper"] = {**CONFIGS["acetonitrile"], "run_ccsd_emb": False,
                                 "taper_qubits": True}
CONFIGS["water_vqe"] = {**CONFIGS["water"], "run_ccsd_emb": False,
                        "run_vqe_emb": True, "run_dft_in_dft": True}

# the fused kernel's least time: each supermatrix read once (2 M^2 words)
# at the H100's 3.35 TB/s, or its 6 M^2 operations at 67 TFLOP/s (the
# data sheet's FP64 tensor-core rate and the FP32 rate), whichever is larger
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = 67e12

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


def jk_bound(m: int, dtype):
    """(ms, "bytes" or "operations"): the least time of one J/K build at
    M = nao^2, the larger of its bytes (each input read once, each output
    written once) over the memory rate and its operations over the peak
    rate, and which of the two it is."""
    word = 8 if dtype == torch.float64 else 4
    by_bytes = (2 * m * m + 2 * m + 3 * m) * word / HBM_BYTES_PER_S
    by_ops = 6 * m * m / PEAK_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_kernels() -> list:
    """Kernel against plain version at every case and dtype, with the
    library call's time and the kernel's self device time from
    torch.profiler; returns rows."""
    from nbed_tpu_torch.ops.jk import fused_jk, fused_jk_reference
    from nbed_tpu_torch.profiling import device_profile

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
            m = int(dm.shape[-1]) ** 2
            ms = median_ms(lambda: fused_jk(gj, gk, dm))
            plain_ms = median_ms(lambda: fused_jk_reference(gj, gk, dm))
            # one library call for the same function: a batched GEMM of
            # [G_J, G_K] against [[D_a + D_b, 0], [D_a, D_b]]
            g2 = torch.stack([gj, gk])
            rhs = torch.zeros((2, m, 2), dtype=dtype, device="cuda")
            rhs[0, :, 0] = (dm[0] + dm[1]).reshape(-1)
            rhs[1] = dm.reshape(2, m).T
            library_ms = median_ms(lambda: torch.bmm(g2, rhs))
            del g2
            _, prof = device_profile(lambda: [fused_jk(gj, gk, dm) for _ in range(20)])
            kernel_us = next(ev[2] * 1e3 / ev[1] for ev in prof["top"]
                             if "fused_jk_kernel" in ev[0])
            row = {"case": label, "m": m,
                   "dtype": str(dtype).removeprefix("torch."),
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "kernel_device_us": kernel_us,
                   **dict(zip(("bound_ms", "bound_by"), jk_bound(m, dtype)))}
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


def pipeline_energies(driver) -> dict:
    """The global UKS energy and each projector's embedded energies."""
    out = {"e_uks": driver._global_ks.e_tot}
    for name in ("mu", "huzinaga"):
        res = getattr(driver, name)
        for key in ("e_rhf", "e_ccsd", "e_fci", "classical_energy"):
            if res is not None and key in res:
                out[f"{name}.{key}"] = res[key]
    return out


def run_mixed(name: str, f64: dict):
    """CONFIGS[name] with the float32 warm-up against the same pipeline's
    float64 run: SCF and correlated energies within 1e-8 Ha, the
    classical-energy partition (linear in the global density, which stops at
    the config's 1e-6) within 1e-6. For acetonitrile also the global UKS
    with incremental float32 J/K."""
    from nbed_tpu_torch import nbed
    from nbed_tpu_torch.scf import SCFEngine

    t0 = time.perf_counter()
    driver = nbed(**CONFIGS[f"{name}_mixed"], device="cuda")
    wall = time.perf_counter() - t0
    ks = driver._ks_engine
    if not (ks.warmup_f32 and driver._hf_engine.warmup_f32):
        raise RuntimeError(f"{name}_mixed: warmup_f32 did not reach both engines")
    ours = pipeline_energies(driver)
    _gate(f"{name}_mixed", [(k, ours[k], f64[k]) for k in ours
                            if not k.endswith("classical_energy")], 1e-8)
    _gate(f"{name}_mixed", [(k, ours[k], f64[k]) for k in ours
                            if k.endswith("classical_energy")], 1e-6)
    out = {"wall_s": wall, "dev_vs_f64": {k: ours[k] - f64[k] for k in ours},
           "stages_s": driver.timings}
    if name == "acetonitrile":
        inc = SCFEngine(ks.mol, xc=ks.xc, conv_tol=ks.conv_tol, max_cycle=ks.max_cycle,
                        incremental_jk="on", device="cuda")
        t0 = time.perf_counter()
        sol = inc.kernel()
        out["incremental_s"] = time.perf_counter() - t0
        _gate("acetonitrile incremental_jk", [("e_uks", sol.e_tot, f64["e_uks"])], 1e-8)
        out["incremental_dev_vs_f64"] = sol.e_tot - f64["e_uks"]
    print(f"{name}_mixed", json.dumps(out), flush=True)
    return driver


def run_acetonitrile_taper():
    """The PRA register under JW, BK and parity, Z2-tapered in the HF
    sector: counts, symmetries and sector exactly as nbed_tpu's; sum |c|^2
    within 1e-8 and the identity coefficient within 1e-10; sum |c|, which
    depends on the MO gauge, within 1e-4."""
    from nbed_tpu_torch import nbed

    out, driver = {}, None
    for mapping, ref in TAPER_PRA.items():
        driver = None
        t0 = time.perf_counter()
        driver = nbed(**CONFIGS["acetonitrile_taper"], qubit_mapping=mapping,
                      device="cuda")
        wall = time.perf_counter() - t0
        res = driver.huzinaga
        _gate(f"acetonitrile_taper {mapping}", [("e_rhf", res["e_rhf"], E_RHF_PRA)], 1e-6)
        t = res["tapered"]
        got = {k: t[k] for k in ("n_qubits_raw", "n_qubits", "n_terms_raw", "n_terms")}
        got.update(n_symmetries=len(t["symmetries"]), sector=[int(x) for x in t["sector"]])
        if got != {k: v for k, v in ref.items() if k != "abs_sum"}:
            raise RuntimeError(f"acetonitrile_taper {mapping}: {got} vs reference {ref}")
        coeffs = list(t["psum"].terms.values())
        sums = {"abs_sum": float(sum(abs(c) for c in coeffs)),
                "sq_sum": float(sum(abs(c) ** 2 for c in coeffs)),
                "identity": complex(t["psum"].terms.get((0, 0), 0.0)).real}
        _gate(f"acetonitrile_taper {mapping}", [
            ("sum |c|^2", sums["sq_sum"], SQ_SUM_PRA)], 1e-8)
        _gate(f"acetonitrile_taper {mapping}", [
            ("identity", sums["identity"], IDENTITY_PRA)], 1e-10)
        _gate(f"acetonitrile_taper {mapping}", [
            ("sum |c|", sums["abs_sum"], ref["abs_sum"])], 1e-4)
        out[mapping] = {**got, **sums, "abs_sum_dev": sums["abs_sum"] - ref["abs_sum"],
                        "wall_s": wall, "post_embed_s": driver.timings["huzinaga_post_embed"]}
    print("acetonitrile_taper", json.dumps(out), flush=True)
    return driver


def run_water_vqe():
    """Water's embedded VQE on both projectors against the embedded FCI
    (tests/test_vqe.py:91-101) and nbed_tpu's e_vqe, and the DFT-in-DFT
    energies against nbed_tpu with the identities of
    tests/test_driver.py:49-57."""
    from nbed_tpu_torch import nbed

    t0 = time.perf_counter()
    driver = nbed(**CONFIGS["water_vqe"], device="cuda")
    wall = time.perf_counter() - t0
    e_ks = driver._global_ks.e_tot
    out = {"wall_s": wall, "stages_s": driver.timings}
    for name in ("mu", "huzinaga"):
        res = getattr(driver, name)
        vqe = res["vqe"]
        if not (vqe.converged and res["e_vqe"] > res["e_fci"] - 1e-9
                and res["e_vqe"] - res["e_fci"] < 2e-4):
            raise RuntimeError(f"water {name} VQE: converged {vqe.converged}, e_vqe "
                               f"{res['e_vqe']} against e_fci {res['e_fci']}")
        _gate(f"water_vqe {name}", [("e_vqe", res["e_vqe"], E_VQE_WATER[name])], 1e-6)
        _gate(f"water_vqe {name}", [("e_dft_in_dft", res["e_dft_in_dft"],
                                     E_DFT_IN_DFT_WATER[name])], 1e-7)
        _gate(f"water_vqe {name}", [("e_dft_in_dft vs global KS", res["e_dft_in_dft"],
                                     e_ks)], 5e-6 if name == "mu" else 1e-8)
        out[name] = {"e_vqe": res["e_vqe"], "e_fci": res["e_fci"],
                     "e_dft_in_dft": res["e_dft_in_dft"], "n_qubits": vqe.n_qubits,
                     "n_params": vqe.n_params, "n_strings": vqe.n_strings,
                     "lbfgs_iterations": vqe.n_iterations}
    _gate("water_vqe", [("mu vs huzinaga e_dft_in_dft", driver.mu["e_dft_in_dft"],
                         driver.huzinaga["e_dft_in_dft"])], 5e-6)
    print("water_vqe", json.dumps(out), flush=True)
    return driver


def run_vqe_20q(pra_scf, water_sq, water_nelec):
    """One value-and-gradient of the VQE objective on the PRA Huzinaga SCF
    cut to 10 MOs (20 qubits) at seeded amplitudes: at theta = 0 the energy
    is <HF|H|HF> of the mapped sum; four gradient entries against central
    differences; the adjoint sweep against plain autograd at water's
    register."""
    from nbed_tpu_torch.ham import HamiltonianBuilder, pauli_sum_to_sparse, reduce_virtuals
    from nbed_tpu_torch.ham.qubit import _popcount
    from nbed_tpu_torch.solvers import vqe

    cuda = torch.device("cuda")
    occ = pra_scf.mo_occ.cpu().numpy()
    n_virt = occ.shape[-1] - 10
    scf = reduce_virtuals(pra_scf, n_virt)
    nelec = (int(occ[0].sum()), int(occ[1].sum()))
    sq = HamiltonianBuilder(scf, 0.0).build()
    t0 = time.perf_counter()
    psum, prog, psi0, n_params = vqe._ansatz_setup(*sq, nelec, "jw", None, cuda)
    setup_s = time.perf_counter() - t0
    if psum.n_qubits != 20:
        raise RuntimeError(f"vqe_20q register {psum.n_qubits} qubits, expected 20")
    hf = int(torch.argmax(psi0))
    e_hf = sum(c.real * (1 - 2 * (_popcount(hf & z) & 1))
               for (x, z), c in psum.terms.items() if x == 0)
    e0, _ = vqe._value_and_grad(np.zeros(n_params), psi0, prog)
    _gate("vqe_20q", [("E(theta=0) vs <HF|H|HF>", e0, e_hf)], 1e-9)

    thetas = 0.05 * np.random.default_rng(20).standard_normal(n_params)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e, g = vqe._value_and_grad(thetas, psi0, prog)
    value_grad_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    with torch.no_grad():
        e_fwd = float(vqe._energy(torch.as_tensor(thetas, device=cuda), psi0, prog))
    energy_s = time.perf_counter() - t0
    h = 1e-4
    fd = {}
    for i in np.argsort(-np.abs(g))[:4]:
        plus, minus = thetas.copy(), thetas.copy()
        plus[i] += h
        minus[i] -= h
        with torch.no_grad():
            fd[int(i)] = (float(vqe._energy(torch.as_tensor(plus, device=cuda), psi0, prog))
                          - float(vqe._energy(torch.as_tensor(minus, device=cuda),
                                              psi0, prog))) / (2 * h)
    rel = max(abs(g[i] - fd[i]) / abs(g[i]) for i in fd)
    if not (np.isfinite(e) and abs(e - e_fwd) < 1e-10 and rel < 1e-6):
        raise RuntimeError(f"vqe_20q: E {e} (forward {e_fwd}), gradient vs central "
                           f"differences {rel} relative")

    # adjoint against plain autograd at water's register
    w_psum, w_prog, w_psi0, w_n = vqe._ansatz_setup(*water_sq, water_nelec, "jw", None, cuda)
    theta = torch.tensor(0.1 * np.random.default_rng(3).standard_normal(w_n),
                         device=cuda, requires_grad=True)
    (g_adj,) = torch.autograd.grad(vqe._energy(theta, w_psi0, w_prog), theta)
    h_dense = torch.tensor(pauli_sum_to_sparse(w_psum).toarray().real, device=cuda)
    theta_p = theta.detach().clone().requires_grad_(True)
    psi = vqe._sweep_plain(theta_p, w_psi0, w_prog)
    (g_plain,) = torch.autograd.grad(psi @ h_dense @ psi, theta_p)
    adj_err = float(torch.max(torch.abs(g_adj - g_plain)) / torch.max(torch.abs(g_plain)))
    if not adj_err < 1e-9:
        raise RuntimeError(f"vqe adjoint vs plain autograd at {w_psum.n_qubits} qubits: "
                           f"max |dg| / max |g| {adj_err}")
    print("vqe_20q", json.dumps({
        "n_qubits": psum.n_qubits, "nelec": nelec, "n_params": n_params,
        "n_strings": len(prog.strings), "n_terms": len(psum),
        "n_hamiltonian_blocks": len(prog.blocks), "setup_s": setup_s,
        "value_and_grad_s": value_grad_s, "energy_s": energy_s,
        "peak_gb_value_and_grad": peak_gb, "e": e, "e_hf": e_hf,
        "grad_vs_central_diff_rel": rel, "max_abs_grad": float(np.abs(g).max()),
        "adjoint_vs_autograd": {"n_qubits": w_psum.n_qubits, "n_params": w_n,
                                "max_rel_diff": adj_err}}), flush=True)


def run_pfoa_incremental(driver):
    """pfoa's global DF-UKS again with incremental float32 J/K, on the DF
    factor the driver built: within 1e-8 Ha of its float64 energy. A
    float64 rerun set up the same way (new engine: grid and AO tables
    rebuilt, SAD atoms cached) is timed beside it."""
    from nbed_tpu_torch.scf import SCFEngine

    ks = driver._ks_engine
    out = {}
    for mode in ("off", "on"):
        eng = SCFEngine(ks.mol, xc=ks.xc, conv_tol=ks.conv_tol, max_cycle=ks.max_cycle,
                        density_fitting=True, df_b=ks.df_b, incremental_jk=mode,
                        max_memory_mb=ks.max_memory_mb, device="cuda")
        t0 = time.perf_counter()
        sol = eng.kernel()
        out[f"{mode}_s"] = time.perf_counter() - t0
        if not sol.converged:
            raise RuntimeError(f"pfoa DF-UKS (incremental_jk={mode}) did not converge")
        _gate("pfoa_incremental", [(f"e_uks incremental_jk={mode}", sol.e_tot,
                                    driver._global_ks.e_tot)], 1e-8)
        out[f"{mode}_dev_vs_f64"] = sol.e_tot - driver._global_ks.e_tot
    print("pfoa_incremental", json.dumps(out), flush=True)


def build_all():
    """Build the CUDA kernel library and the two host C++ libraries, each
    compiler started at once."""
    from concurrent.futures import ThreadPoolExecutor

    from nbed_tpu_torch._compile import native_integrals_library, qubit_terms_library
    from nbed_tpu_torch.ops import jk

    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = [pool.submit(f) for f in (jk.build_kernels, native_integrals_library,
                                            qubit_terms_library)]
        for f in futures:
            f.result()


# kernels each phase's path must launch (counted from 0 for each phase);
# the DF and statevector phases have none: DF J/K and the VQE sweep are
# plain torch, as they are XLA in the reference
F64 = ("fused_jk_f64",)
MIXED = ("fused_jk_f64", "fused_jk_f32")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    from nbed_tpu_torch.ops import jk
    from nbed_tpu_torch.scf.engine import _atomic_density

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    phase_s = {}
    t0 = time.perf_counter()
    build_all()
    phase_s["build"] = time.perf_counter() - t0
    print(f"build_s {phase_s['build']:.3f}", flush=True)

    t0 = time.perf_counter()
    rows = check_kernels()
    phase_s["kernel_check"] = time.perf_counter() - t0

    # each pipeline is a cold run (its atoms' SAD SCFs included), with the
    # launch counts set to 0 just before it and read just after
    f64, keep = {}, {}
    per_phase, peak_gb = {}, {}

    def remember(name, driver):
        if name in ("water", "acetonitrile"):
            f64[name] = pipeline_energies(driver)
        elif name == "acetonitrile_taper":
            keep["pra_scf"] = driver.huzinaga["scf"]
        elif name == "water_vqe":
            occ = driver.mu["scf"].mo_occ.cpu().numpy()
            keep["water"] = (driver.mu["second_quantised"],
                             (int(occ[0].sum()), int(occ[1].sum())))

    phases = (
        ("water", run_water, F64),
        ("water_mixed", lambda: run_mixed("water", f64["water"]), MIXED),
        ("acetonitrile", run_acetonitrile, F64),
        ("acetonitrile_mixed", lambda: run_mixed("acetonitrile", f64["acetonitrile"]),
         MIXED),
        ("acetonitrile_taper", run_acetonitrile_taper, F64),
        ("water_vqe", run_water_vqe, F64),
        ("vqe_20q", lambda: run_vqe_20q(keep.pop("pra_scf"), *keep.pop("water")), ()),
        ("water_functionals", run_water_functionals, F64),
        ("methyl_rohf", run_methyl_rohf, F64), ("water_qmmm", run_water_qmmm, F64),
        ("acetonitrile_camb3lyp", run_acetonitrile_camb3lyp, F64),
        ("pfoa_wb97x", run_pfoa_wb97x, F64), ("pfoa", run_pfoa, F64),
    )
    for name, run, needs in phases:
        driver = None  # the previous pipeline's memory is not this one's peak
        _atomic_density.cache_clear()
        torch.cuda.reset_peak_memory_stats()
        jk.LAUNCHES.clear()
        t0 = time.perf_counter()
        driver = run()
        phase_s[name] = time.perf_counter() - t0
        per_phase[name] = dict(jk.LAUNCHES)
        peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
        missing = [k for k in needs if not jk.LAUNCHES[k]]
        if missing:
            raise RuntimeError(f"the {name} pipeline ran without launching {missing}")
        remember(name, driver)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    check_pfoa_df_and_xc(driver)  # the pfoa driver, run last
    phase_s["pfoa_df_xc_check"] = time.perf_counter() - t0
    peak_gb["pfoa_df_xc_check"] = torch.cuda.max_memory_allocated() / 1e9

    torch.cuda.reset_peak_memory_stats()
    jk.LAUNCHES.clear()
    t0 = time.perf_counter()
    run_pfoa_incremental(driver)
    phase_s["pfoa_incremental"] = time.perf_counter() - t0
    per_phase["pfoa_incremental"] = dict(jk.LAUNCHES)
    peak_gb["pfoa_incremental"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"fused_jk launches: {json.dumps(per_phase)}", flush=True)
    print("max_memory_allocated_gb", json.dumps(peak_gb), flush=True)
    print("phase_s", json.dumps(phase_s), flush=True)

    kernels = []
    for dtype in ("float64", "float32"):
        name = f"fused_jk_{dtype[0]}{dtype[-2:]}"
        # the main path's shape: acetonitrile's M = 324, in float32 the
        # shape of acetonitrile_mixed's warm-up and incremental launches
        main_row = next(r for r in rows if r["case"] == "acetonitrile"
                        and r["dtype"] == dtype)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nbed_tpu_torch/csrc/fused_jk.cu",
            "replaces": "nbed_tpu/ops/pallas_jk.py:82",
            "launches": sum(c.get(name, 0) for c in per_phase.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == dtype),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "kernel_device_us": main_row["kernel_device_us"],
            "m": main_row["m"], "dtype": dtype,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
