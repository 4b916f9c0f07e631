"""Smoke run of nbed_tpu_torch on one CUDA card.

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card (the fused J/K kernel also on
CAM-B3LYP's range-separated exchange operator), then drives the embedding
pipeline end to end through ``nbed_tpu_torch.nbed(..., device="cuda")`` on
water (both projectors, CCSD and FCI) and on the acetonitrile configuration
of the PRA 109, 022418 notebook (28-qubit embedded register). Before the
pipelines it holds the FCI kernels: the dense sector matrix against the host
oracle, the matrix-free route (``check_fci_direct``: its gather and scatter
kernels against their plain steps, its eigenvalues against the dense route's,
and both routes' times, which set ``fci.DENSE_MAX``), and acetonitrile's
embedded FCI of the published 28-qubit sector, 11,778,624 determinants,
against the benchmark's plain reference (``check_fci_acetonitrile``).

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

The one-electron slice follows: water/6-31G with the Pipek-Mezey, Boys
and IBO localizers (both projectors, CCSD), the acetonitrile configuration
with PAO virtuals in the Huzinaga projector, and the same configuration
with embedded CIS and RPA, whose oscillator strengths, dipole moments,
atomic charges and density cube are held against nbed_tpu's values. After
the pfoa run, the torch overlap at 126 AOs is held against the engine's S,
and pfoa's dipole moment against nbed_tpu's.

The mixed-precision and quantum phases follow the pipelines they extend:
water and acetonitrile again with the float32 warm-up (the fused kernel's
float32 entry), acetonitrile's global UKS with incremental float32 J/K, the
PRA register mapped (JW, BK, parity) and Z2-tapered, water's embedded VQE
and DFT-in-DFT check, one value-and-gradient of the VQE objective on a
20-qubit acetonitrile register, and pfoa's DF-UKS with incremental float32
J/K on the factor already built.

The post-SCF slice follows: water's global CCSD, CCSD(T) and FCI beside
restricted HF/B3LYP and a frozen-core builder; the acetonitrile molecule's
TDA (dense and Davidson, and a Davidson under a 300-MB budget that its
device memory must keep) and RPA TDDFT, huzinaga_scf restricted and
unrestricted on the driver's embedding potential, and the stability
spectrum of its Huzinaga embedded solution; stretched H2's broken-symmetry
instability followed downhill by stable_scf; QSE on water's VQE register
against CIS and FCI; and, on the pfoa driver, CCSD(T) in every precision
mode, the DF TDA of the embedded solution against CIS, a Davidson TDDFT of
the global UKS, the f_xc jvp against finite differences and a checkpoint
round trip with a warm restart.

The derivatives slice follows the post-SCF phases on the small molecules:
water's UHF, B3LYP (grid response) and CAM-B3LYP analytic gradients
against nbed_tpu's and against central differences on the card, a BFGS
geometry optimization, harmonic frequencies, IR intensities and RRHO
thermochemistry at the minimum; the acetonitrile molecule's UHF and B3LYP5
gradients and its HF Hessian over 36 displaced SCFs; and water/cc-pVDZ's
torch ERI tensor and V against the C++ engine, the seconds of one ERI
tensor's forward and backward pass, and its UHF gradient. Every SCF of
these phases builds its J/K in the fused kernel.

The batching and parallel slice comes first after the kernel phase: the
water fleet's UHF energies over 8 lanes (one lane SCF, one fused J/K launch
per cycle for the batch) against single-geometry runs and on a mesh of two
lane groups; batched UHF gradients over 4 lanes; the geometry-
differentiable embedding program over 8 lanes, against the program run
alone and the host driver, with its forward-mode derivative against a
central difference; and the SCFs split over a mesh's model axis (the one
card named twice): acetonitrile's ERI row slabs, water's DF factor and
grid, and, after the pfoa run, pfoa's DF-UKS. The Hessians and dipole
derivatives of the derivatives phases run as batched lanes, and
acetonitrile's Hessian again on a mesh of two lane groups.

The compiled-program slice: every engine SCF above runs as CUDA graphs
(``SCFEngine(jit_kernel="auto")`` on the card: chunks of SCF cycles and
the final Fock build captured once per engine and call signature, the
subsystem-DFT stage and ``get_veff`` one replay each), with the Fock
diagonalisation and the DIIS solve in the cuSOLVER eigh of
``ops.eigh``, which a kernel phase holds against ``torch.linalg.eigh`` at
the main path's shapes. After the pfoa phases, ``graphed_scf`` holds
water's UHF, B3LYP, mu-embedded and Huzinaga SCFs, acetonitrile's
B3LYP5 and pfoa's DF-B3LYP (126 AOs, on the pfoa driver's factor) graphed
against eager (1e-10 Ha, the same cycles), a replay bitwise against the
same chunk run uncaptured, ``dispatch_cycles`` 0, 4 and the default, the
subsystem stage (1e-12) and ``integrals_backend="torch"`` (1e-10), and
prints the warm ``kernel()`` and ``nbed()`` walls of each way. Each
phase's line of SCF runs says how its ``kernel()`` calls ran.

The remaining compiled programs: the CCSD amplitude sweep (one CUDA graph
per cycle, the DIIS solve in the cuSOLVER eigh) and the (T) energy (one
graph for the whole chunk loop), the grid and the AO tables (shared
programs of the structure) and the TDA/RPA matvec blocks (one graph per
block kind and width) run as graphs wherever the work is on the card.
``grid_programs`` gives a second engine of water, acetonitrile and pfoa
its tables with no capture, bitwise equal to an eager engine's;
``tddft_graphed`` holds acetonitrile's TDA, A+B and A-B blocks graphed
against eager (1e-12) and its Davidson roots (1e-10), and ``pfoa_post``
a pfoa TDA block; after pfoa, ``ccsd_graphed`` holds the sweep against
its eager loop (1e-10 Ha in as many cycles) on water's mu and Huzinaga
spaces, acetonitrile's 28-qubit space and pfoa's mu space, and
water_global's (T) (1e-12). ``shared_programs`` asserts that a second
``nbed()`` captures no program of any kind.

The quantum end's programs: the VQE value and gradient (a sweep chunk of
rotations read at a device counter, the energy and the adjoint's chunk,
one host read per evaluation), ADAPT's pool gradients and per-step
objective (one program for all steps) and MP2's contraction run as CUDA
graphs. ``vqe_graphed`` holds ``run_vqe`` on water's mu and Huzinaga
registers graphed against the eager route (e_vqe to the bit in as many
L-BFGS-B iterations), one value and gradient of the 20-qubit register
(1e-12 relative) and a 30-iteration 20-qubit L-BFGS-B run;
``adapt_graphed`` holds ADAPT on water's mu register graphed against
eager (1e-10, the same operators, no capture after the first step) and
nbed_tpu (1e-6), and a 20-qubit pool gradient (1e-12 relative); after
pfoa, ``mp2_graphed`` holds MP2 on water_global and pfoa's mu space
(1e-12).

    python3 chip_smoke.py

The kernel phases hold the fused J/K kernel (``ops.jk.FusedJK``, as the
engines prepare it; then its lane/slab entry on (B, R, M) supermatrices:
the water fleet's B = 8 at M = 49, the acetonitrile Hessian's B = 36 at
M = 324 and R = M/2 slabs at M = 324, 576 and 4096) against its plain
version at every case and dtype, on
its own path and on each path forced (vector loads, bulk-copy ring,
chunked densities), checks that two launches are bitwise equal and that
a CUDA-graph replay equals the eager call, and times the kernel, the plain
version and one library call (``torch.bmm``) three ways: ``ms``, CUDA
events around one call (the card waits through the call's host work, so
host issue plus device time); ``ms_stream``, events around 100
back-to-back calls, per call; ``host_us``, the host clock over 1000
enqueues (100 above M = 4096), synchronised after the clock stops. Beside
them: the kernel's self device time (torch.profiler) and its bound.

Every phase raises on failure. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit, and the one before that lists each kernel (the fused J/K
build's float64 and float32 entries, its float64 lane/slab entry at
the Hessian's B = 36, M = 324, and the eigh's float64 and float32 entries
at acetonitrile's Fock) with its launches in the pipeline
runs, its error against the plain version, its times beside the plain
version's and one library call's, its self device time and its bound.
The pipeline phases' launches are also printed by dtype and M, and by
(dtype, M, R, B).
Exits non-zero, printing no result, where CUDA is unavailable.
"""

import gc
import json
import subprocess
import sys
import time
from contextlib import contextmanager
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
# nbed_tpu's run_adapt_vqe (defaults: grad_tol 1e-3, max_ops 60) on the mu
# register of CONFIGS["water_vqe"] (10 qubits, 12 operators), from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "import numpy as np, chip_smoke
#   as c; from nbed_tpu import nbed; from nbed_tpu.solvers import
#   run_adapt_vqe; r = nbed(**c.CONFIGS['water_vqe']).mu; o = np.asarray(
#   r['scf'].mo_occ); print(run_adapt_vqe(*r['second_quantised'], (int((o[0]
#   > 0).sum()), int((o[1] > 0).sum()))).e_vqe)"
E_ADAPT_WATER_MU = -75.12859189492936

# nbed_tpu's NbedDriver on CONFIGS["water631g_L"] for L in pm, boys, ibo,
# from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "import chip_smoke as c; from
#   nbed_tpu import nbed; d = nbed(**c.CONFIGS['water631g_L']);
#   print(d._global_ks.e_tot, [getattr(d, p)[k] for p in ('mu', 'huzinaga')
#   for k in ('e_rhf', 'e_ccsd')])"
E_UKS_WATER631G = -76.38420591309928
E_WATER631G = {  # localizer: {projector: (e_rhf, e_ccsd)}
    "pm": {"mu": (-76.15944887228069, -76.1987000545952),
           "huzinaga": (-76.15944772527871, -76.19869891246921)},
    "boys": {"mu": (-76.16755356561487, -76.20579593087302),
             "huzinaga": (-76.16755216788815, -76.20579453868118)},
    "ibo": {"mu": (-76.16462862376471, -76.20329136415131),
            "huzinaga": (-76.16462776005412, -76.20329050543762)},
}
# nbed_tpu on CONFIGS["acetonitrile_pao"]: the command above with that
# config, printing d.huzinaga["e_rhf"], d.huzinaga["e_ccsd"]
E_RHF_PRA_PAO = -133.40757949914632
E_CCSD_PRA_PAO = -127.9004327705286
# nbed_tpu on CONFIGS["acetonitrile_cis"], from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "import chip_smoke as c; from
#   nbed_tpu import nbed, properties as p; d = nbed(**c.CONFIGS[
#   'acetonitrile_cis']); r = d.huzinaga; print(r['cis'].excitations.tolist(),
#   r['rpa'].excitations[:6].tolist(), c.cluster_sums(r['cis'].excitations,
#   r['cis_oscillator_strengths']), c.cluster_sums(r['rpa'].excitations[:6],
#   r['rpa_oscillator_strengths'])); [print(p.dipole_moment(s).tolist(),
#   p.mulliken_charges(s).tolist(), p.lowdin_charges(s).tolist()) for s in
#   (r['scf'], d._global_ks)]; print(float(p.density_cube(d._global_ks,
#   '/dev/null', spacing=0.35).sum()) * 0.35**3)"
# (one command: the lines joined)
E_CIS_PRA = [0.2152992739991993, 0.26577931837945357, 0.26577933547968374,
             0.3073175363454914, 0.3073180988631107, 0.3271368887167374]
E_RPA_PRA = [0.07514606164579006, 0.21680433652567438, 0.21680436629538632,
             0.2833849918647363, 0.2833853912827662, 0.3170896843653738]
# [energy, summed oscillator strength] per cluster of roots (cluster_sums):
# the six lowest roots are dark
F_CIS_PRA = [[0.2152992739991993, 2.632600586497411e-29],
             [0.26577931837945357, 2.6551937879691855e-29],
             [0.26577933547968374, 4.4990924128764523e-29],
             [0.3073175363454914, 1.0599441530749725e-29],
             [0.3073180988631107, 1.671149156269217e-12],
             [0.3271368887167374, 2.5617222419676226e-29]]
F_RPA_PRA = [[0.07514606164579006, 3.6515014360826777e-28],
             [0.21680433652567438, 9.889840793829341e-30],
             [0.21680436629538632, 7.326542885366026e-29],
             [0.2833849918647363, 7.624515986279457e-29],
             [0.2833853912827662, 1.0027206276467503e-12],
             [0.3170896843653738, 6.103852614185299e-29]]
# dipole (Debye), Mulliken and Loewdin charges: "embedded" is the Huzinaga
# solution after environment deletion and CL, "global" the global UKS
PROPERTIES_PRA = {
    "embedded": {
        "dipole": [-62.272881173356026, 0.0004666711721373197, 0.000623019387627346],
        "mulliken": [-0.16821733001111028, 0.07592780549468614, 5.0672395672257995,
                     1.008347780229103, 1.0083520957024907, 1.0083500813590145],
        "lowdin": [-0.10966163344503066, 0.06739475989900257, 5.049798533131342,
                   0.9974891432625174, 0.9974896387839421, 0.997489558368203]},
    "global": {
        "dipole": [-3.0227649558984324, 5.002502786348586e-05, 2.519450453434011e-05],
        "mulliken": [-0.1952544821272859, 0.08058930998814251, -0.2373746408668591,
                     0.11734466816233613, 0.11735139395566241, 0.11734375088799442],
        "lowdin": [-0.1268148678011638, 0.019080349294480214, -0.12042937957137223,
                   0.0760547922210476, 0.0760554804170438, 0.07605362543995065]},
}
N_ELECTRONS_CUBE_PRA = 22.503403386951323
# nbed_tpu's dipole moment (Debye) of the global UKS of CONFIGS["pfoa"], from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "import chip_smoke as c; from
#   nbed_tpu.driver import NbedDriver; from nbed_tpu.config import NbedConfig;
#   from nbed_tpu.properties import dipole_moment; d = NbedDriver(NbedConfig(
#   **c.CONFIGS['pfoa'])); print(dipole_moment(d._global_ks).tolist())"
# (227 s on the development host's CPU)
DIPOLE_PFOA = [1.3938749113882876, 0.43136280619959266, 0.6352633228290194]

# The post-SCF slice. The reference's oracles of water's global CCSD and FCI
# (tests/test_solvers.py:28-38), and nbed_tpu on CONFIGS["water_global"] and
# on acetonitrile, from one command (the lines joined):
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "import chip_smoke as c; from
#   nbed_tpu import nbed; from nbed_tpu.chem import build_molecule; from
#   nbed_tpu.config import NbedConfig; from nbed_tpu.driver import NbedDriver;
#   from nbed_tpu.ham import HamiltonianBuilder as B; from nbed_tpu.scf import
#   huzinaga_scf; from nbed_tpu.scf.engine import SCFEngine; from
#   nbed_tpu.solvers import run_ccsd, run_fci, run_stability, run_tddft_rpa,
#   run_tddft_tda; d = NbedDriver(NbedConfig(**c.CONFIGS['water_global']));
#   hf = d._global_hf; _, h1, h2 = B(hf, 0.0).build(); print(run_ccsd(h1, h2,
#   d._interleaved_occ(hf), conv_tol=1e-10, triples=True)); k, h1, h2 = B(hf,
#   0.0, n_frozen_core=1, n_frozen_virt=1).build(); print(run_fci(k, h1, h2,
#   h1.shape[0], (4, 4))[0][0] + hf.energy_nuc()); mol = build_molecule(
#   c.ACETONITRILE, 'sto-3g'); s = SCFEngine(mol, xc='b3lyp5',
#   **c.TIGHT_SCF).kernel(); print(s.e_tot, run_tddft_tda(s, nroots=6,
#   method='dense').excitations, run_tddft_rpa(s, nroots=6).excitations); d =
#   nbed(**c.CONFIGS['acetonitrile_post']); v = d.embedding_potential; e =
#   d.localized_system.dm_enviro; na = len(d.localized_system.active_mo_inds[
#   0]); print(huzinaga_scf(SCFEngine(mol, restricted=True, **c.HUZ_SCF),
#   v[0], e[0] + e[1], nelec=(na, na))[1]); s = d.huzinaga['scf']; _, h1, h2 =
#   B(s, 0.0).build(); print(run_stability(h1, h2,
#   d._interleaved_occ(s)).eigenvalues)"
# (190 s on the development host's CPU)
E_CCSD_GLOBAL_WATER = -75.0090124134578
E_FCI_GLOBAL_WATER = -75.00912605315143
E_T_WATER = -6.707912854585658e-05
E_FCI_FROZEN_WATER = -74.97517427879919  # n_frozen_core=1, n_frozen_virt=1
TIGHT_SCF = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)
HUZ_SCF = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=200)
E_UKS_PRA_TIGHT = -130.98422067199579
E_TDA_PRA = [0.2571817023680199, 0.28597342599253944, 0.28597346094944326,
             0.298341582427509, 0.29834391721616615, 0.3286496317316542]
E_RPA_TDDFT_PRA = [0.23706672137321372, 0.2781701075763361, 0.27817015312900495,
                   0.2957509474091435, 0.2957533085486132, 0.32783573433483887]
MO_ENERGY_HUZ_PRA = [
    -15.346061882484072, -11.064014454583953, -1.156841645188095, -0.7609167984739847,
    -0.4700758272600682, -0.41887125809577913, -0.4188712134749228, 0.16553480249352165,
    0.16570479888423228, 0.35821090541485245, 0.35905603251177765, 0.35906504274380396,
    0.5707458518153601, 0.7425283369793041, 0.7752939126571655, 0.7753723871633147,
    1.3278085248081246, 6.8828942577196495]
STABILITY_PRA = [0.013627140527957458, 0.11220410451635107, 0.11220413480994564,
                 0.2503396663495806]
# nbed_tpu's (T) of the mu-embedded pfoa space (78 spin orbitals, 26
# occupied), from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "import chip_smoke as c; from
#   nbed_tpu import nbed; from nbed_tpu.ham import HamiltonianBuilder; from
#   nbed_tpu.solvers import run_ccsd; d = nbed(**c.CONFIGS['pfoa']); s =
#   d.mu['scf']; _, h1, h2 = HamiltonianBuilder(s, 0.0).build();
#   print(run_ccsd(h1, h2, d._interleaved_occ(s), conv_tol=1e-8,
#   triples=True))"
# (the embedding 524 s, the CCSD(T) 55 s on the development host's CPU)
E_T_PFOA = -0.00016767979109900255
E_CORR_PFOA = -0.01312410752243741

# nbed_tpu (JAX, float64, CPU) on water/STO-3G, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "from nbed_tpu.chem import
#   build_molecule; from nbed_tpu.solvers.gradients import hf_gradient,
#   ks_gradient, optimize_geometry; mol = build_molecule(open(
#   'tests/molecules/water.xyz').read(), 'sto-3g'); print(hf_gradient(mol)[1],
#   ks_gradient(mol, 'b3lyp')[1], ks_gradient(mol, 'cam-b3lyp')[1],
#   optimize_geometry(mol, gtol=1e-6))"
# and at that minimum X, with nbed_tpu.solvers' functions:
#   f, modes, _ = harmonic_frequencies(mol, coords=X); ir_intensities(mol,
#   modes, coords=X, mu_x=dipole_derivative_fd(mol, coords=X));
#   thermochemistry(mol, f, coords=X)
# (~7.5 min on the development host's CPU). The UHF oracle is
# tests/test_gradients.py:53's.
E_UHF_WATER = -74.96099960129165
GRAD_HF_WATER = [[9.017184855402624e-31, 1.4733017963517323e-15, -0.08063063784948785],
    [-3.4533676317076566e-17, -0.033802220301400815, 0.040315318924739274],
    [3.453367631707594e-17, 0.03380222030140001, 0.04031531892473797]]
GRAD_B3LYP_WATER = [[-1.6370961574517105e-16, 1.803998968704257e-15, -0.12477032612172023],
    [-6.465801378876512e-17, -0.057416337620411054, 0.062385163060863086],
    [6.076317171866771e-17, 0.05741633762040976, 0.06238516306086193]]
GRAD_CAMB3LYP_WATER = [[-2.7407098414492586e-16, -1.5026248174907201e-15, -0.1183501313215355],
    [-4.32401497199249e-18, -0.05465173600437294, 0.059175065660773504],
    [1.9077306959375713e-18, 0.054651736004374035, 0.05917506566077272]]
E_OPT_WATER = -74.96590119230012
X_OPT_WATER = [[-2.4071283815781346e-30, 3.595876291077367e-16, 0.2951781122764922],
    [1.774518746206486e-16, 1.432564800055482, -0.9063140951511007],
    [-1.774518746206449e-16, -1.4325648000554876, -0.9063140951510943]]
# the three vibrations (cm^-1) and their IR intensities (km/mol)
FREQ_WATER = [2169.9979375652642, 4140.015402781896, 4391.082673522297]
IR_WATER = [7.2377966391628465, 44.28669914271997, 29.964453930197365]
ZPE_WATER = 0.024378890505583534
S_WATER = 46.65891854196261  # cal/(mol K)
# nbed_tpu on the acetonitrile molecule (ACETONITRILE, STO-3G), from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "import chip_smoke as c; from
#   nbed_tpu.chem import build_molecule; from nbed_tpu.solvers.gradients import
#   hf_gradient, ks_gradient; from nbed_tpu.solvers import hessian_fd; mol =
#   build_molecule(c.ACETONITRILE, 'sto-3g'); print(hf_gradient(mol)[1],
#   ks_gradient(mol, 'b3lyp5')[1], hessian_fd(mol))"
# (gradients 137 s and 61 s, the Hessian's 36 displaced SCFs in one vmapped
# program 85 s on the development host's CPU); the Hessian's upper triangle,
# row by row, to 12 significant digits
GRAD_HF_PRA = [[0.018850694454185156, -1.572932127840995e-08, -1.1833869005342824e-06],
    [-0.03800599688270261, 8.210507481498443e-07, 1.0302820630882606e-05],
    [0.029339370931512093, -1.399048851954743e-05, -4.977518437375279e-05],
    [-0.0033939836326134466, -0.003053124682792629, 0.002199962138908133],
    [-0.0033924214105709024, -0.000358888168704588, -0.0036922734211194555],
    [-0.003397663459747253, 0.0034251980185942624, 0.0015329670328626185]]
GRAD_B3LYP5_PRA = [[-0.09382890113897686, 1.697297691002551e-07, -1.1012182519560175e-06],
    [0.07087384979392007, 1.034889288367e-06, 8.297012249883235e-06],
    [0.01718192495841525, -1.1855737446600885e-05, -4.136484277931647e-05],
    [0.0019257242851270203, 0.006618102376390242, -0.004760336957320119],
    [0.0019260474145071443, 0.0008296170916117819, 0.008158781464049275],
    [0.0019213546870172522, -0.007437068349611178, -0.0033642754579510034]]
HESS_PRA_UPPER = [1.64734700561, 8.82346529898e-08, 1.73483601088e-06, -1.66050711751,
    -8.44499160118e-08, -3.15446923296e-06, 0.00270979600921, 5.2796019678e-07,
    2.53738819136e-06, 0.00348313679183, 0.00143819188737, -0.0010352068016,
    0.00348394712414, 0.00017687014483, 0.00176224325505, 0.00348318646653,
    -0.00161562271134, -0.000728118945049, 0.0329615599474, 1.38124787001e-08,
    -1.58115666653e-07, -0.0577826531488, 6.15920808239e-08, 1.88880094952e-07,
    0.0265039716214, -8.4760413041e-08, 0.00389794820293, -0.000886190661822,
    0.000970198739622, 0.000480297281055, 0.000442059411492, -0.000203709699855,
    -0.00437836448037, -0.00123900846799, -0.000766479696826, 0.0329612076219,
    -1.39159689075e-06, 6.19099064117e-08, -0.0577820146331, 2.04348942189e-08,
    -8.29098796979e-08, 0.0265041367464, -0.00280505827276, 0.000970488603947,
    -0.0002359399693, 0.00477811049118, -0.000203633642577, -0.00156470936964,
    -0.00197341588034, -0.000766845613598, 0.000116863919169, 2.15030977777,
    -9.08555035044e-07, -1.94386981822e-06, -0.418849760545, -1.26480849332e-06,
    -4.47298048112e-06, -0.0236518253812, 0.00273153174574, -0.001964318996,
    -0.0236496427613, 0.000338198068639, 0.0033546306167, -0.0236514367977,
    -0.00306751865655, -0.00138246326899, 0.14082916764, -1.34808410441e-06,
    -7.19130545893e-07, -0.0981759935383, 6.34916929255e-07, -0.0362958765598,
    0.00679801554982, -0.0052348634786, -0.00447154320024, -0.000370772471865,
    0.00109954461017, 0.0407691318868, 0.00870200220349, 0.00413597024249,
    0.140826971084, 1.8506152632e-07, 6.351932265e-07, -0.0981803401837,
    0.0261200130647, -0.0052370700399, 0.0032886882632, -0.0444904013787,
    0.00109943370373, 0.0104617954879, 0.0183753016008, 0.00413828726724,
    0.00138477111804, 0.767823239885, -3.71809215555e-06, 8.30655837223e-05,
    -0.117218967206, -0.0980226030983, 0.0705405626218, -0.117246856183,
    -0.0120783632964, -0.120242214429, -0.117218057242, 0.110105319528,
    0.0496184612502, 0.788702791324, -1.226449451e-05, -0.100085525886, -0.29079327453,
    0.154596470828, -0.0123340638135, -0.0792213544228, -0.0324386905271,
    0.112424044643, -0.347016185075, -0.122146068334, 0.788828432415, 0.0720258793501,
    0.154597032605, -0.187237620537, -0.122772720178, -0.0324341212621, -0.39888683885,
    0.0506657108298, -0.122151199693, -0.1310277077, 0.12285641193, 0.105197441088,
    -0.0757053985709, 0.00726678514268, 0.0145995236227, -0.00849132780992,
    0.00726467737873, 0.0126864555828, -0.0111441419274, 0.297073468304,
    -0.165799317457, 0.00330767391907, 0.0072998838487, -0.00834875120073,
    -0.0146522035505, -0.0194916238865, 0.0238176589822, 0.186011012555,
    0.0165617912422, 0.0327915390605, -0.0143087243403, -0.00839745251632,
    -0.017323821247, 0.0124829057112, 0.122878730212, 0.0129614200086, 0.129035250859,
    0.00726725515917, 5.62235570377e-05, 0.0168878867683, 0.0701753841696,
    0.03479161188, -0.015997644618, 0.00167493890752, -0.0360449138217, 0.412991286108,
    -0.00541854330789, 0.00510004036899, -0.00869286457305, 0.122854593679,
    -0.118164893217, -0.0532516400531, 0.357369997937, 0.131003581646, 0.125736288036]
# nbed_tpu on water/cc-pVDZ: its analytic gradient is NaN there (the Boys
# derivative at t = 0 from order 5 on, ROADMAP queue 3), so the gradient is
# held to a five-point central difference (h = 1e-3 bohr) of nbed_tpu's UHF
# energies, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python -c "import numpy as np; from
#   nbed_tpu.chem import build_molecule; from nbed_tpu.scf.engine import
#   SCFEngine; mol = build_molecule(open('tests/molecules/water.xyz').read(),
#   'cc-pvdz'); e = lambda x: SCFEngine(mol, coords=x, conv_tol=1e-12,
#   dm_conv_tol=1e-10, max_cycle=200).kernel().e_tot; x0 = mol.coords; h =
#   1e-3; d = lambda a, k, s: e(x0 + s * h * np.eye(9)[3 * a + k].reshape(3,
#   3)); print([[(-d(a, k, 2) + 8 * d(a, k, 1) - 8 * d(a, k, -1) + d(a, k, -2))
#   / (12 * h) for k in range(3)] for a in range(3)])"
# (32 s on the development host's CPU), and the energy to
# nbed_tpu.solvers.gradients.hf_gradient(mol)[0] (21 min there)
E_UHF_WATER_DZ = -76.02702870817886
GRAD_FD_WATER_DZ = [[-7.105427357601002e-12, -4.973799150320701e-11, -2.7195170559934922e-05],
    [-3.789561257387201e-11, 0.002507082344986126, 1.3597680018998895e-05],
    [2.1316282072803006e-11, -0.002507082090374979, 1.3597767652602972e-05]]

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
# the reference's CL oracle system (water/6-31G) under each Jacobi localizer
for _loc in ("pm", "boys", "ibo"):
    CONFIGS[f"water631g_{_loc}"] = {**CONFIGS["water"], "basis": "6-31G",
                                    "localization": _loc, "run_fci_emb": False}
CONFIGS["acetonitrile_pao"] = {**CONFIGS["acetonitrile"], "virtual_localization": "pao"}
CONFIGS["acetonitrile_cis"] = {**CONFIGS["acetonitrile"], "run_ccsd_emb": False,
                               "run_cis_emb": 6, "run_rpa_emb": 6}
# the global diagnostics at a convergence that holds the HF orbitals to the
# oracles' 1e-7 (at the config's 1e-6 the global CCSD is 1.3e-7 off)
CONFIGS["water_global"] = {**CONFIGS["water"], "convergence": 1e-10}
CONFIGS["acetonitrile_post"] = {**CONFIGS["acetonitrile"], "run_ccsd_emb": False}

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
    """Median time of one call of ``fn`` on CUDA events recorded just
    before and after it: the card waits through the call's host work, so
    this is issue time plus device time."""
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


def stream_ms(fn, n: int = 100, warmup: int = 3) -> float:
    """Time per call of ``n`` calls enqueued back to back, on CUDA events
    around the run: the device time per call where the host keeps ahead."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def host_us(fn, n: int = 1000, warmup: int = 3) -> float:
    """Host microseconds per call of ``n`` enqueues (``perf_counter``,
    synchronised after the clock stops): the issue cost while the device
    keeps up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def device_us(fn, name: str, n: int = 20, tries: int = 3) -> float:
    """Self device time per launch of the kernels whose name holds
    ``name``, from torch.profiler over ``n`` calls. A profile whose trace
    lost the device events (seen after many profiles in one process) is
    taken again, up to ``tries`` times."""
    from nbed_tpu_torch.profiling import device_profile

    for _ in range(tries):
        _, prof = device_profile(lambda: [fn() for _ in range(n)])
        found = [ev[2] * 1e3 / ev[1] for ev in prof["top"] if name in ev[0]]
        if found:
            return found[0]
    raise RuntimeError(f"torch.profiler recorded no device event named {name!r} "
                       f"in {tries} profiles")


def timings(fn, m: int) -> dict:
    """``ms`` (single call), ``ms_stream`` and ``host_us`` of ``fn``; at
    M > 4096 the enqueues are 100, since the device, not the host, bounds
    them there."""
    return {"ms": median_ms(fn), "ms_stream": stream_ms(fn),
            "host_us": host_us(fn, 1000 if m <= 4096 else 100)}


def random_case(label, nao, seed, dtypes):
    """(label, g_j, g_k, dm, dtypes): seeded random supermatrices made on
    the card (a torch.Generator: quick at M = nao^2 in the thousands) and
    seeded symmetric densities."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = nao * nao
    g_j, g_k = (torch.randn((m, m), generator=gen, dtype=torch.float64, device="cuda")
                for _ in range(2))
    dm = torch.randn((2, nao, nao), generator=gen, dtype=torch.float64, device="cuda")
    return label, g_j, g_k, 0.5 * (dm + dm.transpose(-1, -2)), dtypes


def jk_cases():
    """(label, g_j, g_k, dm, dtypes) in float64 on the card: the real ERI
    supermatrices of water (STO-3G; 6-31G: M = 169, the shape of the
    localizer phases; cc-pVDZ: M = 576, the shape of the cc-pVDZ gradient
    phase) and acetonitrile STO-3G, acetonitrile's
    CAM-B3LYP exchange operator 0.19 (ik|jl) + 0.46 (ik|jl)_LR(0.33), the
    methyl radical's (M = 64, the shape of its ROHF/ROKS launches), the
    supermatrices of pfoa's SAD atoms (C, F, O: M = 25; H: M = 1, the shapes
    of pfoa's launches), seeded random symmetric ones at nao = 64, random
    ones at nao = 95 (M = 9025, odd: most rows misaligned; the largest
    exact-ERI molecule the driver runs, DF from nao 96) and, in float64
    only, at nao = 128 (M = 16384: the densities do not fit in shared
    memory beside the ring, the chunked path)."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import SCFEngine

    both = (torch.float64, torch.float32)
    rng = np.random.default_rng(11)
    cases = []
    atoms = tuple((f"pfoa SAD {el}", f"1\n\n{el} 0.0 0.0 0.0", "sto-3g", 0)
                  for el in "CFOH")
    for label, xyz, basis, spin in (("water", WATER.read_text(), "sto-3g", 0),
                                    ("water 6-31G", WATER.read_text(), "6-31g", 0),
                                    ("water cc-pVDZ", WATER.read_text(), "cc-pvdz", 0),
                                    ("acetonitrile", ACETONITRILE, "sto-3g", 0),
                                    ("methyl radical", METHYL.read_text(), "sto-3g", 1),
                                    *atoms):
        eng = SCFEngine(build_molecule(xyz, basis, spin=spin), device="cuda")
        n = eng.mol.nao
        dm = rng.standard_normal((2, n, n))
        dm = 0.5 * (dm + dm.swapaxes(-1, -2))
        cases.append((label, eng.eri_j, eng.eri_k,
                      torch.tensor(dm, dtype=torch.float64, device="cuda"), both))
        if label == "acetonitrile":
            cam = SCFEngine(eng.mol, xc="camb3lyp", device="cuda")
            cases.append(("acetonitrile camb3lyp folded K", cam.eri_j, cam.eri_k,
                          cases[-1][3], both))
    n = 64
    m = n * n
    g = rng.standard_normal((2, m, m))
    g = 0.5 * (g + g.swapaxes(-1, -2))
    dm = rng.standard_normal((2, n, n))
    dm = 0.5 * (dm + dm.swapaxes(-1, -2))
    cases.append(("random nao=64",
                  torch.tensor(g[0], device="cuda"), torch.tensor(g[1], device="cuda"),
                  torch.tensor(dm, device="cuda"), both))
    cases.append(random_case("random nao=95", 95, 95, both))
    cases.append(random_case("random nao=128", 128, 128, (torch.float64,)))
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


def hold_jk(label, gj, gk, dm) -> float:
    """The prepared kernel (its own path) and every path forced (vector,
    ring, chunked in three or more column chunks) against the plain
    version; two launches bitwise equal; one call captured in a CUDA graph
    and replayed equal to the eager result. Raises on a miss; returns the
    largest absolute error."""
    from nbed_tpu_torch.ops.jk import FusedJK, fused_jk_reference

    dtype = dm.dtype
    rtol, atol = TOLERANCES[dtype]
    j_ref, k_ref = fused_jk_reference(gj, gk, dm)
    m = int(dm.shape[-1]) ** 2
    prepared = FusedJK(gj, gk)
    err = 0.0
    for path in (None, "vector", "ring", "chunked"):
        jk = prepared if path is None else FusedJK(gj, gk, path=path,
                                                   chunk_cols=max(1, m // 3 + 1))
        j, k = jk(dm)
        torch.cuda.synchronize()
        what = f"fused_jk {label} {dtype} path {jk.plan.path}"
        if not (torch.isfinite(j).all() and torch.isfinite(k).all()):
            raise RuntimeError(f"{what}: non-finite output")
        e = max(float(torch.max(torch.abs(j - j_ref))), float(torch.max(torch.abs(k - k_ref))))
        if not (torch.allclose(j, j_ref, rtol=rtol, atol=atol)
                and torch.allclose(k, k_ref, rtol=rtol, atol=atol)):
            raise RuntimeError(f"{what}: max abs err {e} exceeds rtol={rtol}, atol={atol}")
        err = max(err, e)
        j2, k2 = jk(dm)
        if not (torch.equal(j, j2) and torch.equal(k, k2)):
            raise RuntimeError(f"{what}: two launches differ")
    j, k = prepared(dm)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        j_g, k_g = prepared(dm)
    graph.replay()
    torch.cuda.synchronize()
    if not (torch.equal(j_g, j) and torch.equal(k_g, k)):
        raise RuntimeError(f"fused_jk {label} {dtype}: CUDA-graph replay differs from eager")
    return err


def library_call(gj, gk, dm):
    """One PyTorch call for the same function, the yardstick: a batched
    GEMM of [G_J, G_K] against [[D_a + D_b, 0], [D_a, D_b]]."""
    m = int(dm.shape[-1]) ** 2
    g2 = torch.stack([gj, gk])
    rhs = torch.zeros((2, m, 2), dtype=dm.dtype, device="cuda")
    rhs[0, :, 0] = (dm[0] + dm[1]).reshape(-1)
    rhs[1] = dm.reshape(2, m).T
    return lambda: torch.bmm(g2, rhs)


def check_kernels() -> list:
    """Kernel against plain version at every case and dtype on every path
    (:func:`hold_jk`), then the times of the prepared kernel (the engines'
    call), the plain version and the library call (:func:`timings`), the
    kernel's self device time from torch.profiler, and the bound; returns
    rows."""
    from nbed_tpu_torch.ops.jk import FusedJK, fused_jk_reference

    rows = []
    for label, gj64, gk64, dm64, dtypes in jk_cases():
        for dtype in dtypes:
            gj, gk, dm = (t.to(dtype).contiguous() for t in (gj64, gk64, dm64))
            err = hold_jk(label, gj, gk, dm)
            m = int(dm.shape[-1]) ** 2
            prepared = FusedJK(gj, gk)
            kernel = lambda: prepared(dm)  # noqa: E731
            lib = library_call(gj, gk, dm)
            row = {"case": label, "m": m, "dtype": str(dtype).removeprefix("torch."),
                   "path": prepared.plan.path, "max_abs_err": err,
                   **timings(kernel, m),
                   **{f"plain_{k}": v for k, v in timings(
                       lambda: fused_jk_reference(gj, gk, dm), m).items()},
                   **{f"library_{k}": v for k, v in timings(lib, m).items()},
                   "kernel_device_us": device_us(kernel, "fused_jk"),
                   **dict(zip(("bound_ms", "bound_by"), jk_bound(m, dtype)))}
            row["share_of_bound"] = row["bound_ms"] * 1e3 / row["kernel_device_us"]
            del lib
            print("fused_jk", json.dumps(row), flush=True)
            rows.append(row)
        del gj64, gk64
    return rows


def _gate(label, pairs, tol):
    """Raise unless every (key, ours, reference) pair is finite and within
    ``tol``."""
    for key, ours, ref in pairs:
        if not np.isfinite(ours) or abs(ours - ref) > tol:
            raise RuntimeError(f"{label} {key} {ours} vs reference {ref} (tol {tol})")


def cluster_sums(excitations, strengths, tol: float = 1e-8) -> list:
    """[energy, summed oscillator strength] of each cluster of roots within
    ``tol`` Ha of the one before: the strengths of degenerate roots depend
    on the eigensolver's choice of basis in their subspace, their sum does
    not."""
    out = []
    for w, f in zip(excitations, strengths):
        if out and abs(w - out[-1][0]) < tol:
            out[-1][1] += float(f)
        else:
            out.append([float(w), float(f)])
    return out


def one_electron_ms(mol) -> dict:
    """Median ms of the torch overlap and dipole integrals of ``mol`` on the
    card (CUDA events around one call)."""
    from nbed_tpu_torch.integrals import dipole_integrals, overlap

    return {"overlap_ms": median_ms(lambda: overlap(mol), reps=10),
            "dipole_integrals_ms": median_ms(lambda: dipole_integrals(mol), reps=10)}


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


def run_water631g_localizers():
    """Water/6-31G with the Pipek-Mezey, Boys and IBO localizers, both
    projectors with CCSD: the global UKS and each projector's e_rhf and
    e_ccsd within 1e-6 Ha of nbed_tpu, and the localize stage's seconds."""
    from nbed_tpu_torch import nbed

    out, driver = {}, None
    for loc, ref in E_WATER631G.items():
        driver = None
        t0 = time.perf_counter()
        driver = nbed(**CONFIGS[f"water631g_{loc}"], device="cuda")
        wall = time.perf_counter() - t0
        gates = [("global UKS", driver._global_ks.e_tot, E_UKS_WATER631G)]
        for name, (e_rhf, e_ccsd) in ref.items():
            res = getattr(driver, name)
            gates += [(f"{name} e_rhf", res["e_rhf"], e_rhf),
                      (f"{name} e_ccsd", res["e_ccsd"], e_ccsd)]
        _gate(f"water631g_{loc}", gates, 1e-6)
        out[loc] = {"wall_s": wall, "localize_s": driver.timings["localize"],
                    "active_mo_inds": driver.localized_system.active_mo_inds.tolist(),
                    "dev_vs_nbed_tpu": {k: ours - theirs for k, ours, theirs in gates},
                    "stages_s": driver.timings}
    out["one_electron_nao13"] = one_electron_ms(driver._mol)
    print("water631g_localizers", json.dumps(out), flush=True)
    return driver


def run_acetonitrile_pao():
    """The PRA config with PAO virtuals in the Huzinaga projector: e_rhf and
    e_ccsd within 1e-6 Ha of nbed_tpu."""
    from nbed_tpu_torch import nbed

    t0 = time.perf_counter()
    driver = nbed(**CONFIGS["acetonitrile_pao"], device="cuda")
    wall = time.perf_counter() - t0
    res = driver.huzinaga
    if driver.localized_system.c_loc_virt is None or "cl" in res:
        raise RuntimeError("acetonitrile_pao did not take the PAO branch")
    _gate("acetonitrile_pao", [("e_rhf", res["e_rhf"], E_RHF_PRA_PAO),
                               ("e_ccsd", res["e_ccsd"], E_CCSD_PRA_PAO)], 1e-6)
    print("acetonitrile_pao", json.dumps({
        "wall_s": wall, "n_pao": driver.localized_system.c_loc_virt.shape[-1],
        "e_rhf": res["e_rhf"], "e_ccsd": res["e_ccsd"],
        "dev_vs_nbed_tpu": [res["e_rhf"] - E_RHF_PRA_PAO, res["e_ccsd"] - E_CCSD_PRA_PAO],
        "stages_s": driver.timings}), flush=True)
    return driver


def _hold_clusters(label, ours, ref, tol):
    if len(ours) != len(ref):
        raise RuntimeError(f"{label}: {len(ours)} clusters of roots vs reference {len(ref)}")
    _gate(label, [(f"cluster {i}", a[1], b[1]) for i, (a, b) in enumerate(zip(ours, ref))],
          tol)


def run_acetonitrile_cis():
    """The PRA config with embedded CIS and RPA (six roots each): the
    excitations within 1e-6 Ha of nbed_tpu, oscillator strengths summed over
    each cluster of degenerate roots within 1e-5; dipole moments (1e-5 D)
    and Mulliken/Loewdin charges (1e-6) of the embedded and the global
    solution; the electron count of a density cube (spacing 0.35 Bohr) to
    1e-8 relative. Then the seconds of CIS, RPA, the properties and the
    one-electron integrals at nao 18."""
    import tempfile

    from nbed_tpu_torch import nbed, properties
    from nbed_tpu_torch.driver import run_emb_cis, run_emb_rpa

    t0 = time.perf_counter()
    driver = nbed(**CONFIGS["acetonitrile_cis"], device="cuda")
    wall = time.perf_counter() - t0
    res = driver.huzinaga
    cis, rpa = res["cis"], res["rpa"]
    _gate("acetonitrile_cis", [(f"cis root {i}", w, r) for i, (w, r)
                               in enumerate(zip(cis.excitations, E_CIS_PRA))]
          + [(f"rpa root {i}", w, r) for i, (w, r)
             in enumerate(zip(rpa.excitations[:6], E_RPA_PRA))], 1e-6)
    if len(cis.excitations) != 6 or len(res["e_rpa"]) != 6:
        raise RuntimeError("acetonitrile_cis: not six CIS and six RPA roots")
    _hold_clusters("acetonitrile_cis CIS f", cluster_sums(
        cis.excitations, res["cis_oscillator_strengths"]), F_CIS_PRA, 1e-5)
    _hold_clusters("acetonitrile_cis RPA f", cluster_sums(
        rpa.excitations[:6], res["rpa_oscillator_strengths"]), F_RPA_PRA, 1e-5)
    out = {"wall_s": wall, "cis": cis.excitations.tolist(),
           "rpa": rpa.excitations[:6].tolist(), "n_pairs": len(cis.pairs),
           "rpa_n_imaginary": rpa.n_imaginary}
    for name, sol in (("embedded", res["scf"]), ("global", driver._global_ks)):
        ref = PROPERTIES_PRA[name]
        dip = properties.dipole_moment(sol)
        mull, low = properties.mulliken_charges(sol), properties.lowdin_charges(sol)
        _gate(f"acetonitrile_cis {name} dipole (D)",
              [(f"d{x}", a, b) for x, a, b in zip("xyz", dip, ref["dipole"])], 1e-5)
        _gate(f"acetonitrile_cis {name} charges",
              [(f"mulliken {i}", a, b) for i, (a, b) in enumerate(zip(mull, ref["mulliken"]))]
              + [(f"lowdin {i}", a, b) for i, (a, b) in enumerate(zip(low, ref["lowdin"]))],
              1e-6)
        out[name] = {"dipole_debye": dip.tolist(), "mulliken": mull.tolist()}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        vals = properties.density_cube(driver._global_ks, Path(tmp) / "rho.cube", spacing=0.35)
        out["density_cube_s"] = time.perf_counter() - t0
    n_el = float(vals.sum()) * 0.35 ** 3
    _gate("acetonitrile_cis density cube", [(
        "electrons / reference", n_el / N_ELECTRONS_CUBE_PRA, 1.0)], 1e-8)
    out.update(cube_shape=list(vals.shape), cube_electrons=n_el)

    sol = res["scf"]
    t0 = time.perf_counter()
    run_emb_cis(sol, nroots=6)
    torch.cuda.synchronize()
    out["run_emb_cis_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_emb_rpa(sol)
    torch.cuda.synchronize()
    out["run_emb_rpa_s"] = time.perf_counter() - t0
    out["one_electron_nao18"] = one_electron_ms(driver._mol)
    out["stages_s"] = driver.timings
    print("acetonitrile_cis", json.dumps(out), flush=True)
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


def pra_register(pra_scf, n_mo: int = 10):
    """The PRA Huzinaga SCF cut to ``n_mo`` MOs (10: the 20-qubit
    register): (constant, h1, h2) and its (n_alpha, n_beta)."""
    from nbed_tpu_torch.ham import HamiltonianBuilder, reduce_virtuals

    occ = pra_scf.mo_occ.cpu().numpy()
    scf = reduce_virtuals(pra_scf, occ.shape[-1] - n_mo)
    return HamiltonianBuilder(scf, 0.0).build(), (int(occ[0].sum()), int(occ[1].sum()))


def run_vqe_20q(pra_scf, water_sq, water_nelec):
    """One value-and-gradient of the VQE objective on the PRA Huzinaga SCF
    cut to 10 MOs (20 qubits) at seeded amplitudes: at theta = 0 the energy
    is <HF|H|HF> of the mapped sum; four gradient entries against central
    differences; the adjoint sweep against plain autograd at water's
    register."""
    from nbed_tpu_torch.ham import pauli_sum_to_sparse
    from nbed_tpu_torch.ham.qubit import _popcount
    from nbed_tpu_torch.solvers import vqe

    cuda = torch.device("cuda")
    sq, nelec = pra_register(pra_scf)
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


def check_pfoa_one_electron(driver):
    """At 126 AOs: the torch overlap on the card against the engine's S (C++
    engine) within 1e-12, the times of the torch one-electron integrals,
    and the global UKS dipole moment within 1e-5 D of nbed_tpu's."""
    from nbed_tpu_torch.integrals import overlap
    from nbed_tpu_torch.properties import dipole_moment

    mol = driver._mol
    s_err = float(torch.max(torch.abs(overlap(mol) - driver._ks_engine.s)))
    if not s_err <= 1e-12:
        raise RuntimeError(f"pfoa torch overlap vs engine S: max abs {s_err}")
    dip = dipole_moment(driver._global_ks)
    _gate("pfoa dipole (D)", [(f"d{x}", a, b) for x, a, b in zip("xyz", dip, DIPOLE_PFOA)],
          1e-5)
    print("pfoa_one_electron", json.dumps({
        "nao": mol.nao, "overlap_vs_engine_s": s_err, "dipole_debye": dip.tolist(),
        "dipole_dev_vs_nbed_tpu": (dip - np.asarray(DIPOLE_PFOA)).tolist(),
        **one_electron_ms(mol)}), flush=True)


def run_pfoa_incremental(driver):
    """pfoa's global DF-UKS again with incremental float32 J/K, on the DF
    factor the driver built, graphed (the default "auto"): within 1e-8 Ha
    of its float64 energy. A
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
        out[f"{mode}_run"] = {k: eng.last_run.get(k) for k in ("mode", "cycles", "mixed_cycles",
                                                              "captures", "capture_s")}
        if not sol.converged or eng.last_run["mode"] != "graph":
            raise RuntimeError(f"pfoa DF-UKS (incremental_jk={mode}): {eng.last_run['mode']} "
                               f"run, converged {sol.converged}")
        _gate("pfoa_incremental", [(f"e_uks incremental_jk={mode}", sol.e_tot,
                                    driver._global_ks.e_tot)], 1e-8)
        out[f"{mode}_dev_vs_f64"] = sol.e_tot - driver._global_ks.e_tot
    print("pfoa_incremental", json.dumps(out), flush=True)


def _interleaved(sol) -> np.ndarray:
    from nbed_tpu_torch.driver import NbedDriver

    return NbedDriver._interleaved_occ(sol)


def run_water_global(device="cuda"):
    """Water's global diagnostics: the driver's _global_ccsd and _global_fci
    against the reference's oracles (1e-7), global CCSD(T) with e_t within
    1e-9 of nbed_tpu's and between CCSD and FCI; restricted HF and B3LYP
    equal to unrestricted (1e-10); the builder with n_frozen_core=1 and
    n_frozen_virt=1, whose FCI equals the same freeze through run_emb_fci
    and nbed_tpu's value (1e-8)."""
    from nbed_tpu_torch.config import NbedConfig
    from nbed_tpu_torch.driver import NbedDriver, run_emb_fci
    from nbed_tpu_torch.ham import HamiltonianBuilder
    from nbed_tpu_torch.scf import SCFEngine
    from nbed_tpu_torch.solvers import run_ccsd, run_fci

    driver = NbedDriver(NbedConfig(**CONFIGS["water_global"]), device=device)
    e_ccsd, _ = driver._global_ccsd
    e_fci = driver._global_fci
    hf = driver._global_hf
    _, h1, h2 = HamiltonianBuilder(hf, 0.0).build()
    t0 = time.perf_counter()
    _, e_t, _ = run_ccsd(h1, h2, _interleaved(hf), conv_tol=driver.config.convergence,
                         triples=True)
    ccsd_t_s = time.perf_counter() - t0
    _gate("water_global", [("ccsd", e_ccsd, E_CCSD_GLOBAL_WATER),
                           ("fci", e_fci, E_FCI_GLOBAL_WATER)], 1e-7)
    _gate("water_global", [("e_t", e_t, E_T_WATER)], 1e-9)
    if not (e_t < 0 and abs(e_ccsd + e_t - e_fci) < 0.5 * abs(e_ccsd - e_fci)):
        raise RuntimeError(f"water_global: CCSD(T) {e_ccsd + e_t} not between CCSD "
                           f"{e_ccsd} and FCI {e_fci}")

    out = {"e_ccsd": e_ccsd, "e_fci": e_fci, "e_t": e_t, "ccsd_t_s": ccsd_t_s,
           "n_triples": int(_interleaved(hf).sum()) ** 3}
    mol = driver._mol
    for xc in (None, "b3lyp"):
        r = SCFEngine(mol, xc=xc, restricted=True, device=device, **WATER_SCF).kernel()
        u = SCFEngine(mol, xc=xc, device=device, **WATER_SCF).kernel()
        if r.mo_coeff.ndim != 2 or sorted(set(r.mo_occ.tolist())) != [0.0, 2.0]:
            raise RuntimeError(f"water restricted {xc}: not reported restricted")
        _gate(f"water restricted {xc}", [("e_tot", r.e_tot, u.e_tot)], 1e-10)
        out[f"restricted_{xc}_dev"] = r.e_tot - u.e_tot

    const, h1f, h2f = HamiltonianBuilder(hf, 0.0, n_frozen_core=1, n_frozen_virt=1).build()
    n = hf.mol.nao
    e_frozen = float(run_fci(const, h1f, h2f, h1f.shape[0], (4, 4))[0][0]) + hf.energy_nuc()
    _gate("water frozen-core FCI", [
        ("vs run_emb_fci(frozen=[0, n-1])", e_frozen, run_emb_fci(hf, frozen=[0, n - 1])),
        ("vs the reference", e_frozen, E_FCI_FROZEN_WATER)], 1e-8)
    if not e_frozen > e_fci - 1e-10:
        raise RuntimeError(f"water frozen FCI {e_frozen} below the full FCI {e_fci}")
    out.update(e_fci_frozen=e_frozen, n_spin_orbitals_frozen=h1f.shape[0])
    print("water_global", json.dumps(out), flush=True)


def run_acetonitrile_post(device="cuda"):
    """The PRA molecule after the SCF: global B3LYP5 UKS TDA (dense and
    Davidson, 6 roots) and RPA-TDDFT (6 roots) within 1e-8 Ha of nbed_tpu,
    and a 2-root Davidson TDA under max_memory_mb=300 within that budget;
    huzinaga_scf restricted and unrestricted on the driver's v_emb and
    D_env, equal to each other and to nbed_tpu's orbital energies (1e-8);
    the four lowest stability eigenvalues of the Huzinaga embedded solution
    within 1e-8 of nbed_tpu's."""
    from nbed_tpu_torch import nbed
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.ham import HamiltonianBuilder
    from nbed_tpu_torch.scf import SCFEngine, huzinaga_scf
    from nbed_tpu_torch.solvers import run_stability, run_tddft_rpa, run_tddft_tda

    mol = build_molecule(ACETONITRILE, "sto-3g")
    out = {}
    # first in the phase, since it resets the peak counter: under a 300-MB
    # budget a Davidson TDA allocates at most 300 MB above what was
    # allocated before it (its roots are held to the default budget's
    # below). Davidson, not dense: the budget cuts blocks to 2 vectors and
    # the grid to 4 chunks, and the 77 blocks of a dense TDA took 50 s
    # (H100 80GB HBM3, 700 W)
    small = SCFEngine(mol, xc="b3lyp5", device=device, max_memory_mb=300.0,
                      **TIGHT_SCF).kernel()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bounded = run_tddft_tda(small, nroots=2, method="davidson").excitations
    torch.cuda.synchronize()
    out["tda_300mb_s"] = time.perf_counter() - t0
    out["tda_300mb_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
    if not out["tda_300mb_peak_mb"] <= 300.0:
        raise RuntimeError(f"acetonitrile_post: TDA under max_memory_mb=300 allocated "
                           f"{out['tda_300mb_peak_mb']:.1f} MB")
    del small
    sol = SCFEngine(mol, xc="b3lyp5", device=device, **TIGHT_SCF).kernel()
    _gate("acetonitrile_post", [("e_uks", sol.e_tot, E_UKS_PRA_TIGHT)], 1e-8)
    t0 = time.perf_counter()
    dense = run_tddft_tda(sol, nroots=6, method="dense").excitations
    out["tda_dense_s"] = time.perf_counter() - t0
    stats = {}
    t0 = time.perf_counter()
    dav = run_tddft_tda(sol, nroots=6, method="davidson", stats=stats).excitations
    out["tda_davidson_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rpa = run_tddft_rpa(sol, nroots=6).excitations
    out["rpa_s"] = time.perf_counter() - t0
    _gate("acetonitrile_post TDA", [(f"root {i}", a, b) for i, (a, b)
                                    in enumerate(zip(dense, E_TDA_PRA))], 1e-8)
    _gate("acetonitrile_post Davidson", [(f"root {i}", a, b) for i, (a, b)
                                         in enumerate(zip(dav, dense))], 1e-8)
    _gate("acetonitrile_post TDA at 300 MB", [(f"root {i}", a, b) for i, (a, b)
                                              in enumerate(zip(bounded, dense))], 1e-8)
    _gate("acetonitrile_post RPA", [(f"root {i}", a, b) for i, (a, b)
                                    in enumerate(zip(rpa, E_RPA_TDDFT_PRA))], 1e-8)
    if len(dav) != 6 or max(stats["residuals"]) > 1e-8:
        raise RuntimeError(f"acetonitrile_post Davidson: residuals {stats['residuals']}")
    out.update(tda=dense.tolist(), rpa=rpa.tolist(), davidson_iterations=stats["iterations"],
               davidson_s_per_block=stats["matvec_s"] / stats["matvec_blocks"])

    driver = nbed(**CONFIGS["acetonitrile_post"], device=device)
    v_emb = driver.embedding_potential
    dm_env = driver.localized_system.dm_enviro
    na = len(driver.localized_system.active_mo_inds[0])
    t0 = time.perf_counter()
    r = huzinaga_scf(SCFEngine(mol, restricted=True, device=device, **HUZ_SCF),
                     v_emb[0], dm_env[0] + dm_env[1], nelec=(na, na))
    u = huzinaga_scf(SCFEngine(mol, device=device, **HUZ_SCF), v_emb, dm_env,
                     nelec=(na, na))
    out["huzinaga_scf_s"] = time.perf_counter() - t0
    if not (r[4] and u[4]):
        raise RuntimeError("acetonitrile_post: huzinaga_scf did not converge")
    e_r = r[1].cpu().numpy()
    _gate("acetonitrile_post huzinaga restricted vs unrestricted",
          [(f"mo {i}", a, b) for i, (a, b) in enumerate(zip(e_r, u[1][0].tolist()))]
          + [("density", float(torch.max(torch.abs(r[2] - u[2][0] - u[2][1]))), 0.0)], 1e-8)
    _gate("acetonitrile_post huzinaga vs the reference",
          [(f"mo {i}", a, b) for i, (a, b) in enumerate(zip(e_r, MO_ENERGY_HUZ_PRA))], 1e-8)

    emb = driver.huzinaga["scf"]
    _, h1, h2 = HamiltonianBuilder(emb, 0.0).build()
    stab = run_stability(h1, h2, _interleaved(emb))
    _gate("acetonitrile_post stability", [(f"eig {i}", a, b) for i, (a, b) in enumerate(
        zip(stab.eigenvalues, STABILITY_PRA))], 1e-8)
    out.update(stability=stab.eigenvalues.tolist(), stable=stab.stable,
               n_pairs=len(stab.pairs))
    print("acetonitrile_post", json.dumps(out), flush=True)


def run_h2_stability(device="cuda"):
    """H2/STO-3G at 2.5 angstrom (tests/test_stability.py:52-66): the
    spin-symmetric solution is unstable (lowest eigenvalue < -0.05), and
    stable_scf lands on a stable broken-symmetry solution 0.05 Ha lower,
    within 0.02 of two STO-3G H atoms, with <S^2> > 0.5."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.ham import HamiltonianBuilder
    from nbed_tpu_torch.scf import SCFEngine
    from nbed_tpu_torch.solvers import run_stability, stable_scf

    mol = build_molecule("2\n\nH 0.0 0.0 0.0\nH 2.5 0.0 0.0", "sto-3g")
    engine = SCFEngine(mol, conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=200,
                       device=device)
    sym = engine.kernel()
    _, h1, h2 = HamiltonianBuilder(sym, 0.0).build()
    stab = run_stability(h1, h2, _interleaved(sym))
    if stab.stable or not stab.lowest < -0.05:
        raise RuntimeError(f"h2_stability: symmetric solution lowest {stab.lowest}")
    bs, stab_bs = stable_scf(engine, sol=sym)
    s2 = bs.spin_square()[0]
    if not (stab_bs.stable and bs.e_tot < sym.e_tot - 0.05
            and abs(bs.e_tot - 2 * -0.46658185) < 0.02 and s2 > 0.5):
        raise RuntimeError(f"h2_stability: broken-symmetry e_tot {bs.e_tot} (symmetric "
                           f"{sym.e_tot}), stable {stab_bs.stable}, <S^2> {s2}")
    print("h2_stability", json.dumps({
        "lowest_symmetric": stab.lowest, "lowest_broken": stab_bs.lowest,
        "e_symmetric": sym.e_tot, "e_broken": bs.e_tot, "s2": s2}), flush=True)


def _sync_s(t0: float, device) -> float:
    """Seconds since ``t0`` once ``device`` has finished its work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _gate_array(label, ours, ref, tol):
    """Raise unless ``ours`` is finite and within ``tol`` of ``ref``
    everywhere; returns the largest deviation."""
    ours = np.asarray(ours, dtype=np.float64)
    dev = float(np.max(np.abs(ours - np.asarray(ref)))) if np.all(np.isfinite(ours)) \
        else float("inf")
    if not dev <= tol:
        raise RuntimeError(f"{label}: {dev} off the reference (tol {tol})")
    return dev


def _fd_components(energy, x0, picks, h=1e-4):
    """Central differences of ``energy(coords)`` at ``x0`` on the (atom,
    axis) ``picks``."""
    out = {}
    for a, k in picks:
        es = []
        for sgn in (1.0, -1.0):
            x = np.array(x0, dtype=np.float64)
            x[a, k] += sgn * h
            es.append(energy(x))
        out[(a, k)] = (es[0] - es[1]) / (2 * h)
    return out


def run_water_derivatives(device="cuda"):
    """Water/STO-3G (M = 49): the UHF gradient against the oracle energy
    (5e-8), nbed_tpu's gradient (1e-8) and a central difference on the card
    (2e-7, three components), with its translational sum <= 1e-9; the
    B3LYP gradient with grid response against nbed_tpu (1e-7) and a card
    FD (1e-6); CAM-B3LYP's against nbed_tpu (1e-7); a BFGS optimization
    to gtol 1e-6 ending within 1e-8 Ha of nbed_tpu's minimum; at nbed_tpu's
    minimum the three vibrations (0.5 cm^-1), TR modes |nu| < 30, IR
    intensities (1e-3 relative), ZPE (1e-8 Ha) and entropy (1e-3
    cal/(mol K))."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import SCFEngine
    from nbed_tpu_torch.solvers import (dipole_derivative_fd, harmonic_frequencies,
                                        hessian_fd, hf_gradient, ir_intensities, ks_gradient,
                                        optimize_geometry, thermochemistry)
    from nbed_tpu_torch.solvers.thermo import HA_PER_K_TO_CAL_MOL_K

    mol = build_molecule(WATER.read_text(), "sto-3g")
    picks = [(0, 2), (1, 1), (2, 0)]
    out = {}
    t0 = time.perf_counter()
    e, g, res = hf_gradient(mol, device=device)
    out["hf_gradient_s"] = _sync_s(t0, device)
    out["hf_graph_vs_eager"] = _hold_single(
        "water hf_gradient SCF", res, hf_gradient(mol, device=device, jit_kernel="off")[2])
    g = g.cpu().numpy()
    _gate("water hf_gradient", [("e_tot", e, E_UHF_WATER)], 5e-8)
    out["hf_dev"] = _gate_array("water hf_gradient", g, GRAD_HF_WATER, 1e-8)
    fd = _fd_components(lambda x: hf_gradient(mol, coords=x, device=device)[0],
                        mol.coords, picks)
    out["hf_fd_dev"] = _gate_array("water hf_gradient vs FD", [g[p] for p in picks],
                                   [fd[p] for p in picks], 2e-7)
    out["hf_sum"] = _gate_array("water hf_gradient sum", g.sum(axis=0), 0.0, 1e-9)

    t0 = time.perf_counter()
    _, g, _ = ks_gradient(mol, "b3lyp", device=device)
    out["b3lyp_gradient_s"] = _sync_s(t0, device)
    g = g.cpu().numpy()
    out["b3lyp_dev"] = _gate_array("water b3lyp gradient", g, GRAD_B3LYP_WATER, 1e-7)
    fd = _fd_components(lambda x: SCFEngine(mol, xc="b3lyp", coords=x, conv_tol=1e-12,
                                            dm_conv_tol=1e-10, max_cycle=200,
                                            device=device).kernel().e_tot,
                        mol.coords, picks)
    out["b3lyp_fd_dev"] = _gate_array("water b3lyp gradient vs FD", [g[p] for p in picks],
                                      [fd[p] for p in picks], 1e-6)
    _, g, _ = ks_gradient(mol, "cam-b3lyp", device=device)
    out["camb3lyp_dev"] = _gate_array("water cam-b3lyp gradient", g.cpu().numpy(),
                                      GRAD_CAMB3LYP_WATER, 1e-7)

    t0 = time.perf_counter()
    x_opt, e_opt, steps, ok = optimize_geometry(mol, gtol=1e-6, device=device)
    out.update(optimize_s=_sync_s(t0, device), optimize_steps=steps,
               optimize_x_dev=float(np.max(np.abs(x_opt - np.asarray(X_OPT_WATER)))))
    if not ok:
        raise RuntimeError("water optimize_geometry did not converge")
    _gate("water optimize_geometry", [("e_min", e_opt, E_OPT_WATER)], 1e-8)

    t0 = time.perf_counter()
    freqs, modes, hess = harmonic_frequencies(mol, coords=X_OPT_WATER, device=device)
    out["hessian_s"] = _sync_s(t0, device)
    # the lanes' gradients within 1e-10 Ha/bohr, divided by 2h = 0.01
    out["hessian_graph_vs_eager"] = _gate_array(
        "water Hessian graphed vs eager lanes", hess,
        hessian_fd(mol, coords=X_OPT_WATER, device=device, jit_kernel="off"), 1e-8)
    out["freq_dev"] = _gate_array("water frequencies", freqs[-3:], FREQ_WATER, 0.5)
    out["tr_max"] = _gate_array("water TR modes", freqs[:6], 0.0, 30.0)
    t0 = time.perf_counter()
    mu_x = dipole_derivative_fd(mol, coords=X_OPT_WATER, device=device)
    out["dipole_derivative_s"] = _sync_s(t0, device)
    ir = ir_intensities(mol, modes, mu_x=mu_x)[-3:]
    out["ir_rel_dev"] = _gate_array("water IR intensities", ir / np.asarray(IR_WATER), 1.0,
                                    1e-3)
    thermo = thermochemistry(mol, freqs, coords=X_OPT_WATER)
    s_cal = thermo["s_tot"] * HA_PER_K_TO_CAL_MOL_K
    _gate("water thermochemistry", [("zpe", thermo["zpe"], ZPE_WATER)], 1e-8)
    _gate("water thermochemistry", [("s_tot cal/(mol K)", s_cal, S_WATER)], 1e-3)
    out.update(e_opt=e_opt, freqs=freqs[-3:].tolist(), ir=ir.tolist(), zpe=thermo["zpe"],
               s_cal=s_cal)
    print("water_derivatives", json.dumps(out), flush=True)


def run_acetonitrile_derivatives(device="cuda"):
    """The acetonitrile molecule (STO-3G, nao 18, M = 324): UHF and
    B3LYP5 gradients within 1e-7 Ha/bohr of nbed_tpu's; the HF Hessian by
    central differences over 36 displaced SCFs (one batched call: a lane
    SCF and its reverse-mode passes), symmetric to 1e-12, its translational
    sum rule within 5e-6 and within 1e-6 Ha/bohr^2 of nbed_tpu's; returns
    it for :func:`run_hessian_mesh`."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.solvers import hessian_fd, hf_gradient, ks_gradient

    mol = build_molecule(ACETONITRILE, "sto-3g")
    out = {}
    t0 = time.perf_counter()
    _, g, _ = hf_gradient(mol, device=device)
    out["hf_gradient_s"] = _sync_s(t0, device)
    out["hf_dev"] = _gate_array("acetonitrile hf_gradient", g.cpu().numpy(), GRAD_HF_PRA,
                                1e-7)
    t0 = time.perf_counter()
    _, g, _ = ks_gradient(mol, "b3lyp5", device=device)
    out["b3lyp5_gradient_s"] = _sync_s(t0, device)
    out["b3lyp5_dev"] = _gate_array("acetonitrile b3lyp5 gradient", g.cpu().numpy(),
                                    GRAD_B3LYP5_PRA, 1e-7)
    t0 = time.perf_counter()
    hess = hessian_fd(mol, device=device)
    out["hessian_s"] = _sync_s(t0, device)
    # the 36 lanes eager against the graphed lanes, at the Hessian's gate
    # against nbed_tpu: two runs' densities differ within dm_conv_tol 1e-8
    # and their gradients at ~1e-9 Ha/bohr, divided by 2h = 0.01 (the
    # lanes' energies are held at 1e-10 Ha in hessian_mesh); their walls and
    # idle shares come from scripts/bench_fleet.py
    t0 = time.perf_counter()
    hess_eager = hessian_fd(mol, device=device, jit_kernel="off")
    out["hessian_eager_s"] = _sync_s(t0, device)
    out["hessian_graph_vs_eager"] = _gate_array("acetonitrile Hessian graphed vs eager",
                                                hess, hess_eager, 1e-6)
    out["hessian_asym"] = _gate_array("acetonitrile Hessian symmetry", hess, hess.T, 1e-12)
    out["sum_rule"] = _gate_array("acetonitrile Hessian sum rule",
                                  hess.reshape(18, 6, 3).sum(axis=1), 0.0, 5e-6)
    ref = np.zeros((18, 18))
    ref[np.triu_indices(18)] = HESS_PRA_UPPER
    ref = ref + np.triu(ref, 1).T
    out["hessian_dev"] = _gate_array("acetonitrile Hessian", hess, ref, 1e-6)
    print("acetonitrile_derivatives", json.dumps(out), flush=True)
    return hess


DERIVATIVE_KINDS = ("eri", "hf_grad", "ks_grad")


def _derivative_runs(before: dict) -> dict:
    """The derivative programs' replays, captures, capture seconds and
    graph pool GB since ``before`` (a copy of RUNS)."""
    from nbed_tpu_torch.ops.programs import RUNS

    keys = [f"{k}{suffix}" for k in DERIVATIVE_KINDS
            for suffix in ("", "_captures", "_capture_s", "_pool_gb")]
    return {k: RUNS.get(k, 0) - before.get(k, 0) for k in keys
            if RUNS.get(k, 0) != before.get(k, 0)}


def _two_routes(label: str, run, x_first, x_second, tol: float, device="cuda",
                on_graphed_scf=None) -> tuple:
    """``run(coords, jit_kernel)`` graphed at ``x_first`` (its structure's
    programs captured here or in an earlier phase), graphed at
    ``x_second``, which must capture nothing, and eager there: returns
    (the graphed result at ``x_first``, a row of walls, captures, graph
    pools and the graph-vs-eager deviation, held to ``tol``). With
    ``on_graphed_scf(graphed)``, the eager gradient on the graphed SCF's
    solution is what is held (the two routes' own SCFs differ at their
    convergence tolerance); the two whole jobs' deviation is printed."""
    from nbed_tpu_torch.ops.programs import RUNS

    def result(out):
        if isinstance(out, tuple):
            out = out[1] if len(out) == 3 else out[0]
        return out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)

    before = dict(RUNS)
    t0 = time.perf_counter()
    first = run(x_first, "auto")
    row = {"first_s": _sync_s(t0, device),
           "first_captures": RUNS["captures"] - before.get("captures", 0)}
    mid = dict(RUNS)
    t0 = time.perf_counter()
    graphed = run(x_second, "auto")
    row["graphed_s"] = _sync_s(t0, device)
    row["second_captures"] = RUNS["captures"] - mid.get("captures", 0)
    if row["second_captures"]:
        raise RuntimeError(f"{label}: {row['second_captures']} captures at a second geometry")
    row["programs"] = _derivative_runs(before)
    t0 = time.perf_counter()
    eager = run(x_second, "off")
    row["eager_s"] = _sync_s(t0, device)
    if on_graphed_scf is None:
        row["graph_vs_eager"] = _gate_array(f"{label} graphed vs eager", result(graphed),
                                            result(eager), tol)
    else:
        row["job_dev"] = float(np.max(np.abs(result(graphed) - result(eager))))
        row["graph_vs_eager"] = _gate_array(f"{label} graphed vs eager", result(graphed),
                                            result(on_graphed_scf(graphed)), tol)
    return first, row


def run_derivatives_graphed(device="cuda"):
    """The derivative programs (the "eri" program, "hf_grad" single and
    lanes, "ks_grad") graphed against the eager route (``jit_kernel="off"``)
    at a second geometry of each structure (atom 0 moved 0.01 bohr), where
    no program may capture: gradients within 1e-11 Ha/bohr (water HF,
    B3LYP and CAM-B3LYP, acetonitrile HF and B3LYP5, water/cc-pVDZ HF),
    Hessians within 1e-9 Ha/bohr^2 (acetonitrile's 36-lane HF, water's
    B3LYP from 18 ks_gradient calls), water/cc-pVDZ ERIs within 1e-12
    (full and omega = 0.33), the water BFGS (gtol 1e-6) both ways within
    1e-10 Ha; at the first geometry the graphed results against
    nbed_tpu's pinned values at the earlier phases' gates. Prints walls,
    captures, replays and the derivative programs' graph pools
    (memory_reserved growth over their captures) per case."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.integrals import eri_tensor
    from nbed_tpu_torch.integrals.eri import eri_program
    from nbed_tpu_torch.solvers import hessian_fd, hf_gradient, ks_gradient, optimize_geometry

    water = build_molecule(WATER.read_text(), "sto-3g")
    pra = build_molecule(ACETONITRILE, "sto-3g")
    dz = build_molecule(WATER.read_text(), "cc-pvdz")
    tight = dict(conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=200)

    def moved(x):
        x = np.array(x, dtype=np.float64)
        x[0] += 0.01
        return x

    out = {"reserved_gb_before": _reserved_gb()}
    cases = (
        ("water_hf", water, None, GRAD_HF_WATER, 1e-8),
        ("water_b3lyp", water, "b3lyp", GRAD_B3LYP_WATER, 1e-7),
        ("water_camb3lyp", water, "cam-b3lyp", GRAD_CAMB3LYP_WATER, 1e-7),
        ("acetonitrile_hf", pra, None, GRAD_HF_PRA, 1e-7),
        ("acetonitrile_b3lyp5", pra, "b3lyp5", GRAD_B3LYP5_PRA, 1e-7),
        ("water_ccpvdz_hf", dz, None, GRAD_FD_WATER_DZ, 1e-8),
    )
    for name, mol, xc, pinned, pinned_tol in cases:
        x2 = moved(mol.coords)
        if xc is None:
            def run(x, m, mol=mol):
                return hf_gradient(mol, coords=x, device=device, jit_kernel=m, **tight)

            def same_scf(out, mol=mol, x2=x2):
                return hf_gradient(mol, coords=x2, scf_result=out[2], device=device,
                                   jit_kernel="off")
        else:
            def run(x, m, mol=mol, xc=xc):
                return ks_gradient(mol, xc, coords=x, device=device, jit_kernel=m, **tight)

            def same_scf(out, mol=mol, xc=xc, x2=x2):
                return ks_gradient(mol, xc, coords=x2, solution=out[2], device=device,
                                   jit_kernel="off")
        first, row = _two_routes(f"{name} gradient", run, mol.coords, x2, 1e-11, device,
                                 same_scf)
        row["pinned_dev"] = _gate_array(f"{name} gradient (graphed)",
                                        first[1].cpu().numpy(), pinned, pinned_tol)
        out[name] = row

    ref = np.zeros((18, 18))
    ref[np.triu_indices(18)] = HESS_PRA_UPPER
    ref = ref + np.triu(ref, 1).T
    # the Hessians at the SCF tolerances of the pinned Hessian (1e-10, 1e-8)
    first, row = _two_routes("acetonitrile 36-lane Hessian",
                             lambda x, m: hessian_fd(pra, coords=x, device=device, jit_kernel=m),
                             pra.coords, moved(pra.coords), 1e-9, device)
    row["pinned_dev"] = _gate_array("acetonitrile Hessian (graphed)", first, ref, 1e-6)
    out["acetonitrile_hessian"] = row
    first, row = _two_routes("water B3LYP Hessian",
                             lambda x, m: hessian_fd(water, coords=x, xc="b3lyp", device=device,
                                                     jit_kernel=m),
                             np.asarray(X_OPT_WATER), moved(X_OPT_WATER), 1e-9, device)
    row["asym"] = _gate_array("water B3LYP Hessian symmetry", first, first.T, 1e-12)
    out["water_ks_hessian"] = row

    def eris(x, mode):
        xt = torch.tensor(x, dtype=torch.float64, device=device)
        if mode == "off":
            return torch.stack([eri_tensor(dz, xt, device=device),
                                eri_tensor(dz, xt, omega=0.33, device=device)])
        return torch.stack([eri_program(dz, xt, jit_kernel=mode),
                            eri_program(dz, xt, omega=0.33, jit_kernel=mode)])

    _, out["eri_ccpvdz"] = _two_routes("water cc-pVDZ eri program", eris, dz.coords,
                                       moved(dz.coords), 1e-12, device)

    walls, opt = {}, {}
    for mode in ("auto", "off"):
        t0 = time.perf_counter()
        x_opt, e_opt, steps, ok = optimize_geometry(water, gtol=1e-6, device=device,
                                                    jit_kernel=mode)
        walls[mode] = _sync_s(t0, device)
        if not ok:
            raise RuntimeError(f"water optimize_geometry ({mode}) did not converge")
        _gate(f"water optimize_geometry ({mode})", [("e_min", e_opt, E_OPT_WATER)], 1e-8)
        opt[mode] = (x_opt, e_opt, steps)
    out["water_optimize"] = {
        "graphed_s": walls["auto"], "eager_s": walls["off"],
        "steps": [opt["auto"][2], opt["off"][2]],
        "graph_vs_eager_e": _gate_array("water optimize_geometry graphed vs eager",
                                        opt["auto"][1], opt["off"][1], 1e-10),
        "graph_vs_eager_x": float(np.max(np.abs(opt["auto"][0] - opt["off"][0])))}
    out["reserved_gb_after"] = _reserved_gb()
    print("derivatives_graphed", json.dumps(out), flush=True)


def run_hessian_mesh(hess, device="cuda"):
    """The acetonitrile Hessian's 36 displaced lanes in two groups of a
    mesh's 'batch' axis. The mesh changes only how the lanes' gradients are
    batched, so those are held to the one-group gradients at 1e-12
    Ha/bohr; the Hessian divides their differences by 2h = 0.01, so the
    same 1e-12 is 1e-10 Ha/bohr^2 there. The one-group lanes run again
    eagerly: their energies within 1e-10 Ha of the graphed lanes', and how
    far their gradients land is printed (the ERI accumulation adds with
    atomics on the card, in no fixed order)."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.parallel import batched_hf_gradients
    from nbed_tpu_torch.solvers import hessian_fd
    from nbed_tpu_torch.solvers.hessian import _displacements

    mol = build_molecule(ACETONITRILE, "sto-3g")
    disp = _displacements(np.asarray(mol.coords), 5e-3)
    e_one, one, _ = batched_hf_gradients(mol, disp, device=device)
    one = one.cpu().numpy()
    # the repeat runs its lanes eagerly: within 1e-10 Ha of the graphed lanes
    e_again, again, _ = batched_hf_gradients(mol, disp, device=device, jit_kernel="off")
    again = again.cpu().numpy()
    t0 = time.perf_counter()
    meshed = batched_hf_gradients(mol, disp, mesh=_cuda_mesh(2), device=device)[1]
    out = {"mesh_gradients_s": _sync_s(t0, device),
           "repeat_grad_dev": float(np.max(np.abs(again - one))),
           "graph_vs_eager_e": _gate_array("acetonitrile Hessian lanes graphed vs eager",
                                           e_one.cpu().numpy(), e_again.cpu().numpy(),
                                           1e-10)}
    out["mesh_grad_dev"] = _gate_array("acetonitrile Hessian lanes' gradients on a mesh",
                                       meshed.cpu().numpy(), one, 1e-12)
    hess_mesh = hessian_fd(mol, mesh=_cuda_mesh(2), device=device)
    out["mesh_hessian_dev"] = _gate_array("acetonitrile Hessian on a mesh", hess_mesh, hess,
                                          1e-10)
    print("hessian_mesh", json.dumps(out), flush=True)


def run_water_ccpvdz_gradient(device="cuda"):
    """Water/cc-pVDZ (nao 24, d shells, M = 576): the torch ERI tensor within
    1e-10 of the C++ engine's and torch V within 1e-11 of its V; the seconds
    of eri_tensor forward and backward (a first and a second call); the UHF
    energy within 1e-8 Ha of nbed_tpu's and its gradient within 1e-8
    Ha/bohr of a five-point central difference of nbed_tpu's energies
    (nbed_tpu's own analytic gradient is NaN here)."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.integrals import eri_tensor, native, nuclear_attraction
    from nbed_tpu_torch.solvers import hf_gradient

    mol = build_molecule(WATER.read_text(), "cc-pvdz")
    out = {}
    w = torch.tensor(np.random.default_rng(2).standard_normal((mol.nao,) * 4),
                     device=device)
    for call in ("first", "second"):
        x = torch.tensor(mol.coords, device=device, requires_grad=True)
        t0 = time.perf_counter()
        g = eri_tensor(mol, x, device=device)
        out[f"eri_forward_s_{call}"] = _sync_s(t0, device)
        t0 = time.perf_counter()
        torch.autograd.grad(torch.sum(w * g), x)
        out[f"eri_backward_s_{call}"] = _sync_s(t0, device)
    out["eri_dev"] = _gate_array("water cc-pVDZ eri_tensor", g.detach().cpu().numpy(),
                                 native.eri(mol), 1e-10)
    out["v_dev"] = _gate_array("water cc-pVDZ V", nuclear_attraction(mol, device=device)
                               .cpu().numpy(), native.one_electron(mol)[2], 1e-11)
    t0 = time.perf_counter()
    e, g, res = hf_gradient(mol, conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=200,
                            device=device)
    out.update(hf_gradient_s=_sync_s(t0, device), e_tot=e, scf_cycles=res.n_iter)
    out["graph_vs_eager"] = _hold_single("water cc-pVDZ hf_gradient SCF", res, hf_gradient(
        mol, conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=200, device=device,
        jit_kernel="off")[2])
    _gate("water cc-pVDZ hf_gradient", [("e_tot", e, E_UHF_WATER_DZ)], 1e-8)
    out["hf_dev"] = _gate_array("water cc-pVDZ hf_gradient", g.cpu().numpy(),
                                GRAD_FD_WATER_DZ, 1e-8)
    print("water_ccpvdz_gradient", json.dumps(out), flush=True)


def run_water_qse(sq, nelec, params, e_vqe, device="cuda"):
    """QSE on water's mu-embedded register (10 qubits) of the water_vqe
    phase: the singles pool on the reference determinant gives the CIS
    roots (1e-10); the singles-and-doubles pool on the VQE state gives a
    lowest root at or below e_vqe and at or above the register's FCI."""
    from nbed_tpu_torch.solvers import run_cis, run_fci, run_qse, uccsd_excitations

    const, h1, h2 = sq
    n = h1.shape[0]
    occ_int, _ = uccsd_excitations(n, nelec)
    occ = np.array([(occ_int >> p) & 1 for p in range(n)], dtype=bool)
    cis = run_cis(h1, h2, occ)
    t0 = time.perf_counter()
    singles = run_qse(const, h1, h2, nelec, pool="singles", device=device)
    sd = run_qse(const, h1, h2, nelec, pool="sd", params=params, device=device)
    qse_s = time.perf_counter() - t0
    if len(singles.excitations) != len(cis.excitations) + 1:
        raise RuntimeError("water_qse: singles-QSE and CIS root counts differ")
    _gate("water_qse singles vs CIS", [(f"root {i}", a, b) for i, (a, b) in enumerate(
        zip(singles.excitations[1:], cis.excitations))], 1e-10)
    e_fci = float(run_fci(const, h1, h2, n, nelec)[0][0])
    lowest = float(sd.energies[0])
    if not (lowest <= e_vqe + 1e-10 and lowest >= e_fci - 1e-8):
        raise RuntimeError(f"water_qse: sd lowest {lowest}, e_vqe {e_vqe}, FCI {e_fci}")
    print("water_qse", json.dumps({
        "qse_s": qse_s, "n_operators_singles": singles.n_operators,
        "n_operators_sd": sd.n_operators, "n_retained_sd": sd.n_retained,
        "sd_lowest": lowest, "e_vqe": e_vqe, "e_fci": e_fci,
        "singles_vs_cis_max": float(np.max(np.abs(singles.excitations[1:]
                                                  - cis.excitations)))}), flush=True)


def run_pfoa_post(driver):
    """On the pfoa driver: the mu embedded space's CCSD(T) through
    run_emb_ccsd (e_t within 1e-7 of nbed_tpu's) and the precision modes
    (mixed within 1e-8 of f64, f32 within 5e-5); TDA of the embedded HF
    solution on the DF route equal to run_emb_cis (1e-8); Davidson TDA (4
    roots) of the global B3LYP DF-UKS; the f_xc jvp against a central
    difference at its density (1e-5 relative); and a checkpoint round trip
    of the global UKS with a warm restart (<= 3 cycles, 1e-8 Ha)."""
    import tempfile

    from nbed_tpu_torch.checkpoint import load_solution, save_solution
    from nbed_tpu_torch.driver import run_emb_ccsd, run_emb_cis
    from nbed_tpu_torch.ham import HamiltonianBuilder
    from nbed_tpu_torch.solvers import run_ccsd, run_tddft_tda

    sol = driver.mu["scf"]
    out = {}
    e_emb, e_corr_t = run_emb_ccsd(sol, triples=True)
    _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
    occ = _interleaved(sol)
    energies = {}
    for precision in ("f64", "f32", "mixed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        energies[precision] = run_ccsd(h1, h2, occ, conv_tol=1e-10, precision=precision)[0]
        out[f"ccsd_{precision}_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_corr, e_t, _ = run_ccsd(h1, h2, occ, conv_tol=1e-8, triples=True)
    out["ccsd_t_f64_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_ccsd(h1, h2, occ, conv_tol=1e-8)
    out["triples_s"] = out["ccsd_t_f64_s"] - (time.perf_counter() - t0)
    out["n_triples"] = int(occ.sum()) ** 3
    _gate("pfoa_post", [("e_t", e_t, E_T_PFOA)], 1e-7)
    _gate("pfoa_post", [("run_emb_ccsd(triples=True) e_corr", e_corr_t, E_CORR_PFOA + E_T_PFOA),
                        ("e_corr", e_corr, E_CORR_PFOA)], 1e-6)
    _gate("pfoa_post precision", [("mixed", energies["mixed"], energies["f64"])], 1e-8)
    _gate("pfoa_post precision", [("f32", energies["f32"], energies["f64"])], 5e-5)
    out.update(e_t=e_t, e_corr=e_corr, ccsd_dev={k: v - energies["f64"]
                                                 for k, v in energies.items()})

    t0 = time.perf_counter()
    tda = run_tddft_tda(sol, method="dense").excitations
    out["tda_embedded_s"] = time.perf_counter() - t0
    cis = run_emb_cis(sol).excitations
    # the builder zeroes coefficients below OpenFermion's EQ_TOLERANCE
    # (1e-8), which moves run_emb_cis's roots by ~1e-8 at 78 spin orbitals;
    # TDA on the HF engine is CIS exactly on the untruncated integrals
    from nbed_tpu_torch.solvers import run_cis

    _, h1_full, h2_full = HamiltonianBuilder(sol, 0.0)._build(0.0)
    cis_full = run_cis(h1_full, h2_full, occ).excitations
    if not len(tda) == len(cis) == len(cis_full):
        raise RuntimeError("pfoa_post: embedded TDA and CIS root counts differ")
    dev = float(np.max(np.abs(tda - cis_full)))
    dev_emb = float(np.max(np.abs(tda - cis)))
    _gate("pfoa_post embedded TDA (DF) vs CIS on the untruncated integrals",
          [("max |d omega|", dev, 0.0)], 1e-8)
    _gate("pfoa_post embedded TDA (DF) vs run_emb_cis", [("max |d omega|", dev_emb, 0.0)],
          1e-7)
    out.update(n_pairs_embedded=len(tda), tda_vs_cis_untruncated=dev, tda_vs_run_emb_cis=dev_emb)

    ks = driver._global_ks
    eng = driver._ks_engine
    stats = {}
    t0 = time.perf_counter()
    dav = run_tddft_tda(ks, nroots=4, method="davidson", stats=stats).excitations
    out["davidson_s"] = time.perf_counter() - t0
    if not (max(stats["residuals"]) <= 1e-8 and np.all(np.diff(dav) >= 0) and dav[0] > 0):
        raise RuntimeError(f"pfoa_post Davidson: roots {dav}, residuals {stats['residuals']}")
    out.update(davidson_roots=dav.tolist(), davidson_iterations=stats["iterations"],
               davidson_blocks=stats["matvec_blocks"], davidson_matvec_s=stats["matvec_s"],
               davidson_s_per_block=stats["matvec_s"] / stats["matvec_blocks"],
               n_pairs_global=sum(int((o > 0).sum()) * int((o <= 0).sum())
                                  for o in ks.mo_occ))
    # tddft_graphed at pfoa: one TDA block of the program's width graphed
    # against eager (the Davidson above ran its blocks as graphs)
    out["tda_block"] = hold_blocks("pfoa_post", ks, rows=1, kinds=("tda",))
    dm0 = ks.make_rdm1()
    gen = torch.Generator(device="cuda").manual_seed(7)
    t = 1e-3 * torch.randn(dm0.shape, generator=gen, dtype=torch.float64, device="cuda")
    t = t + t.transpose(-1, -2)
    response = eng._build_xc(torch.float64, differentiable=True)
    t0 = time.perf_counter()
    _, dv = torch.func.jvp(lambda d: response(d)[1], (dm0,), (t,))
    out["jvp_s"] = time.perf_counter() - t0
    h = 1e-4
    fd = (eng.xc_fn(dm0 + h * t)[1] - eng.xc_fn(dm0 - h * t)[1]) / (2 * h)
    rel = float(torch.max(torch.abs(dv - fd)) / torch.max(torch.abs(fd)))
    _gate("pfoa_post f_xc jvp vs central difference", [("relative", rel, 0.0)], 1e-5)
    out["jvp_vs_fd"] = rel

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "pfoa_uks.npz"
        save_solution(path, ks)
        loaded = load_solution(path, eng)
    e_loaded = loaded.energy_elec()[0] + loaded.energy_nuc()
    _gate("pfoa_post checkpoint", [("e_tot", loaded.e_tot, ks.e_tot),
                                   ("energy of the loaded orbitals", e_loaded,
                                    ks.energy_elec()[0] + ks.energy_nuc())], 1e-12)
    t0 = time.perf_counter()
    warm = eng.kernel(dm0=loaded.make_rdm1(), max_cycle=3)
    out["warm_restart_s"] = time.perf_counter() - t0
    if not warm.converged:
        raise RuntimeError("pfoa_post: the warm restart did not converge in 3 cycles")
    _gate("pfoa_post warm restart", [("e_tot", warm.e_tot, ks.e_tot)], 1e-8)
    out["warm_restart_dev"] = warm.e_tot - ks.e_tot
    print("pfoa_post", json.dumps(out), flush=True)


# --------------------------------------------------------------------------
# the batching and parallel slice
# --------------------------------------------------------------------------

def water_fleet_coords(mol, b: int = 8):
    """bench.py:427-440's fleet: water/STO-3G jittered by 0.02 bohr
    (np.random.default_rng(11)), lane 0 the unperturbed geometry."""
    base = np.asarray(mol.coords)
    x = base[None] + 0.02 * np.random.default_rng(11).standard_normal((b, *base.shape))
    x[0] = base
    return x


def stretch_coords(mol, b: int, top: float):
    """b lanes stretching the second O-H bond (atom 2, z) from 0 to ``top``
    bohr (tests/test_parallel.py:40-57, scripts/embed_fleet_tpu.py)."""
    x = np.repeat(np.asarray(mol.coords)[None], b, axis=0)
    x[:, 2, 2] += np.linspace(0.0, top, b)
    return x


def _hold_lanes(label: str, graphed, eager) -> float:
    """A lane SCF run as a program (CUDA graphs) against the eager lane
    loop: every lane converged, within 1e-10 Ha, in as many cycles.
    Returns the largest energy difference."""
    if not (bool(graphed.converged.all()) and bool(eager.converged.all())):
        raise RuntimeError(f"{label}: a lane did not converge")
    if not torch.equal(graphed.n_iter, eager.n_iter):
        raise RuntimeError(f"{label}: graphed lanes ran {graphed.n_iter.tolist()} cycles, "
                           f"eager {eager.n_iter.tolist()}")
    return _gate_array(f"{label} graphed vs eager lanes", graphed.e_elec.cpu().numpy(),
                       eager.e_elec.cpu().numpy(), 1e-10)


def lane_cases():
    """(label, g_j, g_k, dm, dtypes) of the lane/slab entry in float64 on the
    card: the ERI supermatrices of the water fleet (B = 8, M = 49) and of
    the acetonitrile Hessian's 36 displaced geometries (B = 36, M = 324),
    made by the batched torch integrals on the card; R = M/2 slabs of
    acetonitrile's (M = 324, vector path), water cc-pVDZ's (M = 576) and of
    random supermatrices at nao = 64 (M = 4096, ring path)."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.integrals import eri_tensor
    from nbed_tpu_torch.parallel.sharding import _supermatrices
    from nbed_tpu_torch.solvers.hessian import _displacements

    both = (torch.float64, torch.float32)
    rng = np.random.default_rng(12)

    def dms(b, n):
        d = rng.standard_normal((b, 2, n, n))
        return torch.tensor(0.5 * (d + d.swapaxes(-1, -2)), device="cuda")

    water = build_molecule(WATER.read_text(), "sto-3g")
    pra = build_molecule(ACETONITRILE, "sto-3g")
    dz = build_molecule(WATER.read_text(), "cc-pvdz")
    cases = []
    with torch.no_grad():
        for label, mol, x in (
                ("water fleet B=8", water, water_fleet_coords(water)),
                ("acetonitrile Hessian B=36", pra,
                 _displacements(np.asarray(pra.coords), 5e-3))):
            g_j, g_k = _supermatrices(eri_tensor(mol, x, device="cuda"))
            cases.append((label, g_j, g_k, dms(len(x), mol.nao), both))
        for label, mol in (("acetonitrile slab R=M/2", pra), ("water cc-pVDZ slab R=M/2", dz)):
            g_j, g_k = _supermatrices(eri_tensor(mol, device="cuda"))
            r = g_j.shape[0] // 2
            cases.append((label, g_j[None, :r].contiguous(), g_k[None, :r].contiguous(),
                          dms(1, mol.nao), both))
    _, g_j, g_k, dm, _ = random_case("random nao=64 slab R=M/2", 64, 64, both)
    cases.append(("random nao=64 slab R=M/2", g_j[None, :2048].contiguous(),
                  g_k[None, :2048].contiguous(), dm[None], both))
    return cases


def lane_bound(b: int, r: int, m: int, dtype):
    """(ms, "bytes" or "operations"): the least time of one lane/slab build,
    the larger of its bytes (2 B R M words of G, B 2 M of densities, B 3 R
    of output) at 3.35 TB/s and its 6 B R M operations at 67 TFLOP/s."""
    word = 8 if dtype == torch.float64 else 4
    by_bytes = (2 * b * r * m + 2 * b * m + 3 * b * r) * word / HBM_BYTES_PER_S
    by_ops = 6 * b * r * m / PEAK_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def hold_lanes(label, gj, gk, dm) -> float:
    """The lane/slab kernel (its own path and every path forced) against the
    plain version; two launches bitwise equal; a CUDA-graph replay equal to
    the eager call. Raises on a miss; returns the largest absolute error."""
    from nbed_tpu_torch.ops.jk import FusedJK, fused_jk_reference

    rtol, atol = TOLERANCES[dm.dtype]
    ref = fused_jk_reference(gj, gk, dm)
    m = gj.shape[-1]
    prepared = FusedJK(gj, gk)
    err = 0.0
    for path in (None, "vector", "ring", "chunked"):
        jk = prepared if path is None else FusedJK(gj, gk, path=path,
                                                   chunk_cols=max(1, m // 3 + 1))
        out = jk(dm)
        torch.cuda.synchronize()
        what = f"fused_jk lanes {label} {dm.dtype} path {jk.plan.path}"
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{what}: non-finite output")
        e = float(torch.max(torch.abs(out - ref)))
        if not torch.allclose(out, ref, rtol=rtol, atol=atol):
            raise RuntimeError(f"{what}: max abs err {e} exceeds rtol={rtol}, atol={atol}")
        err = max(err, e)
        if not torch.equal(out, jk(dm)):
            raise RuntimeError(f"{what}: two launches differ")
    eager = prepared(dm)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        replayed = prepared(dm)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(replayed, eager):
        raise RuntimeError(f"fused_jk lanes {label} {dm.dtype}: CUDA-graph replay differs")
    return err


def lane_library_call(gj, gk, dm):
    """The yardstick for lanes: one batched GEMM of [G_J; G_K] (2B, R, M)
    against [[D_a + D_b, 0], [D_a, D_b]] per lane."""
    b, m = gj.shape[0], gj.shape[-1]
    g2 = torch.cat([gj, gk])
    rhs = torch.zeros((2 * b, m, 2), dtype=dm.dtype, device="cuda")
    rhs[:b, :, 0] = (dm[:, 0] + dm[:, 1]).reshape(b, m)
    rhs[b:] = dm.reshape(b, 2, m).transpose(1, 2)
    return lambda: torch.bmm(g2, rhs)


def check_lane_kernels() -> list:
    """:func:`hold_lanes` at every lane/slab case and dtype, then the times
    of the prepared kernel, the plain version and the library call, the
    self device time and the bound; returns rows."""
    from nbed_tpu_torch.ops.jk import FusedJK, fused_jk_reference

    rows = []
    for label, gj64, gk64, dm64, dtypes in lane_cases():
        for dtype in dtypes:
            gj, gk, dm = (t.to(dtype).contiguous() for t in (gj64, gk64, dm64))
            err = hold_lanes(label, gj, gk, dm)
            b, r, m = gj.shape
            prepared = FusedJK(gj, gk)
            kernel = lambda: prepared(dm)  # noqa: E731
            lib = lane_library_call(gj, gk, dm)
            row = {"case": label, "m": m, "rows": r, "batch": b,
                   "dtype": str(dtype).removeprefix("torch."), "path": prepared.plan.path,
                   "max_abs_err": err, **timings(kernel, m),
                   **{f"plain_{k}": v for k, v in timings(
                       lambda: fused_jk_reference(gj, gk, dm), m).items()},
                   **{f"library_{k}": v for k, v in timings(lib, m).items()},
                   "kernel_device_us": device_us(kernel, "fused_jk"),
                   **dict(zip(("bound_ms", "bound_by"), lane_bound(b, r, m, dtype)))}
            row["share_of_bound"] = row["bound_ms"] * 1e3 / row["kernel_device_us"]
            del lib
            print("fused_jk_lanes", json.dumps(row), flush=True)
            rows.append(row)
        del gj64, gk64
    return rows


def lane_launches(by_shape=None) -> int:
    """Launches of the lane/slab entry (B > 1 or R < M) in ``by_shape``
    (default: the counts since they were last cleared)."""
    from nbed_tpu_torch.ops import jk

    by_shape = jk.LAUNCHES_BY_SHAPE if by_shape is None else by_shape
    return sum(n for (_, m, r, b), n in by_shape.items() if b > 1 or r < m)


def _cuda_mesh(batch: int):
    """The one card named twice: a mesh of two slots for the slab and
    lane-group logic (a real multi-card run needs a machine with more than
    one card)."""
    from nbed_tpu_torch.parallel import make_mesh

    return make_mesh(devices=["cuda", "cuda"], batch=batch)


def run_water_fleet(device="cuda"):
    """batched_hf_energies at B = 8 (bench.py:427-470): lane 0 within 1e-6
    of the water UHF oracle, every lane within 1e-10 of the port's
    single-geometry UHF on the card, one lane launch per SCF cycle (and
    one for the final build); conformers/s and the lane efficiency
    t_single * B / t_batch, warm; the same on a mesh of two lane groups,
    equal to 1e-12."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.ops import jk
    from nbed_tpu_torch.parallel import batched_hf_energies
    from nbed_tpu_torch.parallel.sharding import _lane_scf
    from nbed_tpu_torch.solvers.gradients import _hf_scf

    mol = build_molecule(WATER.read_text(), "sto-3g")
    x = water_fleet_coords(mol)
    kw = dict(conv_tol=1e-8, max_cycle=100, device=device)
    e, conv = batched_hf_energies(mol, x, **kw)
    if not bool(conv.all()):
        raise RuntimeError(f"water_fleet: lanes converged {conv.tolist()}")
    _gate("water_fleet lane 0", [("e_tot", float(e[0]), E_UHF_WATER)], 1e-6)
    singles = []
    for xb in x:
        res, _ = _hf_scf(mol, torch.tensor(xb, device=device), conv_tol=1e-8,
                         dm_conv_tol=1e-6, max_cycle=100)
        singles.append(res.e_elec + mol.energy_nuc(xb))
    dev = _gate_array("water_fleet lanes vs single-geometry UHF", e.cpu().numpy(), singles,
                      1e-10)
    before = dict(jk.LAUNCHES_BY_SHAPE)
    res, _ = _lane_scf(mol, torch.tensor(x, device=device), conv_tol=1e-8, max_cycle=100)
    key = ("fused_jk_f64", 49, 49, 8)
    launched = jk.LAUNCHES_BY_SHAPE[key] - before.get(key, 0)
    eager, _ = _lane_scf(mol, torch.tensor(x, device=device), conv_tol=1e-8, max_cycle=100,
                         jit_kernel="off")
    graph_dev = _hold_lanes("water_fleet", res, eager)
    if torch.device(device).type == "cuda" and launched != int(res.n_iter.max()) + 1:
        raise RuntimeError(f"water_fleet: {launched} lane launches for "
                           f"{int(res.n_iter.max())} cycles")

    def timed(coords):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched_hf_energies(mol, coords, **kw)[0].cpu()
        return time.perf_counter() - t0

    timed(x[:1])
    t_batch, t_single = timed(x), timed(x[:1])
    e_mesh, _ = batched_hf_energies(mol, x, mesh=_cuda_mesh(2), **kw)
    mesh_dev = _gate_array("water_fleet mesh vs one group", e_mesh.cpu().numpy(),
                           e.cpu().numpy(), 1e-12)
    print("water_fleet", json.dumps({
        "batch": len(x), "cycles": res.n_iter.tolist(), "lane_launches": launched,
        "graph_vs_eager_max": graph_dev,
        "lanes_vs_single_max": dev, "mesh_vs_one_group_max": mesh_dev,
        "batch_s": t_batch, "single_s": t_single, "conformers_per_s": len(x) / t_batch,
        "lane_efficiency": t_single * len(x) / t_batch, "e": e.tolist()}), flush=True)


def run_water_fleet_gradients(device="cuda"):
    """batched_hf_gradients at B = 4, the second O-H bond stretched 0-0.03
    bohr (tests/test_parallel.py:40-57): lanes 0 and 3 within 1e-10 Ha and
    1e-9 Ha/bohr of hf_gradient, translational sums below 1e-9."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.parallel import batched_hf_gradients
    from nbed_tpu_torch.solvers import hf_gradient

    mol = build_molecule(WATER.read_text(), "sto-3g")
    x = stretch_coords(mol, 4, 0.03)
    t0 = time.perf_counter()
    e, grad, conv = batched_hf_gradients(mol, x, device=device)
    wall = _sync_s(t0, device)
    if not bool(conv.all()):
        raise RuntimeError(f"water_fleet_gradients: lanes converged {conv.tolist()}")
    out = {"batch_s": wall}
    e_off, grad_off, _ = batched_hf_gradients(mol, x, device=device, jit_kernel="off")
    out["graph_vs_eager_e"] = _gate_array("water_fleet_gradients graphed vs eager",
                                          e.cpu().numpy(), e_off.cpu().numpy(), 1e-10)
    out["graph_vs_eager_grad"] = _gate_array(
        "water_fleet_gradients graphed vs eager", grad.cpu().numpy(),
        grad_off.cpu().numpy(), 1e-10)
    for b in (0, 3):
        e1, g1, _ = hf_gradient(mol, coords=x[b], device=device)
        _gate(f"water_fleet_gradients lane {b}", [("e_tot", float(e[b]), e1)], 1e-10)
        out[f"lane{b}_grad_dev"] = _gate_array(f"water_fleet_gradients lane {b}",
                                               grad[b].cpu().numpy(), g1.cpu().numpy(), 1e-9)
    out["sum_max"] = _gate_array("water_fleet_gradients translational sums",
                                 grad.sum(dim=1).cpu().numpy(), 0.0, 1e-9)
    print("water_fleet_gradients", json.dumps(out), flush=True)


@contextmanager
def _same_eris():
    """The embedding program's torch ERIs computed once per geometry batch
    and range-separation parameter, and reused by every call inside."""
    from nbed_tpu_torch.parallel import embed_path

    built = {}
    eri_tensor = embed_path.eri_tensor

    def memo(mol, x, omega=None, **kw):
        key = (x.detach().cpu().numpy().tobytes(), omega)
        if key not in built:
            built[key] = eri_tensor(mol, x, omega=omega, **kw)
        return built[key]

    embed_path.eri_tensor = memo
    try:
        yield
    finally:
        embed_path.eri_tensor = eri_tensor


def run_water_embed_fleet(device="cuda"):
    """batched_embedding_energies at B = 8 with B3LYP at grid level 1 and
    n_act_mos from the host driver, the second O-H bond stretched 0-0.04
    (scripts/embed_fleet_tpu.py): the graphed lanes within 1e-10 of eager
    ones on the same ERIs, lane 0 within 1e-8 of the program run alone,
    e_global increasing along the stretch; at the driver's grid
    (level 3) the program within 5e-6 of the host driver's mu and
    Huzinaga e_rhf (tests/test_parallel.py:202-203); with CAM-B3LYP the
    partition identity to 1e-9; the forward-mode derivative of e_emb_rhf
    along the stretch (the fleet's program with grad_cycles 40, conv_tol
    1e-10 and dm_conv_tol 1e-8) within 1e-6 of a five-point difference (h
    = 1e-3) of the same program, printed also against a central difference
    at h = 1e-4, and both at grad_cycles 0. At the driver's three active
    MOs, 20 polish cycles leave the tangent 1.8e-6 off on the CPU, 40
    leave 5e-7."""
    from torch.autograd import forward_ad

    from nbed_tpu_torch import nbed
    from nbed_tpu_torch.parallel import batched_embedding_energies, make_mu_embed_energy

    driver = nbed(**CONFIGS["water"], device=device)
    mol = driver._ks_engine.mol
    inds = driver.localized_system.active_mo_inds
    n_act = len(inds) if np.ndim(inds) == 1 else (len(inds[0]), len(inds[1]))
    x = stretch_coords(mol, 8, 0.04)
    kw = dict(xc="b3lyp", grid_level=1, conv_tol=1e-9, dm_conv_tol=1e-7, device=device)
    out = {"n_act_mos": n_act}
    t0 = time.perf_counter()
    fleet = batched_embedding_energies(mol, x, 1, n_act, **kw)
    out["fleet_cold_s"] = _sync_s(t0, device)
    t0 = time.perf_counter()
    fleet = batched_embedding_energies(mol, x, 1, n_act, **kw)
    out["fleet_warm_s"] = _sync_s(t0, device)
    out["embedded_conformers_per_s"] = len(x) / out["fleet_warm_s"]
    if not bool(fleet["converged"].all()):
        raise RuntimeError("water_embed_fleet: a lane did not converge")
    # the lanes graphed against eager at 1e-10 Ha on the same ERIs: each
    # call rebuilds the torch ERIs, whose atomic adds round differently from
    # call to call, and the 1e6 mu shift carries that into e_emb_rhf; the
    # spread of two eager calls on their own ERIs is printed beside it
    keys = ("e_emb_rhf", "e_global", "e_act", "e_env", "two_e_cross")
    eager = batched_embedding_energies(mol, x, 1, n_act, jit_kernel="off", **kw)
    with _same_eris():
        graphed_same = batched_embedding_energies(mol, x, 1, n_act, **kw)
        eager_same = batched_embedding_energies(mol, x, 1, n_act, jit_kernel="off", **kw)
    out["graph_vs_eager"] = {k: _gate_array(
        f"water_embed_fleet {k} graphed vs eager, same ERIs", graphed_same[k].cpu().numpy(),
        eager_same[k].cpu().numpy(), 1e-10) for k in keys}
    out["graph_vs_eager_own_eris"] = {
        k: float(torch.max(torch.abs(fleet[k] - eager[k]))) for k in keys}
    out["eager_vs_eager_own_eris"] = {
        k: float(torch.max(torch.abs(eager_same[k] - eager[k]))) for k in keys}
    single = make_mu_embed_energy(mol, 1, n_act, **kw)(torch.tensor(x[0]))
    _gate("water_embed_fleet lane 0 vs the single program",
          [(k, float(fleet[k][0]), float(single[k])) for k in
           ("e_emb_rhf", "e_global", "e_act", "e_env", "two_e_cross")], 1e-8)
    if not np.all(np.diff(fleet["e_global"].cpu().numpy()) > 0):
        raise RuntimeError(f"water_embed_fleet: e_global not increasing {fleet['e_global']}")
    tight = dict(conv_tol=1e-10, dm_conv_tol=1e-8, device=device)
    x0 = torch.tensor(np.asarray(mol.coords), device=device)
    for proj, res in (("mu", driver.mu), ("huzinaga", driver.huzinaga)):
        e = float(make_mu_embed_energy(mol, 1, n_act, projector=proj, **tight)(x0)["e_emb_rhf"])
        _gate(f"water_embed_fleet {proj} program vs the host driver",
              [("e_rhf", e, res["e_rhf"])], 5e-6)
        out[f"{proj}_vs_driver"] = e - res["e_rhf"]
    cam = make_mu_embed_energy(mol, 1, n_act, xc="camb3lyp", **tight)(x0)
    _gate("water_embed_fleet camb3lyp partition", [(
        "e_act + e_env + two_e_cross + e_nuc",
        float(cam["e_act"] + cam["e_env"] + cam["two_e_cross"]) + mol.energy_nuc(),
        float(cam["e_global"]))], 1e-9)
    t = torch.zeros_like(x0)
    t[2, 2] = 1.0
    for cycles in (40, 0):
        fn = make_mu_embed_energy(mol, 1, n_act, grad_cycles=cycles,
                                  **{**kw, "conv_tol": 1e-10, "dm_conv_tol": 1e-8})
        t0 = time.perf_counter()
        with forward_ad.dual_level():
            d = float(forward_ad.unpack_dual(
                fn(forward_ad.make_dual(x0, t))["e_emb_rhf"]).tangent)
        out[f"jvp_s_grad_cycles_{cycles}"] = _sync_s(t0, device)

        def e(step):
            return float(fn(x0 + step * t)["e_emb_rhf"])

        # the energies carry ~1e-10 Ha of SCF noise (the 1e6 mu shift), which
        # an h = 1e-4 central difference turns into ~1e-6 Ha/bohr; the
        # five-point difference at h = 1e-3 keeps it near 1e-7, its O(h^4)
        # truncation far below that
        fd = (e(1e-4) - e(-1e-4)) / 2e-4
        fd5 = (8 * (e(1e-3) - e(-1e-3)) - (e(2e-3) - e(-2e-3))) / 12e-3
        out[f"jvp_vs_fd_h1e-4_grad_cycles_{cycles}"] = d - fd
        out[f"jvp_vs_fd5_h1e-3_grad_cycles_{cycles}"] = d - fd5
        if cycles:
            _gate("water_embed_fleet forward-mode derivative", [("de/dz", d, fd5)], 1e-6)
    out["e_emb_rhf"] = fleet["e_emb_rhf"].tolist()
    print("water_embed_fleet", json.dumps(out), flush=True)


@contextmanager
def _same_operators():
    """The embedding program's ERIs (both routes' entry points) and S, T +
    V computed once per geometry batch, tangent and range-separation
    parameter, and reused by every call inside, with their forward-mode
    tangents: both are sums of atomic adds on the card, which round
    differently from call to call, and the 1e6 mu shift carries that into
    e_emb_rhf and its derivative. Also records each lane SCF's cycles."""
    from torch.autograd import forward_ad

    from nbed_tpu_torch.parallel import embed_path

    built, cycles = {}, []
    saved = {name: getattr(embed_path, name) for name in ("eri_tensor", "eri_program",
                                                          "core_program", "lane_scf")}

    def key(x, *extra):
        p, t = forward_ad.unpack_dual(x)
        return (p.detach().cpu().numpy().tobytes(),
                None if t is None else t.cpu().numpy().tobytes(), *extra)

    def memo(k, compute):
        if k not in built:
            out = compute()
            parts = out if isinstance(out, tuple) else (out,)
            built[k] = tuple(tuple(v.detach().clone() if v is not None else None
                                   for v in forward_ad.unpack_dual(o)) for o in parts)
        parts = tuple(o if t is None else forward_ad.make_dual(o, t) for o, t in built[k])
        return parts if len(parts) > 1 else parts[0]

    def eri(mol, x, omega=None, **kw):
        name = "eri_tensor" if "device" in kw else "eri_program"
        return memo(key(x, "eri", omega), lambda: saved[name](mol, x, omega=omega, **kw))

    def core(mol, x, jit_kernel="auto"):
        return memo(key(x, "core"), lambda: saved["core_program"](mol, x, jit_kernel))

    def lanes(*args, **kw):
        res = saved["lane_scf"](*args, **kw)
        cycles.append(res.n_iter.tolist())
        return res

    embed_path.eri_tensor = embed_path.eri_program = eri
    embed_path.core_program, embed_path.lane_scf = core, lanes
    try:
        yield cycles
    finally:
        for name, fn in saved.items():
            setattr(embed_path, name, fn)


@contextmanager
def _eager_eigh_jvp():
    """Inside the block the embedding program's eager dual route
    diagonalises dual matrices as its tangent programs do (``eigh_jvp`` on
    the capturable cuSOLVER call, its private switch), not with
    ``torch.linalg.eigh``: a graph held against eager on the same
    arithmetic."""
    from nbed_tpu_torch.scf import hf

    hf._EAGER_EIGH_JVP = True
    try:
        yield
    finally:
        hf._EAGER_EIGH_JVP = False


def run_embed_tangents_graphed(device="cuda"):
    """The embedding program's forward-mode tangents as CUDA-graph programs
    (water/STO-3G, B3LYP, grid level 1, the host driver's active count,
    tolerances 1e-10/1e-8; d e_emb_rhf/dz of the second H): the tangent
    programs of the integrals and tables within 1e-12 of the eager forward
    mode; graphed against the eager dual route on the same ERIs and S, T
    + V (``_same_operators``) and the same eigensolver
    (``_eager_eigh_jvp``) within 1e-10 Ha/bohr in as many SCF cycles, at
    ``grad_cycles`` 40 and 0 and over 8 lanes along the stretch (the
    eager route on ``torch.linalg.eigh`` printed beside it: the 1e6 mu
    shift turns the two solvers' rounding into differences above that
    gate and other embedded HF cycle counts); within 1e-6 of a five-point difference (h = 1e-3) of
    the graphed primal program at 40; no capture at a second geometry or
    direction. Prints first (with capture), warm graphed and eager
    seconds, captures, the graph pools and the warm graphed calls' idle
    shares. On the CPU (a rehearsal) the programs run uncaptured
    ("on")."""
    from torch.autograd import forward_ad

    from nbed_tpu_torch import nbed
    from nbed_tpu_torch.grids.grid import tables_program
    from nbed_tpu_torch.integrals.core import core_program
    from nbed_tpu_torch.integrals.eri import eri_program
    from nbed_tpu_torch.ops import jk
    from nbed_tpu_torch.ops.programs import DERIVATIVE_PROGRAMS, RUNS
    from nbed_tpu_torch.parallel import make_mu_embed_energy
    from nbed_tpu_torch.profiling import device_profile
    from nbed_tpu_torch.scf import engine

    driver = nbed(**CONFIGS["water"], device=device)
    mol = driver._ks_engine.mol
    inds = driver.localized_system.active_mo_inds
    n_act = len(inds) if np.ndim(inds) == 1 else (len(inds[0]), len(inds[1]))
    cuda = torch.device(device).type == "cuda"
    graphed = "auto" if cuda else "on"
    kw = dict(xc="b3lyp", grid_level=1, conv_tol=1e-10, dm_conv_tol=1e-8, device=device)
    x0 = torch.tensor(np.asarray(mol.coords), device=device)
    t = torch.zeros_like(x0)
    t[2, 2] = 1.0
    out = {"n_act_mos": n_act}

    def jvp(fn, x, tx):
        with forward_ad.dual_level():
            res = fn(forward_ad.make_dual(x, tx))
            p, d = forward_ad.unpack_dual(res["e_emb_rhf"])
            return p.detach().clone(), d.clone()

    # the integral and table programs against the eager forward mode
    devs = {}
    with forward_ad.dual_level():
        xd = forward_ad.make_dual(x0[None], t[None])
        pairs = [("eri", eri_program(mol, xd, jit_kernel=graphed),
                  eri_program(mol, xd, jit_kernel="off")),
                 ("eri_omega", eri_program(mol, xd, omega=0.33, jit_kernel=graphed),
                  eri_program(mol, xd, omega=0.33, jit_kernel="off"))]
        pairs += list(zip(("s", "hcore"), core_program(mol, xd, graphed),
                          core_program(mol, xd, "off")))
        tables = (tables_program(mol, xd, level=1, jit_kernel=graphed),
                  tables_program(mol, xd, level=1, jit_kernel="off"))
        pairs += [(name, tables[0][name], tables[1][name]) for name in tables[0]]
        for name, a, b in pairs:
            (pa, ta), (pb, tb) = forward_ad.unpack_dual(a), forward_ad.unpack_dual(b)
            devs[name] = [_gate_array(f"embed_tangents_graphed {name} program vs eager",
                                      u.cpu().numpy(), v.cpu().numpy(), 1e-12)
                          for u, v in ((pa, pb), (ta, tb))]
    out["operators_vs_eager"] = devs

    checks = []
    for cycles in (40, 0):
        fn = make_mu_embed_energy(mol, 1, n_act, grad_cycles=cycles, jit_kernel=graphed, **kw)
        eager_fn = make_mu_embed_energy(mol, 1, n_act, grad_cycles=cycles, jit_kernel="off",
                                        **kw)
        engine._JIT_PROGRAM_CACHE.clear()
        DERIVATIVE_PROGRAMS.clear()
        before = dict(RUNS)
        t0 = time.perf_counter()
        jvp(fn, x0, t)
        row = {"first_s": _sync_s(t0, device),
               "captures": RUNS["captures"] - before.get("captures", 0),
               "capture_s": RUNS["capture_s"] - before.get("capture_s", 0.0),
               "pool_gb_by_kind": {k: RUNS[k] - before.get(k, 0.0) for k in RUNS
                                   if k.endswith("_pool_gb") and RUNS[k] != before.get(k, 0.0)}}
        row["pool_gb"] = sum(row["pool_gb_by_kind"].values())
        x1 = x0 + 0.01 * t
        t2 = torch.zeros_like(x0)
        t2[1, 0] = 1.0
        mid = RUNS["captures"]
        t0 = time.perf_counter()
        jvp(fn, x1, t)
        row["warm_s"] = _sync_s(t0, device)
        jvp(fn, x1, t2)
        row["later_captures"] = RUNS["captures"] - mid
        if row["later_captures"]:
            raise RuntimeError(f"embed_tangents_graphed: {row['later_captures']} captures at a "
                               "second geometry or direction")
        # on the same operators, against the eager route on the programs'
        # eigensolver (the gate) and on torch.linalg.eigh (its default,
        # timed and printed)
        with _same_operators() as scf_cycles:
            _, d_same = jvp(fn, x1, t)
            with _eager_eigh_jvp():
                _, d_same_eager = jvp(eager_fn, x1, t)
            t0 = time.perf_counter()
            _, d_torch_eigh = jvp(eager_fn, x1, t)
            row["eager_s"] = _sync_s(t0, device)
        row["scf_cycles"] = {"graphed": scf_cycles[:2], "eager": scf_cycles[2:4],
                             "eager_torch_eigh": scf_cycles[4:]}
        row["graph_minus_eager"] = float(d_same - d_same_eager)
        row["graph_minus_eager_torch_eigh"] = float(d_same - d_torch_eigh)
        checks.append((cycles, scf_cycles, float(d_same), float(d_same_eager)))
        if cycles:
            def e(step):
                return float(fn(x0 + step * t)["e_emb_rhf"])

            _, d0 = jvp(fn, x0, t)
            fd5 = (8 * (e(1e-3) - e(-1e-3)) - (e(2e-3) - e(-2e-3))) / 12e-3
            _gate("embed_tangents_graphed forward-mode derivative", [("de/dz", float(d0), fd5)],
                  1e-6)
            row["jvp_minus_fd5"] = float(d0) - fd5
        _, prof = device_profile(lambda: jvp(fn, x1, t))
        row["profile"] = {k: prof[k] for k in ("wall_s", "device_busy_s", "device_idle_share",
                                               "device_events")}
        out[f"grad_cycles_{cycles}"] = row

    # eight tangents along the stretch in one pass
    xb = torch.tensor(stretch_coords(mol, 8, 0.04), device=device)
    tb = torch.zeros_like(xb)
    tb[:, 2, 2] = 1.0
    fn = make_mu_embed_energy(mol, 1, n_act, grad_cycles=40, jit_kernel=graphed, **kw)
    eager_fn = make_mu_embed_energy(mol, 1, n_act, grad_cycles=40, jit_kernel="off", **kw)
    t0 = time.perf_counter()
    jvp(fn, xb, tb)
    out["lanes_first_s"] = _sync_s(t0, device)
    t0 = time.perf_counter()
    _, d_lanes = jvp(fn, xb, tb)
    out["lanes_warm_s"] = _sync_s(t0, device)
    with _same_operators() as scf_cycles:
        _, d_same = jvp(fn, xb, tb)
        with _eager_eigh_jvp():
            t0 = time.perf_counter()
            _, d_same_eager = jvp(eager_fn, xb, tb)
            out["lanes_eager_s"] = _sync_s(t0, device)
    out["lanes_graph_minus_eager"] = float(torch.max(torch.abs(d_same - d_same_eager)))
    out["lanes_de_dz"] = d_lanes.tolist()
    # the phase's fused J/K launches by shape (the counts were cleared
    # just before it)
    out["fused_jk_by_shape"] = {f"{k} M={m} R={r} B={b}": n for (k, m, r, b), n
                                in jk.LAUNCHES_BY_SHAPE.items()}
    print("embed_tangents_graphed", json.dumps(out), flush=True)
    # the gates, after the line: graphed against eager on the same
    # operators and eigensolver in as many SCF cycles, single and lanes
    checks.append(("8 lanes, 40", scf_cycles, d_same.cpu().numpy(),
                   d_same_eager.cpu().numpy()))
    for cycles, scf_cycles, d, d_eager in checks:
        if scf_cycles[:2] != scf_cycles[2:4]:
            raise RuntimeError(f"embed_tangents_graphed: SCF cycles {scf_cycles[:2]} graphed, "
                               f"{scf_cycles[2:4]} eager at grad_cycles {cycles}")
        _gate_array(f"embed_tangents_graphed de/dz graphed vs eager, grad_cycles {cycles}",
                    d, d_eager, 1e-10)
    if not np.all(np.diff(d_lanes.cpu().numpy()) > 0):
        raise RuntimeError(f"embed_tangents_graphed: de/dz not increasing along the stretch "
                           f"{d_lanes.tolist()}")


def _hold_single(label: str, graphed, eager) -> float:
    """A one-geometry SCF run as a program against its eager loop: both
    converged, within 1e-10 Ha, in as many cycles; returns the energy
    difference."""
    if not (graphed.converged and eager.converged):
        raise RuntimeError(f"{label}: an SCF did not converge")
    if graphed.n_iter != eager.n_iter:
        raise RuntimeError(f"{label}: graphed {graphed.n_iter} cycles, eager {eager.n_iter}")
    _gate(f"{label} graphed vs eager", [("e_elec", graphed.e_elec, eager.e_elec)], 1e-10)
    return graphed.e_elec - eager.e_elec


def run_sharded(device="cuda"):
    """Split SCFs on a model axis of 2 (the one card named twice): the
    acetonitrile molecule's sharded_scf within 1e-9 Ha of the engine's UHF
    with (162, 324) slabs, one slab launch each per cycle; water's
    sharded_df_scf and sharded_df_ks (B3LYP, CAM-B3LYP) within 1e-8 of the
    DF engine, at the engine's default grid (reference scheme, level 3)."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.ops import jk
    from nbed_tpu_torch.parallel import make_sharded_scf, sharded_df_ks, sharded_df_scf
    from nbed_tpu_torch.scf import SCFEngine

    mesh = _cuda_mesh(1)
    tight = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)
    pra = build_molecule(ACETONITRILE, "sto-3g")
    fn, args = make_sharded_scf(pra, mesh, **tight)
    shapes = [tuple(a.shape) for a in args[2] + args[3]]
    if shapes != [(162, 324)] * 4:
        raise RuntimeError(f"sharded_scf slabs {shapes}")
    # a first call captures the program (its capture's warm-up launches
    # too); the second is counted and timed
    fn(*args)
    before = jk.LAUNCHES_BY_SHAPE[("fused_jk_f64", 324, 162, 1)]
    t0 = time.perf_counter()
    res = fn(*args)
    out = {"sharded_scf_s": _sync_s(t0, device), "slabs": shapes[:2]}
    slab_launches = jk.LAUNCHES_BY_SHAPE[("fused_jk_f64", 324, 162, 1)] - before
    if torch.device(device).type == "cuda" and slab_launches != 2 * (res.n_iter + 1):
        raise RuntimeError(f"sharded_scf: {slab_launches} slab launches, {res.n_iter} cycles")
    out["graph_vs_eager"] = {"scf": _hold_single("sharded_scf", res, make_sharded_scf(
        pra, mesh, jit_kernel="off", **tight)[0](*args))}
    e_eng = SCFEngine(pra, device=device, **tight).kernel().e_tot
    _gate("sharded_scf vs the engine's UHF",
          [("e_tot", res.e_elec + pra.energy_nuc(), e_eng)], 1e-9)
    water = build_molecule(WATER.read_text(), "sto-3g")
    res = sharded_df_scf(water, mesh, **tight)
    out["graph_vs_eager"]["df_scf"] = _hold_single(
        "sharded_df_scf", res, sharded_df_scf(water, mesh, jit_kernel="off", **tight))
    e_eng = SCFEngine(water, density_fitting=True, device=device, **tight).kernel().e_tot
    _gate("sharded_df_scf vs the DF engine", [("e_tot", res.e_elec + water.energy_nuc(),
                                               e_eng)], 1e-8)
    out["df_scf_dev"] = res.e_elec + water.energy_nuc() - e_eng
    for xc in ("b3lyp", "camb3lyp"):
        res = sharded_df_ks(water, mesh, xc=xc, **tight)
        out["graph_vs_eager"][f"df_ks_{xc}"] = _hold_single(
            f"sharded_df_ks {xc}", res, sharded_df_ks(water, mesh, xc=xc, jit_kernel="off",
                                                      **tight))
        e_eng = SCFEngine(water, xc=xc, density_fitting=True, device=device,
                          **tight).kernel().e_tot
        _gate(f"sharded_df_ks {xc} vs the DF engine",
              [("e_tot", res.e_elec + water.energy_nuc(), e_eng)], 1e-8)
        out[f"df_ks_{xc}_dev"] = res.e_elec + water.energy_nuc() - e_eng
    print("sharded", json.dumps(out), flush=True)


def run_pfoa_sharded(driver, device="cuda"):
    """pfoa (126 AOs) sharded_df_ks with B3LYP on a model axis of 2, from
    the driver's converged density to conv_tol 1e-10: within 1e-8 of the
    pfoa driver's global DF-UKS, with the factor's auxiliary axis and the
    grid split in two."""
    from nbed_tpu_torch.parallel import make_sharded_df_ks

    eng = driver._ks_engine
    mol = eng.mol
    t0 = time.perf_counter()
    fn, args = make_sharded_df_ks(mol, _cuda_mesh(1), xc="b3lyp", df_beta=eng.df_beta,
                                  grid_level=eng.grid_level, conv_tol=1e-10,
                                  dm_conv_tol=1e-8, max_cycle=100,
                                  dm0=driver._global_ks.make_rdm1())
    build_s = _sync_s(t0, device)
    t0 = time.perf_counter()
    res = fn(*args)
    scf_s = _sync_s(t0, device)
    if not res.converged:
        raise RuntimeError("pfoa_sharded: the split DF-UKS did not converge")
    e = res.e_elec + mol.energy_nuc()
    _gate("pfoa_sharded vs the driver's global DF-UKS",
          [("e_tot", e, driver._global_ks.e_tot)], 1e-8)
    print("pfoa_sharded", json.dumps({
        "build_s": build_s, "scf_s": scf_s, "cycles": res.n_iter,
        "b_slab": list(args[2][0].shape), "grid_slab": list(args[3][0].shape),
        "dev": e - driver._global_ks.e_tot}), flush=True)


# ------------------------------------------------- the compiled-program slice

# the capturable eigh's cases: (n, batch) of the Fock diagonalisations of
# water (nao 7), acetonitrile (18) and pfoa (126), both spins in one call,
# and of the DIIS system (diis_space + 1 = 9, one matrix); float32 at the
# float32 warm-up's shapes on the main path (water, acetonitrile and pfoa,
# on exact ERIs)
EIGH_CASES = ((7, 2), (18, 2), (126, 2), (9, 1))
EIGH_F32_MAX_N = 126
# eigenvalues relative to the largest, and the occupied-space projectors
EIGH_TOLERANCES = {torch.float64: (1e-12, 1e-10), torch.float32: (1e-5, 1e-4)}
# the SCFs of the graphed_scf phase (each converges in under 20 cycles;
# max_cycle bounds the single replay of dispatch_cycles=0, whose capture
# grows with it)
GRAPH_SCF = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=40)


def eigh_bound(n: int, batch: int, dtype):
    """(ms, "bytes" or "operations"): the least time of ``batch``
    eigendecompositions of order n with vectors: each matrix read once and
    its vectors and values written once at 3.35 TB/s, or 9 n^3 operations a
    matrix (the symmetric QR algorithm with vectors, Golub and Van Loan) at
    67 TFLOP/s, whichever is larger."""
    word = 8 if dtype == torch.float64 else 4
    by_bytes = batch * (2 * n * n + n) * word / HBM_BYTES_PER_S
    by_ops = batch * 9 * n ** 3 / PEAK_FLOP_PER_S
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def hold_eigh(n: int, batch: int, dtype) -> float:
    """The prepared cuSOLVER eigh (``ops.eigh``) on seeded symmetric
    matrices against the float64 ``torch.linalg.eigh`` of them: eigenvalues within the relative
    tolerance, the projector onto the lower half of the eigenvectors within
    the absolute one (eigenvectors are free up to sign and rotation within
    a degenerate space), no solver failure; two calls and a CUDA-graph
    replay bitwise equal. Returns the largest eigenvalue error, absolute
    and relative to the largest eigenvalue."""
    from nbed_tpu_torch.ops import eigh as eigh_ops

    rtol, atol = EIGH_TOLERANCES[dtype]
    rng = np.random.default_rng(n * 10 + batch)
    a = rng.standard_normal((batch, n, n))
    a = torch.tensor(a + a.swapaxes(-1, -2), dtype=dtype, device="cuda")
    w, v = eigh_ops.eigh(a)
    # float32 against float64 of the same matrices: torch's float32 eigh
    # misses float64 by 3.2e-5 relative at n = 126 on the card, cuSOLVER's
    # by 6.4e-7 (check_eigh_f32)
    w_ref, v_ref = torch.linalg.eigh(a.to(torch.float64))
    k = n // 2
    abs_err = float(torch.max(torch.abs(w - w_ref)))
    err = abs_err / float(torch.max(torch.abs(w_ref)))
    proj = float(torch.max(torch.abs(v[..., :k] @ v[..., :k].mT
                                     - v_ref[..., :k] @ v_ref[..., :k].mT)))
    fails = int(eigh_ops.failure_count(a.device))
    what = f"eigh n={n} batch={batch} {dtype}"
    if not (err <= rtol and proj <= atol and fails == 0):
        raise RuntimeError(f"{what}: eigenvalue error {err}, projector error {proj}, "
                           f"{fails} failed matrices")
    w2, v2 = eigh_ops.eigh(a)
    if not (torch.equal(w, w2) and torch.equal(v, v2)):
        raise RuntimeError(f"{what}: two calls differ")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        w_g, v_g = eigh_ops.eigh(a)
    graph.replay()
    torch.cuda.synchronize()
    if not (torch.equal(w_g, w) and torch.equal(v_g, v)):
        raise RuntimeError(f"{what}: CUDA-graph replay differs from the eager call")
    return abs_err, err


EIGH_F32_CASES = (18, 126, 324)


def check_eigh_f32() -> list:
    """Both float32 solvers, the prepared cuSOLVER eigh (``ops.eigh``, the
    one inside the graphs) and ``torch.linalg.eigh`` (the eager SCF's),
    against a float64 ``torch.linalg.eigh`` of the same float32 matrices
    (two seeded symmetric matrices at each n of :data:`EIGH_F32_CASES`):
    eigenvalues relative to the largest, and the projector onto the lower
    half of the eigenvectors. Returns one row per n with both solvers'
    errors and times; raises where the cuSOLVER solver misses
    :data:`EIGH_TOLERANCES` (torch's float32 solver is printed, not held)."""
    from nbed_tpu_torch.ops import eigh as eigh_ops

    rtol, atol = EIGH_TOLERANCES[torch.float32]
    rows = []
    for n in EIGH_F32_CASES:
        rng = np.random.default_rng(n * 10 + 2)
        a = rng.standard_normal((2, n, n))
        a32 = torch.tensor(a + a.swapaxes(-1, -2), dtype=torch.float32, device="cuda")
        w_ref, v_ref = torch.linalg.eigh(a32.to(torch.float64))
        k = n // 2
        p_ref = v_ref[..., :k] @ v_ref[..., :k].mT
        scale = float(torch.max(torch.abs(w_ref)))
        row = {"n": n, "batch": 2}
        for label, solve in (("cusolver_f32", eigh_ops.eigh), ("torch_f32", torch.linalg.eigh)):
            w, v = solve(a32)
            w, v = w.to(torch.float64), v.to(torch.float64)
            row[f"{label}_eig_rel"] = float(torch.max(torch.abs(w - w_ref))) / scale
            row[f"{label}_proj"] = float(torch.max(torch.abs(v[..., :k] @ v[..., :k].mT
                                                              - p_ref)))
            row[f"{label}_ms"] = median_ms(lambda: solve(a32))
        fails = int(eigh_ops.failure_count(a32.device))
        print("eigh_f32_vs_f64", json.dumps(row), flush=True)
        if not (row["cusolver_f32_eig_rel"] <= rtol and row["cusolver_f32_proj"] <= atol
                and fails == 0):
            raise RuntimeError(f"eigh n={n}: the float32 cuSOLVER eigh misses float64 by "
                               f"{row['cusolver_f32_eig_rel']} (eigenvalues) and "
                               f"{row['cusolver_f32_proj']} (projector), {fails} failures")
        rows.append(row)
    return rows


def eigh_timings(fn) -> dict:
    """:func:`timings` of an eigh call, over 100 enqueues for ``host_us``
    (a call is 0.1-3 ms)."""
    return {"ms": median_ms(fn), "ms_stream": stream_ms(fn), "host_us": host_us(fn, 100)}


def check_eigh() -> list:
    """:func:`hold_eigh` at every case in float64 and, up to
    :data:`EIGH_F32_MAX_N`, in float32 (then :func:`check_eigh_f32`), the
    times of the kernel, of ``torch.linalg.eigh`` (the plain version, which
    is also the one library call), the kernel's device time per call
    (torch.profiler, every device event of the call) and the bound;
    returns rows."""
    from nbed_tpu_torch.ops import eigh as eigh_ops
    from nbed_tpu_torch.profiling import device_profile

    rows = []
    for n, batch in EIGH_CASES:
        for dtype in (torch.float64, torch.float32)[:2 if n <= EIGH_F32_MAX_N else 1]:
            abs_err, err = hold_eigh(n, batch, dtype)
            a = torch.eye(n, dtype=dtype, device="cuda").expand(batch, n, n) * 2.0
            a = a + 1e-3 * torch.arange(n * n, dtype=dtype, device="cuda").reshape(n, n)
            a = 0.5 * (a + a.mT)
            kernel = lambda: eigh_ops.eigh(a)  # noqa: E731
            plain = lambda: torch.linalg.eigh(a)  # noqa: E731
            _, prof = device_profile(lambda: [kernel() for _ in range(20)])
            row = {"n": n, "batch": batch, "dtype": str(dtype).removeprefix("torch."),
                   "max_abs_err": abs_err, "max_rel_err": err, **eigh_timings(kernel),
                   **{f"plain_{k}": v for k, v in eigh_timings(plain).items()},
                   "library_ms": median_ms(plain),
                   "kernel_device_us": prof["device_busy_s"] * 1e6 / 20,
                   **dict(zip(("bound_ms", "bound_by"), eigh_bound(n, batch, dtype)))}
            print("eigh", json.dumps(row), flush=True)
            rows.append(row)
    check_eigh_f32()
    return rows


# the FCI sectors (spin orbitals, nelec, nonzero h2 terms drawn; None: all)
# the sector-matrix kernel is held and timed at: water's embedded mu sector
# (the benchmark's water cell, D = 100), water's full sector (the global
# FCI, D = 441), and two larger sectors (D = 3920, 15876) on sparse random
# terms, so that the host oracle builds them in seconds
FCI_SECTORS = ((10, (3, 3), None), (14, (5, 5), None), (16, (4, 3), 2000),
               (18, (4, 4), 2000))


def fci_bound(dim: int):
    """(ms, "bytes"): the least time of one sector matrix, its D^2 float64
    written once at 3.35 TB/s (h1 and h2 are read from L2; the operations
    per element are a few dozen integer steps, not a bound)."""
    return 1e3 * dim * dim * 8 / HBM_BYTES_PER_S, "bytes"


def check_fci_hamiltonian() -> list:
    """The sector-matrix kernel (``ops.fci_hamiltonian``) at each of
    :data:`FCI_SECTORS` on seeded random Hermitian h1 and h2 against the host
    oracle ``sector_hamiltonian(...).toarray()`` (within 1e-12), and
    ``run_fci``'s dense card route against its host route (lowest three
    values within 1e-10); times the kernel (single call, back to back and by the
    profiler), the oracle, ``torch.linalg.eigvalsh`` of the matrix and both
    routes of ``run_fci``; returns rows."""
    from nbed_tpu_torch.ops import fci_hamiltonian as fh
    from nbed_tpu_torch.solvers import fci

    rows = []
    for n, nelec, n_terms in FCI_SECTORS:
        rng = np.random.default_rng(n)
        h1 = rng.standard_normal((n, n))
        h2 = rng.standard_normal((n, n, n, n))
        if n_terms is not None:
            keep = np.zeros(h2.size, dtype=bool)
            keep[rng.choice(h2.size, n_terms, replace=False)] = True
            h2 = h2 * keep.reshape(h2.shape)
        h1, h2 = h1 + h1.T, 0.5 * (h2 + h2.transpose(3, 2, 1, 0))
        h1c, h2c = (torch.tensor(t, device="cuda") for t in (h1, h2))
        basis_c = torch.as_tensor(fci.sector_basis(n, nelec), device="cuda")
        dim = basis_c.numel()
        kernel = lambda: fh.sector_matrix(0.5, h1c, h2c, basis_c)  # noqa: E731
        ours = kernel()
        t0 = time.perf_counter()
        ref = fci.sector_hamiltonian(0.5, h1, h2, n, nelec)[0].toarray()
        oracle_ms = 1e3 * (time.perf_counter() - t0)
        err = float(np.max(np.abs(ours.cpu().numpy() - ref)))
        del ref
        if not err <= 1e-12:
            raise RuntimeError(f"fci_hamiltonian D={dim}: kernel misses the host oracle "
                               f"by {err}")
        if not torch.equal(kernel(), ours):
            raise RuntimeError(f"fci_hamiltonian D={dim}: two launches differ")
        def route():
            return fci.run_fci(0.5, h1c, h2c, n, nelec, k=3)

        # the two larger sectors' eigvalsh takes up to seconds: one timed call
        reps, warmup = (10, 3) if dim <= 441 else (1, 1)
        before = fci.ROUTES["card"]
        vals = route()[0]
        # these random terms mix spins: the dense route at every size, also
        # above fci.DENSE_MAX, where the matrix-free route cannot take them
        if fci.ROUTES["card"] != before + 1:
            raise RuntimeError(f"run_fci D={dim}: spin-mixing terms left the card route "
                               f"({dict(fci.ROUTES)})")
        row = {"n": n, "nelec": list(nelec), "dim": dim, "h2_terms": int(np.count_nonzero(h2)),
               "max_abs_err": err, "ms": median_ms(kernel), "ms_stream": stream_ms(kernel),
               "kernel_device_us": device_us(kernel, "fci_hamiltonian"),
               "oracle_ms": oracle_ms,
               "eigvalsh_ms": median_ms(lambda: torch.linalg.eigvalsh(ours), reps, warmup),
               "card_route_ms": median_ms(route, reps, warmup),
               **dict(zip(("bound_ms", "bound_by"), fci_bound(dim)))}
        del ours
        t0 = time.perf_counter()
        host_vals = fci.run_fci(0.5, h1, h2, n, nelec, k=3)[0]
        row["host_route_ms"] = 1e3 * (time.perf_counter() - t0)
        row["route_max_abs_err"] = float(np.max(np.abs(vals - host_vals)))
        if not row["route_max_abs_err"] <= 1e-10:
            raise RuntimeError(f"run_fci D={dim}: card route misses the host route by "
                               f"{row['route_max_abs_err']}")
        print("fci_hamiltonian", json.dumps(row), flush=True)
        rows.append(row)
    return rows


# the matrix-free route's sectors (n spin orbitals, (n_alpha, n_beta)): the
# dense route's sizes of FCI_SECTORS, on spin-conserving terms
FCI_DIRECT_SECTORS = ((10, (3, 3)), (14, (5, 5)), (16, (4, 3)), (18, (4, 4)))


def spin_conserving_terms(n_spinorb: int, seed: int, unrestricted: bool = False,
                          device: str = "cuda"):
    """(h1, 0.5 h2) spin-orbital tensors of a seeded molecule-like
    spatial Hamiltonian (orbital energies -2..1 Ha with small couplings,
    ERIs a positive sum of factor products), interleaved by HamiltonianBuilder's
    ``_spinorb_from_spatial``; alpha and beta differ where ``unrestricted``."""
    from nbed_tpu_torch.ham import HamiltonianBuilder

    k = n_spinorb // 2
    rng = np.random.default_rng(seed)

    def one_body():
        h = 0.1 * rng.standard_normal((k, k))
        return np.diag(np.linspace(-2.0, 1.0, k)) + h + h.T

    def factor():
        b = rng.standard_normal((2 * k, k, k))
        return 0.15 * (b + b.transpose(0, 2, 1))

    ha, ba = one_body(), factor()
    hb, bb = (one_body(), factor()) if unrestricted else (ha, ba)
    chem = [np.einsum("lpq,lrs->pqrs", x, y) for x, y in ((ba, ba), (bb, bb), (ba, bb), (bb, ba))]
    one = torch.tensor(np.stack([ha, hb]), device=device)
    two = torch.tensor(np.stack(chem), device=device).permute(0, 1, 3, 4, 2)
    h1, h2 = HamiltonianBuilder._spinorb_from_spatial(one, two.contiguous(), 0.0)
    return h1, 0.5 * h2


def _plain_sigma(op, c):
    """``op.sigma(c)`` with the gather and scatter steps' plain versions."""
    from unittest import mock

    from nbed_tpu_torch.ops import fci_sigma

    with mock.patch.object(fci_sigma, "gather", fci_sigma.gather_reference), \
            mock.patch.object(fci_sigma, "scatter", fci_sigma.scatter_reference):
        return op.sigma(c)


def _sigma_row(op, label: str) -> dict:
    """The kernels' sigma against the plain steps' on a seeded vector (within
    1e-12 of its largest element), and one product's times both ways."""
    from nbed_tpu_torch.solvers import fci_direct

    gen = torch.Generator(device="cuda").manual_seed(11)
    shape = op.diagonal.shape
    c = torch.randn(shape, generator=gen, dtype=torch.float64, device="cuda")
    ours, plain = op.sigma(c), _plain_sigma(op, c)
    err = float(torch.max(torch.abs(ours - plain)) / torch.max(torch.abs(plain)))
    if not err <= 1e-12:
        raise RuntimeError(f"fci_sigma {label}: kernels miss the plain steps by {err} "
                           f"(relative)")
    if not torch.equal(op.sigma(c), ours):
        raise RuntimeError(f"fci_sigma {label}: two products differ")
    before = dict(fci_direct.SIGMAS)
    row = {"label": label, "na": op.t.na, "nb": op.t.nb, "block_rows": op.block,
           "rel_err": err, "sigma_ms": median_ms(lambda: op.sigma(c), 5, 1),
           "plain_sigma_ms": median_ms(lambda: _plain_sigma(op, c), 3, 1),
           "gather_device_us": device_us(lambda: op.sigma(c), "fci_sigma_gather", n=2),
           "scatter_device_us": device_us(lambda: op.sigma(c), "fci_sigma_scatter", n=2)}
    assert fci_direct.SIGMAS["sigma"] > before.get("sigma", 0)
    return row


def check_fci_direct() -> list:
    """The matrix-free route at each of :data:`FCI_DIRECT_SECTORS` on
    seeded spin-conserving terms (restricted; the (4, 3) sector also
    unrestricted): its kernels against their plain steps, its lowest three
    eigenvalues against the dense card route's (within 1e-10), and both
    routes' times, whose crossover sets ``fci.DENSE_MAX``; returns rows."""
    from nbed_tpu_torch.solvers import fci, fci_direct

    rows = []
    for n, nelec in FCI_DIRECT_SECTORS:
        for unrestricted in (False, True) if nelec == (4, 3) else (False,):
            h1, h2 = spin_conserving_terms(n, n, unrestricted)
            label = f"n={n} {nelec}{' unrestricted' if unrestricted else ''}"
            op = fci_direct.DirectFCI(h1, h2, n, nelec)
            row = _sigma_row(op, label)
            basis = torch.as_tensor(fci.sector_basis(n, nelec), device="cuda")

            def dense():
                from nbed_tpu_torch.ops.fci_hamiltonian import sector_matrix
                return torch.linalg.eigvalsh(sector_matrix(0.25, h1, h2, basis))[:3].cpu().numpy()

            def direct():
                return fci_direct.run_direct(0.25, h1, h2, n, nelec, k=3)

            reps, warmup = (5, 1) if basis.numel() <= 3920 else (1, 1)
            before = fci_direct.SIGMAS["sigma"]
            vals = direct()
            row["sigmas_k3"] = fci_direct.SIGMAS["sigma"] - before
            before = fci_direct.SIGMAS["sigma"]
            vals1 = fci_direct.run_direct(0.25, h1, h2, n, nelec, k=1)
            row["sigmas_k1"] = fci_direct.SIGMAS["sigma"] - before
            dense_vals = dense()
            row.update(dim=basis.numel(), dense_ms=median_ms(dense, reps, warmup),
                       direct_ms=median_ms(direct, reps, warmup),
                       direct_k1_ms=median_ms(lambda: fci_direct.run_direct(
                           0.25, h1, h2, n, nelec, k=1), reps, warmup),
                       max_abs_err=float(np.max(np.abs(vals - dense_vals))),
                       k1_err=float(abs(vals1[0] - dense_vals[0])))
            if not (row["max_abs_err"] <= 1e-10 and row["k1_err"] <= 1e-10):
                raise RuntimeError(f"fci_direct {label}: misses the dense route: {row}")
            print("fci_direct", json.dumps(row), flush=True)
            rows.append(row)
    return rows


def check_fci_acetonitrile() -> dict:
    """The PRA acetonitrile embedding with the embedded FCI on (the
    published 28-qubit Hamiltonian, 7 + 7 electrons in 14 orbitals,
    11,778,624 determinants) through ``nbed()`` on the card: the route it
    takes, its kernels against their plain steps on the real sector, and
    ``e_fci`` against the benchmark reference's matrix-free FCI
    (``benchmark/reference/fci_direct.py``, plain torch) on the same
    embedded Hamiltonian (within 1e-9 Ha)."""
    from nbed_tpu_torch import nbed
    from nbed_tpu_torch.driver import _embedded_hamiltonian
    from nbed_tpu_torch.ops import fci_sigma
    from nbed_tpu_torch.solvers import fci, fci_direct

    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmark"))
    from reference.fci_direct import fci_energy_direct

    config = {**CONFIGS["acetonitrile"], "run_fci_emb": True}
    before = dict(fci.ROUTES)
    driver, first_s = _timed(lambda: nbed(device="cuda", **config))
    routes = {k: fci.ROUTES[k] - before.get(k, 0) for k in fci.ROUTES}
    if routes.get("matrix_free") != 1:
        raise RuntimeError(f"acetonitrile FCI: routes {routes}, not one matrix-free call")
    # the warm request's own launches: the counters set to 0 just before it
    # and read just after
    sigmas = fci_direct.SIGMAS["sigma"]
    fci_sigma.LAUNCHES.clear()
    fci_sigma.LAUNCHES_BY_SHAPE.clear()
    driver2, warm_s = _timed(lambda: nbed(device="cuda", **config))
    sigmas = fci_direct.SIGMAS["sigma"] - sigmas
    launches = dict(fci_sigma.LAUNCHES)
    launches_by_shape = {" ".join(map(str, k)): n for k, n in fci_sigma.LAUNCHES_BY_SHAPE.items()}
    if not (launches.get("fci_sigma_gather") and launches.get("fci_sigma_scatter")):
        raise RuntimeError(f"acetonitrile FCI: the warm request launched {launches}, not "
                           f"both fci_sigma kernels")
    result = driver2.huzinaga
    _, h1, h2, occ = _embedded_hamiltonian(result["scf"], None)
    nelec = (int(np.sum(occ[::2])), int(np.sum(occ[1::2])))
    op = fci_direct.DirectFCI(h1, h2, h1.shape[0], nelec)
    row = _sigma_row(op, "acetonitrile")
    del op
    (vals, _), fci_s = _timed(lambda: fci.run_fci(0.0, h1, h2, h1.shape[0], nelec))
    h_sp = h1[::2, ::2].cpu().numpy()
    chem = (2.0 * h2[::2, ::2, ::2, ::2]).permute(0, 3, 1, 2).cpu().numpy()
    torch.cuda.empty_cache()
    e_ref, ref_s = _timed(lambda: fci_energy_direct(h_sp, chem, *nelec, torch.float64, "cuda"))
    row.update(n_spinorb=int(h1.shape[0]), nelec=list(nelec), dim=fci._sector_dim(
        int(h1.shape[0]), nelec), e_fci=float(result["e_fci"]), e_ccsd=float(result["e_ccsd"]),
        first_nbed_s=first_s, warm_nbed_s=warm_s, sigmas_warm=sigmas, launches_warm=launches,
        launches_warm_by_shape=launches_by_shape, run_fci_s=fci_s,
        post_fci_s=driver2.timings.get("post.fci"), reference_s=ref_s,
        fci_vs_reference=float(abs(vals[0] - e_ref)),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        spans={k: round(v, 4) for k, v in driver2.timings.items() if k.startswith("fci.")})
    print("fci_acetonitrile", json.dumps(row), flush=True)
    if not row["fci_vs_reference"] <= 1e-9:
        raise RuntimeError(f"acetonitrile FCI misses the reference by {row['fci_vs_reference']}")
    return row


# the ERI kernel's least time: its E . R . E contraction's operations
# (ops.eri.operations) at the H100's float64 rate outside the tensor cores
F64_SCALAR_FLOP_PER_S = 34e12


def check_md_eri() -> list:
    """The ERI kernel (``ops.eri``) on acetonitrile/STO-3G at B = 1 (the
    publication geometry) and B = 36 (jittered by 0.02 bohr, the fleet's
    conformers) against the host engine (``integrals.native.eri``, each
    lane, within 1e-12) and in a second launch bitwise; times the kernel
    (single call, back to back, device time of its two launches by the
    profiler), the plain version (``integrals.eri.eri_torch`` eager on the
    card) and the host engine (the lanes in turn); returns rows."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.integrals import native
    from nbed_tpu_torch.integrals.eri import _device_tables, eri_torch
    from nbed_tpu_torch.ops import eri as md_eri

    mol = build_molecule(ACETONITRILE, "sto-3g")
    tab = md_eri.tables(mol)
    rng = np.random.default_rng(24)
    rows = []
    for batch in (1, 36):
        coords = (mol.coords[None] if batch == 1 else
                  mol.coords + rng.normal(0.0, 0.02, (batch,) + mol.coords.shape))
        x = torch.as_tensor(coords if batch > 1 else coords[0], device="cuda")
        kernel = lambda: md_eri.eri(mol, x)  # noqa: E731
        ours = kernel()
        t0 = time.perf_counter()
        refs = [native.eri(mol, c) for c in coords]
        host_ms = 1e3 * (time.perf_counter() - t0)
        got = ours.reshape((batch,) + (mol.nao,) * 4).cpu().numpy()
        err = max(float(np.abs(got[b] - refs[b]).max()) for b in range(batch))
        if not err <= 1e-12:
            raise RuntimeError(f"md_eri B={batch}: kernel misses the host engine by {err}")
        if not torch.equal(kernel(), ours):
            raise RuntimeError(f"md_eri B={batch}: two launches differ")
        tables = _device_tables(mol, x.device)
        plain = lambda: eri_torch(mol, x, tables, 2**22, None)  # noqa: E731
        plain_err = float((plain() - ours).abs().max())
        ops = md_eri.operations(tab, batch)
        row = {"molecule": "acetonitrile", "basis": "sto-3g", "batch": batch, "nao": mol.nao,
               "quartets": len(tab.quartets), "max_abs_err": err, "plain_max_abs_err": plain_err,
               "ms": median_ms(kernel), "ms_stream": stream_ms(kernel, 20),
               "pairs_device_us": device_us(kernel, "md_eri_pairs"),
               "quartets_device_us": device_us(kernel, "md_eri_quartets"),
               "plain_ms": median_ms(plain, 5, 1), "host_ms": host_ms,
               "operations": ops, "bound_ms": 1e3 * ops / F64_SCALAR_FLOP_PER_S,
               "bound_by": "float64 operations"}
        row["kernel_device_us"] = row["pairs_device_us"] + row["quartets_device_us"]
        row["roofline_pct"] = 100.0 * 1e3 * row["bound_ms"] / row["kernel_device_us"]
        print("md_eri", json.dumps(row), flush=True)
        rows.append(row)
    return rows


@contextmanager
def driver_engines(jit_kernel: str):
    """Inside the block, the engines that ``nbed()`` makes run with
    ``jit_kernel`` (the config has no such field: a measurement switch)."""
    from functools import partial

    import nbed_tpu_torch.driver as driver_mod

    base = driver_mod.SCFEngine
    driver_mod.SCFEngine = partial(base, jit_kernel=jit_kernel)
    try:
        yield
    finally:
        driver_mod.SCFEngine = base


def _timed(fn):
    """(fn(), its wall seconds with the card synchronised before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _program_inputs(eng, call: dict) -> dict:
    """The inputs ``SCFEngine.kernel`` gives the float64 program for
    ``call`` (no warm-up): the SAD guess of a full-molecule call."""
    from nbed_tpu_torch.scf.engine import _spinify

    def spin(t):
        return None if t is None else _spinify(eng._tensor(t))

    v = call.get("v_emb")
    v = None if v is None else eng._tensor(v)
    if v is not None and v.ndim == 2:
        v = torch.stack([v, v])
    dm0 = call.get("dm0")
    if dm0 is None and "v_emb" not in call:
        dm0 = eng._sad_guess()
    return dict(v_emb=v, dm_env_occ=spin(call.get("dm_env_occ")),
                dm_env_virt=spin(call.get("dm_env_virt")), dm0=spin(dm0),
                conv_tol=eng.conv_tol, dm_conv_tol=eng.dm_conv_tol,
                max_cycle=eng.max_cycle)


def _program_of(eng, call: dict, cycles: int):
    """The shared float64 program that ``eng.kernel(**call)`` replays at
    ``cycles`` cycles per replay, with ``eng``'s operators in its buffers."""
    nelec = call.get("nelec", eng.mol.nelec)
    present = tuple(call.get(k) is not None for k in ("v_emb", "dm_env_occ", "dm_env_virt"))
    return eng._scf_graph(torch.float64, nelec, present, 0.0, cycles)


def hold_replay(eng, call: dict) -> int:
    """Two replays of the engine's captured float64 chunk and its final
    build against the same body run uncaptured from the same loaded state
    (the same cuSOLVER eigh): every state buffer, the flags and the final
    Fock, Huzinaga operator and energy bitwise equal. Returns the cycles
    per replay."""
    from nbed_tpu_torch.scf.engine import DISPATCH_CYCLES

    graph = _program_of(eng, call, DISPATCH_CYCLES)
    prog = graph.program
    inputs = _program_inputs(eng, call)

    def snapshot():
        return {**{k: v.clone() for k, v in prog.state.items()}, "flags": prog.flags.clone(),
                "fock": prog.fock.clone(), "huz": prog.huz.clone(), "e": prog.e_fin.clone()}

    prog.load(**inputs)
    for _ in range(2):
        prog.run_cycles(graph.cycles)
    prog.finish()
    body = snapshot()
    prog.load(**inputs)
    for _ in range(2):
        graph.chunk()
    graph.final()
    replay = snapshot()
    differ = [k for k in body if not torch.equal(body[k], replay[k])]
    if differ:
        raise RuntimeError(f"graph replay differs from the uncaptured body in {differ}")
    return graph.cycles


def hold_graphed(label: str, eng, call: dict) -> dict:
    """One engine and call signature eager (``jit_kernel="off"``) and
    graphed: the graphed kernel() within 1e-10 Ha of the eager one in as
    many cycles; the replay against the uncaptured body (:func:`hold_replay`);
    ``dispatch_cycles`` 0, 4 and the default each within 1e-10 Ha in as
    many cycles. Returns the row: warm kernel() walls, replays and host
    reads per SCF, capture seconds, captured launches per cycle and the
    peak device memory of each way."""
    from nbed_tpu_torch.ops import eigh as eigh_ops
    from nbed_tpu_torch.ops import jk

    eng.jit_kernel, eng.dispatch_cycles = "off", None
    torch.cuda.reset_peak_memory_stats()
    eng.kernel(**call)
    peak_eager = torch.cuda.max_memory_allocated() / 1e9
    eager, eager_s = _timed(lambda: eng.kernel(**call))
    cycles = eng.last_run["cycles"]
    eng.jit_kernel = "on"
    torch.cuda.reset_peak_memory_stats()
    _, first_s = _timed(lambda: eng.kernel(**call))
    peak_graph = torch.cuda.max_memory_allocated() / 1e9
    first = dict(eng.last_run)
    graphed, graph_s = _timed(lambda: eng.kernel(**call))
    warm = dict(eng.last_run)
    if not (eager.converged and graphed.converged):
        raise RuntimeError(f"graphed_scf {label}: an SCF did not converge")
    _gate(f"graphed_scf {label} graph vs eager", [("e_tot", graphed.e_tot, eager.e_tot)],
          1e-10)
    if warm["mode"] != "graph" or warm["cycles"] != cycles:
        raise RuntimeError(f"graphed_scf {label}: {warm['mode']} run of {warm['cycles']} "
                           f"cycles against {cycles} eager")
    per_replay = hold_replay(eng, call)
    chunks = {}
    for dispatch in (0, 4, None):
        eng.dispatch_cycles = dispatch
        sol = eng.kernel(**call)
        _gate(f"graphed_scf {label} dispatch_cycles={dispatch}",
              [("e_tot", sol.e_tot, eager.e_tot)], 1e-10)
        if eng.last_run["cycles"] != cycles:
            raise RuntimeError(f"graphed_scf {label} dispatch_cycles={dispatch}: "
                               f"{eng.last_run['cycles']} cycles against {cycles}")
        chunks[str(dispatch)] = {"de": sol.e_tot - eager.e_tot,
                                 "replays": eng.last_run["replays"],
                                 "capture_s": eng.last_run["capture_s"]}
    eng.dispatch_cycles = None
    graph = _program_of(eng, call, per_replay)
    row = {
        "label": label, "nao": eng.mol.nao, "cycles": cycles,
        "e_eager": eager.e_tot, "de_graph": graphed.e_tot - eager.e_tot,
        "kernel_eager_warm_s": eager_s, "kernel_graph_first_s": first_s,
        "kernel_graph_warm_s": graph_s, "capture_s": first["capture_s"],
        "replays": warm["replays"], "host_reads": warm["host_reads"],
        "cycles_per_replay": warm["cycles_per_replay"],
        "launches_per_cycle": {
            k: v / per_replay for k, v in {**graph.chunk.record.launches(jk.LAUNCHES),
                                           **graph.chunk.record.launches(
                                               eigh_ops.LAUNCHES)}.items()},
        "peak_gb_eager": peak_eager, "peak_gb_graph_first": peak_graph,
        "replay_bitwise": True, "dispatch": chunks,
    }
    print("graphed_scf", json.dumps(row), flush=True)
    return row


def hold_subsystem(label: str, eng, sol):
    """get_veff and subsystem_decomposition graphed against eager within
    1e-12, on the split of ``sol``'s occupied orbitals into a first half
    (active) and the rest (environment)."""
    c, occ = sol.per_spin()
    w = occ.clone()
    for s in range(2):
        idx = torch.nonzero(occ[s] > 0.5).flatten()
        w[s, idx[len(idx) // 2:]] = 0.0
    dm_act = torch.einsum("spi,si,sqi->spq", c, w, c)
    dm_env = torch.einsum("spi,si,sqi->spq", c, occ - w, c)
    out = {}
    for mode in ("off", "on"):
        eng.jit_kernel = mode
        veff = eng.get_veff(dm_act + dm_env)
        out[mode] = (eng.subsystem_decomposition(dm_act, dm_env), veff)
    (sub_e, veff_e), (sub_g, veff_g) = out["off"], out["on"]
    pairs = [(f"subsystem[{i}]", sub_g[i], sub_e[i]) for i in range(3)]
    pairs += [("v_emb", float(torch.max(torch.abs(sub_g[3] - sub_e[3]))), 0.0),
              ("veff", float(torch.max(torch.abs(veff_g.matrix - veff_e.matrix))), 0.0),
              ("exc", float(veff_g.exc), float(veff_e.exc)),
              ("ecoul", float(veff_g.ecoul), float(veff_e.ecoul))]
    _gate(f"graphed_scf {label} subsystem stage", pairs, 1e-12)
    return {key: ours - ref for key, ours, ref in pairs}


def hold_torch_integrals(label: str, mol, xc):
    """``integrals_backend="torch"`` against ``"native"``: S, hcore and the
    ERIs within 1e-10, the graphed global SCF's energy within 1e-10 Ha."""
    from nbed_tpu_torch.scf import SCFEngine

    nat = SCFEngine(mol, xc=xc, device="cuda", integrals_backend="native", **GRAPH_SCF)
    tor = SCFEngine(mol, xc=xc, device="cuda", integrals_backend="torch", **GRAPH_SCF)
    pairs = [(name, float(torch.max(torch.abs(getattr(tor, name) - getattr(nat, name)))), 0.0)
             for name in ("s", "hcore", "eri")]
    e_tor, e_nat = tor.kernel().e_tot, nat.kernel().e_tot
    pairs.append(("e_tot", e_tor, e_nat))
    _gate(f"graphed_scf {label} torch integrals", pairs, 1e-10)
    return {key: ours - ref for key, ours, ref in pairs}


def run_graphed_scf(pfoa_driver):
    """The graphed SCF programs (``SCFEngine(jit_kernel=, dispatch_cycles=,
    integrals_backend=)``) on the card: water's UHF, B3LYP, a mu-embedded
    UHF (seeded v_emb, nelec (3, 3)) and a Huzinaga UHF (the lowest occupied
    and highest virtual MO per spin as the environment, nelec (4, 4));
    acetonitrile's B3LYP5; and pfoa's DF-B3LYP at full size on the pfoa
    driver's factor (:func:`hold_graphed`); the subsystem stage of each
    B3LYP engine (:func:`hold_subsystem`); and the torch integrals of water
    and acetonitrile (:func:`hold_torch_integrals`). The warm ``nbed()``
    walls are :func:`run_shared_programs`'."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import SCFEngine

    water = build_molecule(WATER.read_text(), "sto-3g")
    acn = build_molecule(ACETONITRILE, "sto-3g")
    rows, subsystem, integrals = [], {}, {}
    uhf = SCFEngine(water, device="cuda", **GRAPH_SCF)
    rows.append(hold_graphed("water_uhf", uhf, {}))
    ref = uhf.kernel()
    c = ref.mo_coeff
    rng = np.random.default_rng(3)
    v = 0.01 * rng.standard_normal((water.nao, water.nao))
    v = v + v.T
    rows.append(hold_graphed("water_mu", SCFEngine(water, device="cuda", **GRAPH_SCF),
                             {"nelec": (3, 3), "v_emb": v}))
    rows.append(hold_graphed("water_huzinaga", SCFEngine(water, device="cuda", **GRAPH_SCF), {
        "nelec": (4, 4), "v_emb": v,
        "dm_env_occ": torch.einsum("spi,sqi->spq", c[:, :, :1], c[:, :, :1]),
        "dm_env_virt": torch.einsum("spi,sqi->spq", c[:, :, -1:], c[:, :, -1:])}))
    pfoa_ks = pfoa_driver._ks_engine
    for label, eng in (
            ("water_b3lyp", SCFEngine(water, xc="b3lyp", device="cuda", **GRAPH_SCF)),
            ("acetonitrile_b3lyp5", SCFEngine(acn, xc="b3lyp5", device="cuda", **GRAPH_SCF)),
            ("pfoa_df_b3lyp", SCFEngine(pfoa_ks.mol, xc="b3lyp", device="cuda",
                                        density_fitting=True, df_b=pfoa_ks.df_factor(),
                                        conv_tol=1e-9, max_cycle=40))):
        rows.append(hold_graphed(label, eng, {}))
        subsystem[label] = hold_subsystem(label, eng, eng.kernel())
    for label, mol, xc in (("water", water, "b3lyp"), ("acetonitrile", acn, "b3lyp5")):
        integrals[label] = hold_torch_integrals(label, mol, xc)
    print("graphed_scf_summary", json.dumps({"subsystem": subsystem, "torch_integrals": integrals}),
          flush=True)
    return rows


# ---------------------------------------------------- the shared-program slice

def _hold_engine(label: str, eng, call: dict = None) -> dict:
    """``eng.kernel(**call)`` as it runs by default on the card (graphed,
    from the shared programs) against the same engine eager: within 1e-10
    Ha in as many cycles (and mixed-loop and warm-up cycles where it has
    them). Returns the graphed run's ``last_run`` with the energy
    difference."""
    call = call or {}
    mode = eng.jit_kernel
    graphed = eng.kernel(**call)
    run = dict(eng.last_run)
    eng.jit_kernel = "off"
    eager = eng.kernel(**call)
    eager_run = dict(eng.last_run)
    eng.jit_kernel = mode
    if not (graphed.converged and eager.converged) or run["mode"] != "graph":
        raise RuntimeError(f"{label}: {run['mode']} run, converged {graphed.converged}, "
                           f"eager converged {eager.converged}")
    _gate(f"{label} graph vs eager", [("e_tot", graphed.e_tot, eager.e_tot)], 1e-10)
    for key in ("cycles", "mixed_cycles", "warmup_cycles"):
        if run.get(key) != eager_run.get(key):
            raise RuntimeError(f"{label}: graphed {key} {run.get(key)}, eager "
                               f"{eager_run.get(key)}")
    return {**run, "de": graphed.e_tot - eager.e_tot}


def _captures():
    from nbed_tpu_torch.scf import engine

    return engine.RUNS["captures"], engine.RUNS["capture_s"]


def run_shared_programs(device="cuda"):
    """Programs shared by structure on the card, from an empty program
    cache: water at three geometries and acetonitrile at two through
    default ("auto") engines, each within 1e-10 Ha of its own eager run in
    as many cycles, with captures at each structure's first engine only; a
    second ``nbed()`` of water and of acetonitrile with no capture of any
    kind (the first captures the CCSD sweep and the grid and AO tables
    among its SCF programs) and energies bitwise equal to the first
    call's (captures, capture seconds and walls of both calls, and an
    eager call's wall, printed); the water B3LYP Hessian
    (``hessian_fd(xc="b3lyp")``: 18 displaced KS engines) with one capture
    set (a chunk, a final build, the grid and the AO tables), within 1e-6
    Ha/bohr^2 per element of the same Hessian with ``jit_kernel="off"``."""
    from nbed_tpu_torch import nbed
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import SCFEngine, engine
    from nbed_tpu_torch.solvers import ccsd, hessian_fd

    engine._JIT_PROGRAM_CACHE.clear()
    ccsd._SWEEP_PROGRAMS.clear()
    out = {}
    for label, xyz, xc, n_geom in (("water", WATER.read_text(), "b3lyp", 3),
                                   ("acetonitrile", ACETONITRILE, "b3lyp5", 2)):
        mol = build_molecule(xyz, "sto-3g")
        rows = []
        for i, x in enumerate(stretch_coords(mol, n_geom, 0.04)):
            eng = SCFEngine(mol, xc=xc, coords=x, device=device, **GRAPH_SCF)
            before = _captures()[0]
            row = _hold_engine(f"shared_programs {label} geometry {i}", eng)
            captured = _captures()[0] - before
            if (captured > 0) != (i == 0) or (row["captures"] > 0) != (i == 0):
                raise RuntimeError(f"shared_programs {label} geometry {i}: {captured} "
                                   "captures (only the structure's first engine captures)")
            rows.append({k: row[k] for k in ("cycles", "captures", "capture_s", "de")})
        out[label] = rows
    walls = {}
    for name in ("water", "acetonitrile"):
        calls = []
        for _ in range(2):
            driver, wall, runs = _program_counts(lambda: nbed(**CONFIGS[name], device=device))
            calls.append({"captures": runs.get("captures", 0),
                          "capture_s": runs.get("capture_s", 0.0), "wall_s": wall,
                          "e": pipeline_energies(driver),
                          "by_kind": {k[:-len("_captures")]: v for k, v in runs.items()
                                      if k.endswith("_captures")}})
        if calls[1]["captures"] or calls[1]["e"] != calls[0]["e"]:
            raise RuntimeError(f"shared_programs: the second nbed() of {name} made "
                               f"{calls[1]['captures']} captures, energies "
                               f"{calls[1]['e']} against {calls[0]['e']}")
        # the first call captured the CCSD sweep and the grid/AO programs
        # (its own structure's), the second none of any kind
        if not all(calls[0]["by_kind"].get(k) for k in ("ccsd_graph", "grid_graph",
                                                         "aos_graph")):
            raise RuntimeError(f"shared_programs: the first nbed() of {name} captured "
                               f"{calls[0]['by_kind']}")
        with driver_engines("off"):
            nbed(**CONFIGS[name], device=device)  # its SAD atoms, eager, cached
            _, eager_s = _timed(lambda: nbed(**CONFIGS[name], device=device))
        walls[name] = {"first": {k: calls[0][k] for k in ("captures", "capture_s", "wall_s",
                                                          "by_kind")},
                       "second": {k: calls[1][k] for k in ("captures", "capture_s",
                                                           "wall_s")},
                       "eager_wall_s": eager_s}
    out["embed"] = walls
    water = build_molecule(WATER.read_text(), "sto-3g")
    engine._JIT_PROGRAM_CACHE.clear()
    hess, wall, runs = _program_counts(lambda: hessian_fd(water, xc="b3lyp", device=device))
    captures, capture_s = runs.get("captures", 0), runs.get("capture_s", 0.0)
    tables = runs.get("grid_graph_captures", 0), runs.get("aos_graph_captures", 0)
    if captures != 4 or tables != (1, 1):
        raise RuntimeError(f"shared_programs: the B3LYP Hessian's 18 engines made {captures} "
                           f"captures, {tables} of them grid and AO tables, not one chunk, one "
                           "final build, one grid and one AO table")
    hess_off, wall_off = _timed(lambda: hessian_fd(water, xc="b3lyp", device=device,
                                                   jit_kernel="off"))
    out["ks_hessian"] = {"captures": captures, "capture_s": capture_s, "graphed_s": wall,
                         "eager_s": wall_off, "dev": _gate_array(
                             "shared_programs B3LYP Hessian graphed vs eager", hess, hess_off,
                             1e-6)}
    print("shared_programs", json.dumps(out), flush=True)


def run_incremental_graphed(device="cuda"):
    """Acetonitrile's B3LYP5 UKS with ``incremental_jk="on"`` as graphed
    programs against the same engine eager: within 1e-10 Ha in as many
    mixed-loop and polish cycles, at one cycle per replay (each cycle's
    variant a captured graph picked on the host) and at three (selected
    on the device with torch.where over both builds); the warm
    ``kernel()`` of each way graphed and eager."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import SCFEngine

    mol = build_molecule(ACETONITRILE, "sto-3g")
    out = {}
    for label, dispatch in (("host", None), ("chunk3", 3)):
        eng = SCFEngine(mol, xc="b3lyp5", incremental_jk="on", dispatch_cycles=dispatch,
                        device=device, **GRAPH_SCF)
        row = _hold_engine(f"incremental_graphed {label}", eng)
        _, warm = _timed(eng.kernel)
        eng.jit_kernel = "off"
        _, eager = _timed(eng.kernel)
        out[label] = {**{k: row[k] for k in ("cycles", "mixed_cycles", "captures", "capture_s",
                                              "replays", "de")},
                      "kernel_graph_warm_s": warm, "kernel_eager_warm_s": eager}
    print("incremental_graphed", json.dumps(out), flush=True)


def run_pfoa_warmup_graphed(driver):
    """pfoa's global DF-UKS with the float32 warm-up (exact float32 J/K
    through the fused kernel, float32 cuSOLVER eigh at n = 126) graphed
    against the same engine eager: within 1e-8 Ha of each other and of the
    driver's float64 energy, with equal warm-up and float64 cycles."""
    from nbed_tpu_torch.scf import SCFEngine

    ks = driver._ks_engine
    eng = SCFEngine(ks.mol, xc=ks.xc, conv_tol=ks.conv_tol, max_cycle=ks.max_cycle,
                    density_fitting=True, df_b=ks.df_b, warmup_f32=True,
                    max_memory_mb=ks.max_memory_mb, device="cuda")
    graphed = eng.kernel()
    run = dict(eng.last_run)
    eng.jit_kernel = "off"
    eager = eng.kernel()
    eager_run = dict(eng.last_run)
    _gate("pfoa_warmup_graphed", [("graph vs eager", graphed.e_tot, eager.e_tot),
                                  ("graph vs float64", graphed.e_tot,
                                   driver._global_ks.e_tot)], 1e-8)
    for key in ("warmup_cycles", "cycles"):
        if run[key] != eager_run[key]:
            raise RuntimeError(f"pfoa_warmup_graphed: graphed {key} {run[key]}, eager "
                               f"{eager_run[key]}")
    print("pfoa_warmup_graphed", json.dumps({
        "de": graphed.e_tot - eager.e_tot, "dev_vs_f64": graphed.e_tot - driver._global_ks.e_tot,
        **{k: run[k] for k in ("warmup_cycles", "cycles", "captures", "capture_s")}}),
        flush=True)


def run_water_tpss_kernel(device="cuda"):
    """TPSS and TPSSh on water on the card: the UKS energy within 1e-7 of
    nbed_tpu's, f_xc . t (``torch.func.jvp`` of the response closure along
    a seeded symmetric tangent) within 1e-6 relative of a central
    difference of vxc (h = 1e-4), and the TDA-TDDFT roots, finite and
    positive."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import SCFEngine
    from nbed_tpu_torch.solvers import run_tddft_tda

    mol = build_molecule(WATER.read_text(), "sto-3g")
    out = {}
    for xc in ("tpss", "tpssh"):
        eng = SCFEngine(mol, xc=xc, device=device, **WATER_SCF)
        sol = eng.kernel()
        _gate(f"water {xc}", [("e_tot", sol.e_tot, E_WATER[xc])], 1e-7)
        n = mol.nao
        t = np.random.default_rng(3).standard_normal((2, n, n))
        t = torch.tensor(0.5 * (t + t.swapaxes(-1, -2)), dtype=torch.float64, device=device)
        dm0 = sol.make_rdm1()
        response = eng._build_xc(torch.float64, differentiable=True)
        _, jvp = torch.func.jvp(lambda d: response(d)[1], (dm0,), (t,))
        h = 1e-4
        fd = (eng.xc_fn(dm0 + h * t)[1] - eng.xc_fn(dm0 - h * t)[1]) / (2 * h)
        miss = float((jvp - fd).abs().max() / fd.abs().max())
        _gate(f"water {xc} f_xc vs central difference", [("relative miss", miss, 0.0)], 1e-6)
        roots = run_tddft_tda(sol, nroots=4).excitations
        roots = np.asarray(torch.as_tensor(roots).cpu())
        if not (np.all(np.isfinite(roots)) and np.all(roots > 0)):
            raise RuntimeError(f"water {xc} TDA roots {roots}")
        out[xc] = {"e_tot": sol.e_tot, "fxc_miss": miss, "tda_roots": roots.tolist()}
    print("water_tpss_kernel", json.dumps(out), flush=True)


# --------------------------------------------------------------------------
# the remaining compiled programs: CCSD sweep and (T), grid and AO tables,
# TDA/RPA matvec blocks
# --------------------------------------------------------------------------

@contextmanager
def eager_programs():
    """Inside the block the CCSD sweep, (T) and the TDA/RPA matvec blocks
    run their programs' functions uncaptured, and the VQE, ADAPT and MP2
    solvers their eager routes (their private switches: the solvers have
    no public one, as the reference's jitted programs have none)."""
    from nbed_tpu_torch.solvers import ccsd, mp2, tddft, vqe

    ccsd._GRAPHED, tddft._GRAPHED, vqe._GRAPHED, mp2._GRAPHED = False, False, False, False
    try:
        yield
    finally:
        ccsd._GRAPHED, tddft._GRAPHED, vqe._GRAPHED, mp2._GRAPHED = True, "auto", True, True


def _program_counts(fn):
    """(fn(), wall seconds, the ops.programs.RUNS counts it added)."""
    from nbed_tpu_torch.ops.programs import RUNS

    before = dict(RUNS)
    out, wall = _timed(fn)
    return out, wall, {k: v - before.get(k, 0) for k, v in RUNS.items()
                       if v != before.get(k, 0)}


def hold_ccsd(label: str, h1, h2, occ, triples: bool = False) -> dict:
    """``run_ccsd`` graphed (the default on the card) against the same
    cycle function eager: within 1e-10 Ha (the (T) energy 1e-12) in as
    many cycles; a second graphed solve captures nothing. Returns the
    cycles, captures, capture seconds and both warm walls."""
    from nbed_tpu_torch.solvers import run_ccsd

    def solve():
        return run_ccsd(h1, h2, occ, conv_tol=1e-10, triples=triples)

    first, first_s, first_runs = _program_counts(solve)
    graphed, graph_s, graph_runs = _program_counts(solve)
    with eager_programs():
        solve()
        eager, eager_s, eager_runs = _program_counts(solve)
    pairs = [("e_corr", graphed[0], eager[0]), ("first e_corr", first[0], eager[0])]
    _gate(f"ccsd_graphed {label} graph vs eager", pairs, 1e-10)
    if triples:
        _gate(f"ccsd_graphed {label} (T) graph vs eager", [("e_t", graphed[1], eager[1])],
              1e-12)
    cycles = graph_runs.get("ccsd_cycles"), eager_runs.get("ccsd_cycles")
    if cycles[0] != cycles[1] or first_runs.get("ccsd_cycles") != cycles[1]:
        raise RuntimeError(f"ccsd_graphed {label}: graphed cycles {cycles[0]}, eager {cycles[1]}")
    if graph_runs.get("captures", 0):
        raise RuntimeError(f"ccsd_graphed {label}: a second solve captured "
                           f"{graph_runs['captures']} graphs")
    return {"cycles": cycles[0], "captures": first_runs.get("captures", 0),
            "capture_s": first_runs.get("capture_s", 0.0), "first_s": first_s,
            "warm_graph_s": graph_s, "warm_eager_s": eager_s,
            "host_reads": graph_runs.get("ccsd_host_reads", 0),
            "de": graphed[0] - eager[0], **({"de_t": graphed[1] - eager[1]} if triples else {})}


def run_ccsd_graphed(pfoa_driver, device="cuda"):
    """The CCSD sweep and (T) as CUDA-graph programs (``solvers.ccsd``)
    against their eager loops, from empty program caches: water's mu and
    Huzinaga embedded spaces, acetonitrile's 28-qubit Huzinaga space, and
    the CCSD(T) of pfoa's mu space (78 spin orbitals) and water_global."""
    from nbed_tpu_torch import nbed
    from nbed_tpu_torch.config import NbedConfig
    from nbed_tpu_torch.driver import NbedDriver
    from nbed_tpu_torch.ham import HamiltonianBuilder
    from nbed_tpu_torch.solvers import ccsd

    water = nbed(**CONFIGS["water"], device=device)
    aceto = nbed(**CONFIGS["acetonitrile"], device=device)
    glob = NbedDriver(NbedConfig(**CONFIGS["water_global"]), device=device)
    ccsd._SWEEP_PROGRAMS.clear()  # the drivers' solves captured theirs
    ccsd._TRIPLES_PROGRAMS.clear()
    out = {"sweep_cycles": ccsd.SWEEP_CYCLES}
    for label, sol, triples in (("water_mu", water.mu["scf"], False),
                                ("water_huzinaga", water.huzinaga["scf"], False),
                                ("acetonitrile_huzinaga", aceto.huzinaga["scf"], False),
                                ("pfoa_mu", pfoa_driver.mu["scf"], True),
                                ("water_global", glob._global_hf, True)):
        _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
        out[label] = hold_ccsd(label, h1, h2, _interleaved(sol), triples)
    print("ccsd_graphed", json.dumps(out), flush=True)


def hold_tables(label: str, mol, xc: str, device="cuda") -> dict:
    """The grid and AO tables of three engines of ``mol``: the first
    captures the "grid" and "aos" programs, a second takes them from the
    cache with no capture, both bitwise equal to an eager engine's
    (``jit_kernel="off"``); seconds of each (programs dropped earlier are
    collected before each clock starts)."""
    from nbed_tpu_torch.scf import SCFEngine

    def tables(**kw):
        gc.collect()
        eng = SCFEngine(mol, xc=xc, device=device, **kw)
        return _program_counts(lambda: (*eng._grid, *eng._ao_tables))

    first, first_s, first_runs = tables()
    second, second_s, second_runs = tables()
    eager, eager_s, _ = tables(jit_kernel="off")
    if not all(torch.equal(a, c) and torch.equal(b, c) for a, b, c in zip(first, second, eager)):
        raise RuntimeError(f"grid_programs {label}: graphed tables differ from eager")
    if second_runs.get("captures", 0) or not first_runs.get("aos_graph_captures"):
        raise RuntimeError(f"grid_programs {label}: captures {first_runs} then {second_runs}")
    return {"points": int(first[0].shape[0]), "captures": first_runs.get("captures", 0),
            "capture_s": first_runs.get("capture_s", 0.0), "first_s": first_s,
            "second_s": second_s, "second_captures": second_runs.get("captures", 0),
            "eager_s": eager_s, "ao_gb": (first[2].numel() + first[3].numel()) * 8 / 1e9}


def run_grid_programs(device="cuda"):
    """``SCFEngine._grid`` and ``_ao_tables`` as shared programs of
    ``_JIT_PROGRAM_CACHE`` (kinds "grid" and "aos") for water, the
    acetonitrile molecule and pfoa (383,890 points x 126 AOs), from an
    empty cache (:func:`hold_tables`)."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import engine

    engine._JIT_PROGRAM_CACHE.clear()
    out = {}
    for label, xyz, xc in (("water", WATER.read_text(), "b3lyp"),
                           ("acetonitrile", ACETONITRILE, "b3lyp5"),
                           ("pfoa", PFOA.read_text(), "b3lyp")):
        out[label] = hold_tables(label, build_molecule(xyz, "sto-3g"), xc, device)
    engine._JIT_PROGRAM_CACHE.clear()  # pfoa's tables are not a later phase's
    print("grid_programs", json.dumps(out), flush=True)


def hold_blocks(label: str, sol, rows: int, kinds=("tda", "apb", "amb"), seed: int = 1) -> dict:
    """The matvec blocks of ``kinds`` (TDA, A+B, A-B) of ``sol`` as graphed
    programs (padded to their fixed width) against the eager blocks on
    ``rows`` seeded trial vectors: within 1e-12, a second replay
    bitwise."""
    from nbed_tpu_torch.solvers import tddft

    fr = tddft._response_frame(sol)
    npairs = sum(fr["sizes"])
    x = torch.tensor(np.random.default_rng(seed).standard_normal((rows, npairs)),
                     dtype=torch.float64, device=sol.mo_coeff.device)
    out = {"npairs": npairs, "block": fr["block"]}
    for kind in kinds:
        graphed, first_s, runs = _program_counts(lambda: tddft._blockwise(fr, kind, x))
        again, warm_s = _timed(lambda: tddft._blockwise(fr, kind, x))
        with eager_programs():
            eager, eager_s = _timed(lambda: tddft._blockwise(fr, kind, x))
        dev = float(torch.max(torch.abs(graphed - eager)))
        _gate(f"{label} {kind} block graph vs eager", [("max |d|", dev, 0.0)], 1e-12)
        if not torch.equal(graphed, again):
            raise RuntimeError(f"{label} {kind}: two replays differ")
        out[kind] = {"dev": dev, "captures": runs.get("captures", 0),
                     "capture_s": runs.get("capture_s", 0.0), "first_s": first_s,
                     "warm_s": warm_s, "eager_s": eager_s}
    return out


def run_tddft_graphed(device="cuda"):
    """The TDA/RPA matvec blocks as CUDA-graph programs on acetonitrile's
    global B3LYP5 UKS: each block kind graphed against eager (1e-12), and
    a 6-root Davidson TDA graphed against eager (roots 1e-10) with its
    ``matvec_s``."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import SCFEngine
    from nbed_tpu_torch.solvers import run_tddft_tda

    mol = build_molecule(ACETONITRILE, "sto-3g")
    sol = SCFEngine(mol, xc="b3lyp5", device=device, **TIGHT_SCF).kernel()
    out = {"blocks": hold_blocks("tddft_graphed", sol, rows=7)}
    roots = {}
    for label in ("graph", "eager"):
        stats = {}
        if label == "eager":
            with eager_programs():
                res, wall = _timed(lambda: run_tddft_tda(sol, nroots=6, method="davidson",
                                                         stats=stats))
        else:
            res, wall = _timed(lambda: run_tddft_tda(sol, nroots=6, method="davidson",
                                                     stats=stats))
        roots[label] = res.excitations
        out[f"davidson_{label}"] = {"wall_s": wall, "matvec_s": stats["matvec_s"],
                                    "blocks": stats["matvec_blocks"],
                                    "iterations": stats["iterations"]}
    _gate("tddft_graphed Davidson graph vs eager",
          [(f"root {i}", a, b) for i, (a, b) in enumerate(zip(roots["graph"], roots["eager"]))],
          1e-10)
    print("tddft_graphed", json.dumps(out), flush=True)


# --------------------------------------------------------------------------
# the quantum end's programs: the VQE value and gradient, ADAPT's pool
# gradients and objective, MP2's contraction
# --------------------------------------------------------------------------

def _reserved_gb() -> float:
    """The caching allocator's reserved device memory, graph pools included
    (max_memory_allocated does not see them)."""
    return torch.cuda.memory_reserved() / 1e9


def _per_evaluation(runs: dict) -> dict:
    """Replays by program kind, captures and host reads per value-and-
    gradient of a run's RUNS counts."""
    n = runs.get("vqe_evaluations", 0)
    kinds = ("vqe_prep", "vqe_fwd", "vqe_energy", "vqe_bwd", "vqe_grad")
    return {"evaluations": n, "captures": runs.get("captures", 0),
            "capture_s": runs.get("capture_s", 0.0), "host_reads": runs.get("vqe_host_reads", 0),
            **{f"{k}_per_evaluation": runs.get(k, 0) / max(n, 1) for k in kinds}}


def run_vqe_graphed(water_registers: dict, pra_scf, device="cuda", n_mo: int = 10):
    """The VQE value and gradient as CUDA-graph programs (``solvers.vqe``)
    against the eager route (autograd through the adjoint sweep), from an
    empty program cache: ``run_vqe`` on water's mu and Huzinaga registers
    graphed (first call, then warm) and eager, with e_vqe equal to the bit
    in as many L-BFGS-B iterations and within 1e-6 of nbed_tpu's; on the
    20-qubit PRA register one value and gradient graphed against eager
    (1e-12 relative, one host read), and an L-BFGS-B run of at most 30
    iterations from the reference determinant that must go below it."""
    from nbed_tpu_torch.ham.qubit import _popcount
    from nbed_tpu_torch.solvers import run_vqe, vqe

    vqe._PROGRAMS.clear()
    out = {"sweep_chunk": vqe.SWEEP_CHUNK}
    for name, (sq, nelec) in water_registers.items():
        first, first_s, first_runs = _program_counts(lambda: run_vqe(*sq, nelec=nelec, device=device))
        graphed, graph_s, graph_runs = _program_counts(lambda: run_vqe(*sq, nelec=nelec, device=device))
        with eager_programs():
            eager, eager_s, _ = _program_counts(lambda: run_vqe(*sq, nelec=nelec, device=device))
        for label, res in (("first", first), ("warm", graphed)):
            if res.e_vqe != eager.e_vqe or res.n_iterations != eager.n_iterations:
                raise RuntimeError(f"vqe_graphed water {name} {label}: e_vqe {res.e_vqe} in "
                                   f"{res.n_iterations} iterations, eager {eager.e_vqe} in "
                                   f"{eager.n_iterations}")
        _gate(f"vqe_graphed water {name}", [("e_vqe", graphed.e_vqe, E_VQE_WATER[name])], 1e-6)
        if graph_runs.get("captures", 0) or graph_runs.get("vqe_host_reads") != \
                graph_runs.get("vqe_evaluations") + 1:
            raise RuntimeError(f"vqe_graphed water {name}: a warm run captured "
                               f"{graph_runs.get('captures', 0)}, host reads {graph_runs}")
        out[f"water_{name}"] = {
            "n_qubits": graphed.n_qubits, "n_strings": graphed.n_strings,
            "lbfgs_iterations": graphed.n_iterations, "e_vqe": graphed.e_vqe,
            "first_s": first_s, "warm_graph_s": graph_s, "warm_eager_s": eager_s,
            "first": _per_evaluation(first_runs), "warm": _per_evaluation(graph_runs)}

    cuda = torch.device(device)
    sq, nelec = pra_register(pra_scf, n_mo)
    psum, prog, psi0, n_params = vqe._ansatz_setup(*sq, nelec, "jw", None, cuda)
    thetas = 0.05 * np.random.default_rng(20).standard_normal(n_params)
    (e_eager, g_eager), eager_s = _timed(lambda: vqe._value_and_grad(thetas, psi0, prog))
    reserved_before = _reserved_gb()
    ap = vqe._vqe_program(prog, psi0)
    (e_first, g_first), first_s, first_runs = _program_counts(lambda: ap.value_and_grad(thetas))
    walls = []
    for _ in range(3):
        (e, g), wall, runs = _program_counts(lambda: ap.value_and_grad(thetas))
        walls.append(wall)
    rel_e = abs(e - e_eager) / abs(e_eager)
    rel_g = float(np.max(np.abs(g - g_eager)) / np.max(np.abs(g_eager)))
    if not (rel_e <= 1e-12 and rel_g <= 1e-12 and e_first == e
            and np.array_equal(g_first, g)):
        raise RuntimeError(f"vqe_graphed 20q: E {e} vs eager {e_eager} ({rel_e} relative), "
                           f"gradient {rel_g} relative; first call E {e_first}")
    if runs.get("captures", 0) or runs.get("vqe_host_reads") != 1:
        raise RuntimeError(f"vqe_graphed 20q: a warm value and gradient made {runs}")
    reserved_after = _reserved_gb()

    hf = int(torch.argmax(psi0))
    e_hf = sum(c.real * (1 - 2 * (_popcount(hf & z) & 1))
               for (x, z), c in psum.terms.items() if x == 0)
    res, lbfgs_s, lbfgs_runs = _program_counts(lambda: run_vqe(*sq, nelec=nelec, maxiter=30,
                                                             device=device))
    _gate("vqe_graphed 20q", [("e_reference vs <HF|H|HF>", res.e_reference, e_hf)], 1e-9)
    if not (np.isfinite(res.e_vqe) and res.e_vqe < e_hf - 1e-4):
        raise RuntimeError(f"vqe_graphed 20q: L-BFGS-B e_vqe {res.e_vqe} not below "
                           f"<HF|H|HF> {e_hf}")
    n_eval = lbfgs_runs.get("vqe_evaluations", 0)
    out["vqe_20q"] = {
        "n_qubits": psum.n_qubits, "n_params": n_params, "n_strings": len(prog.strings),
        "n_hamiltonian_blocks": len(prog.blocks), "sweep_chunk": ap.k,
        "chunks_each_way": ap.n_chunks, "value_and_grad_eager_s": eager_s,
        "value_and_grad_first_s": first_s, "value_and_grad_graph_s": walls,
        "first": _per_evaluation(first_runs), "warm": _per_evaluation(runs),
        "de_rel": rel_e, "dg_rel": rel_g, "bitwise": bool(e == e_eager and
                                                          np.array_equal(g, g_eager)),
        "reserved_gb_before": reserved_before, "reserved_gb_after": reserved_after,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "lbfgs": {"maxiter": 30, "iterations": res.n_iterations, "evaluations": n_eval,
                  "wall_s": lbfgs_s, "s_per_evaluation": lbfgs_s / max(n_eval, 1),
                  "e_vqe": res.e_vqe, "e_hf": e_hf, "captures": lbfgs_runs.get("captures", 0)}}
    print("vqe_graphed", json.dumps(out), flush=True)


def run_adapt_graphed(water_sq, water_nelec, pra_scf, device="cuda", n_mo: int = 10):
    """ADAPT-VQE's pool gradients and per-step objective as programs:
    water's mu register (10 qubits) graphed against eager (energies within
    1e-10, the same operators), with as many captures as a run stopped
    after its first step (none after it) and the energy within 1e-6 of
    nbed_tpu's; one pool gradient of the 20-qubit PRA register's pool at a
    grown ansatz graphed against eager (1e-12 relative)."""
    from nbed_tpu_torch.solvers import run_adapt_vqe, vqe

    vqe._PROGRAMS.clear()
    _, one_s, one_runs = _program_counts(
        lambda: run_adapt_vqe(*water_sq, nelec=water_nelec, max_ops=1, device=device))
    vqe._PROGRAMS.clear()
    graphed, graph_s, graph_runs = _program_counts(
        lambda: run_adapt_vqe(*water_sq, nelec=water_nelec, device=device))
    warm, warm_s, warm_runs = _program_counts(
        lambda: run_adapt_vqe(*water_sq, nelec=water_nelec, device=device))
    with eager_programs():
        eager, eager_s, _ = _program_counts(lambda: run_adapt_vqe(*water_sq, nelec=water_nelec, device=device))
    late = graph_runs.get("captures", 0) - one_runs.get("captures", 0)
    if late or warm_runs.get("captures", 0):
        raise RuntimeError(f"adapt_graphed: {late} captures after the first step, "
                           f"{warm_runs.get('captures', 0)} in a warm run")
    if graphed.op_indices != eager.op_indices or warm.op_indices != eager.op_indices:
        raise RuntimeError(f"adapt_graphed: operators {graphed.op_indices} graphed, "
                           f"{eager.op_indices} eager")
    _gate("adapt_graphed water mu graph vs eager", [
        ("e_vqe", graphed.e_vqe, eager.e_vqe), ("warm e_vqe", warm.e_vqe, eager.e_vqe)]
        + [(f"step {i} e", a[2], b[2]) for i, (a, b) in
           enumerate(zip(graphed.history, eager.history))], 1e-10)
    _gate("adapt_graphed water mu", [("e_vqe", graphed.e_vqe, E_ADAPT_WATER_MU)], 1e-6)
    if not graphed.converged:
        raise RuntimeError(f"adapt_graphed: not converged, max gradient {graphed.max_gradient}")
    out = {"water_mu": {
        "n_qubits": graphed.n_qubits, "n_ops": len(graphed.op_indices),
        "op_indices": graphed.op_indices, "e_vqe": graphed.e_vqe,
        "captures_first_step_only": one_runs.get("captures", 0),
        "captures": graph_runs.get("captures", 0), "captures_after_first_step": late,
        "first_step_only_s": one_s, "graph_s": graph_s, "warm_graph_s": warm_s,
        "eager_s": eager_s, "evaluations": graph_runs.get("vqe_evaluations", 0),
        "pool_gradients": graph_runs.get("adapt_grads", 0),
        "host_reads": graph_runs.get("vqe_host_reads", 0)}}

    cuda = torch.device(device)
    sq, nelec = pra_register(pra_scf, n_mo)
    _, pool_prog, psi0, n_pool = vqe._ansatz_setup(*sq, nelec, "jw", None, cuda)
    vqe._PROGRAMS.clear()
    ap = vqe._adapt_program(pool_prog, psi0, max_ops=60)
    g0, first_s, first_runs = _program_counts(lambda: ap.pool_gradients(np.zeros(0)))
    ops = [int(k) for k in np.argsort(-np.abs(g0))[:4]]
    n_qubits = pool_prog.cols.shape[0].bit_length() - 1
    ladder = vqe._ladder_factory("jw", n_qubits)
    pool = vqe.uccsd_excitations(n_qubits, nelec)[1]
    ansatz = vqe._derived(pool_prog, [vqe._generator_strings(pool[k], ladder) for k in ops])
    ap.load_ansatz(ansatz)
    thetas = 0.05 * np.random.default_rng(21).standard_normal(len(ops))
    ap.pool_gradients(thetas)
    grads, graph_s, runs = _program_counts(lambda: ap.pool_gradients(thetas))

    def eager_pool():
        with torch.no_grad():
            psi = vqe._Sweep.apply(torch.as_tensor(thetas, device=cuda), psi0, ansatz)
            return vqe._pool_gradients(pool_prog, psi).cpu().numpy()

    eager_pool()
    want, eager_s = _timed(eager_pool)
    rel = float(np.max(np.abs(grads - want)) / np.max(np.abs(want)))
    if not rel <= 1e-12 or runs.get("captures", 0) or runs.get("vqe_host_reads") != 1:
        raise RuntimeError(f"adapt_graphed 20q pool gradient: {rel} relative to eager, "
                           f"runs {runs}")
    out["pool_20q"] = {
        "n_qubits": n_qubits, "n_pool": n_pool,
        "n_pool_strings": len(pool_prog.strings), "pool_chunk": ap.pool_chunk,
        "pool_chunks": ap.pool_chunks, "ops": ops, "first_s": first_s,
        "first_captures": first_runs.get("captures", 0), "graph_s": graph_s,
        "eager_s": eager_s, "dg_rel": rel, "bitwise": bool(np.array_equal(grads, want)),
        "replays": runs.get("replays", 0), "reserved_gb": _reserved_gb()}
    print("adapt_graphed", json.dumps(out), flush=True)


def run_mp2_graphed(pfoa_driver, device="cuda"):
    """MP2's contraction as a CUDA-graph program (``solvers.mp2``) against
    the eager contraction (1e-12), from an empty cache: water_global's HF
    (14 spin orbitals) and pfoa's mu-embedded space (78); a second call
    captures nothing."""
    from nbed_tpu_torch.config import NbedConfig
    from nbed_tpu_torch.driver import NbedDriver
    from nbed_tpu_torch.ham import HamiltonianBuilder
    from nbed_tpu_torch.solvers import mp2, run_mp2

    glob = NbedDriver(NbedConfig(**CONFIGS["water_global"]), device=device)
    mp2._PROGRAMS.clear()
    out = {}
    for label, sol in (("water_global", glob._global_hf), ("pfoa_mu", pfoa_driver.mu["scf"])):
        _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
        occ = _interleaved(sol)
        (e_first, _), first_s, first_runs = _program_counts(lambda: run_mp2(h1, h2, occ))
        (e2, e_hf), graph_s, runs = _program_counts(lambda: run_mp2(h1, h2, occ))
        with eager_programs():
            run_mp2(h1, h2, occ)
            (e_eager, _), eager_s, _ = _program_counts(lambda: run_mp2(h1, h2, occ))
        _gate(f"mp2_graphed {label} graph vs eager", [("e_mp2", e2, e_eager),
                                                      ("first e_mp2", e_first, e_eager)], 1e-12)
        if runs.get("captures", 0) or runs.get("mp2") != 1 or not e2 < 0:
            raise RuntimeError(f"mp2_graphed {label}: E(2) {e2}, a second call made {runs}")
        out[label] = {"n_spin_orbitals": int(h1.shape[0]), "n_occ": int(occ.sum()),
                      "e_mp2": e2, "e_hf_elec": e_hf, "de": e2 - e_eager,
                      "captures": first_runs.get("captures", 0), "first_s": first_s,
                      "warm_graph_s": graph_s, "warm_eager_s": eager_s}
    print("mp2_graphed", json.dumps(out), flush=True)


def build_all():
    """Build the CUDA kernel library, the cuSOLVER eigh library, the FCI
    sector-matrix kernel and the two host C++ libraries, each compiler
    started at once."""
    from concurrent.futures import ThreadPoolExecutor

    from nbed_tpu_torch._compile import native_integrals_library, qubit_terms_library
    from nbed_tpu_torch.ops import eigh, eri, fci_hamiltonian, jk

    with ThreadPoolExecutor(max_workers=6) as pool:
        futures = [pool.submit(f) for f in (jk.build_kernels, eigh.build_library,
                                            fci_hamiltonian.build_library, eri.build_library,
                                            native_integrals_library, qubit_terms_library)]
        for f in futures:
            f.result()


# kernels each phase's path must launch (counted from 0 for each phase);
# the DF and statevector phases have none: DF J/K, the VQE sweep and
# ADAPT's pool gradients are torch ops (graphed), as they are XLA in the
# reference. Since the engines graph
# their SCFs on the card, every phase of engine SCFs launches the cuSOLVER
# eigh from inside its graphs
F64 = ("fused_jk_f64", "eigh_f64")
MIXED = ("fused_jk_f64", "fused_jk_f32", "eigh_f64", "eigh_f32")
# the lane programs: the lane/slab entry (B > 1 or R < M) inside graphs
LANES = ("fused_jk_f64", "lanes", "eigh_f64")
# the incremental SCF's float32 J/K of density changes inside graphs
INCREMENTAL = ("fused_jk_f32", "eigh_f64")
# the embedded or global FCI of integrals on the card: the sector-matrix
# kernel, eager, once per run_fci
FCI = ("fci_hamiltonian",)
# the phases of the post-SCF, derivatives, parallel, compiled-program,
# shared-program, remaining-program, quantum-end and derivative-program
# slices, summarised at the end
NEW_PHASES = ("water_global", "acetonitrile_post", "h2_stability", "water_qse", "pfoa_post",
              "water_derivatives", "acetonitrile_derivatives", "water_ccpvdz_gradient",
              "water_fleet", "water_fleet_gradients", "water_embed_fleet",
              "embed_tangents_graphed", "sharded",
              "pfoa_sharded", "graphed_scf", "hessian_mesh", "shared_programs",
              "incremental_graphed", "water_tpss_kernel", "pfoa_incremental",
              "pfoa_warmup_graphed", "grid_programs", "tddft_graphed", "ccsd_graphed",
              "vqe_graphed", "adapt_graphed", "mp2_graphed", "derivatives_graphed")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    from nbed_tpu_torch.ops import eigh, fci_hamiltonian, jk
    from nbed_tpu_torch.ops import eri as md_eri
    from nbed_tpu_torch.scf import engine
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
    t0 = time.perf_counter()
    lane_rows = check_lane_kernels()
    phase_s["lane_kernel_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eigh_rows = check_eigh()
    phase_s["eigh_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fci_rows = check_fci_hamiltonian()
    phase_s["fci_hamiltonian_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check_fci_direct()
    phase_s["fci_direct_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fci_acetonitrile = check_fci_acetonitrile()
    phase_s["fci_acetonitrile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eri_rows = check_md_eri()
    phase_s["md_eri_check"] = time.perf_counter() - t0

    # each pipeline is a cold run (its atoms' SAD SCFs included), with the
    # launch counts set to 0 just before it and read just after
    f64, keep = {}, {}
    per_phase, by_m, by_shape, peak_gb, runs = {}, {}, {}, {}, {}

    def count(name):
        per_phase[name] = {**jk.LAUNCHES, **eigh.LAUNCHES, **fci_hamiltonian.LAUNCHES,
                           **md_eri.LAUNCHES, "lanes": lane_launches()}
        runs[name] = dict(engine.RUNS)
        for (key, m, r, b), n in jk.LAUNCHES_BY_SHAPE.items():
            by_m[f"{key} M={m}"] = by_m.get(f"{key} M={m}", 0) + n
            label = f"{key} M={m} R={r} B={b}"
            by_shape[label] = by_shape.get(label, 0) + n

    def clear():
        jk.LAUNCHES.clear()
        jk.LAUNCHES_BY_SHAPE.clear()
        eigh.LAUNCHES.clear()
        fci_hamiltonian.LAUNCHES.clear()
        md_eri.LAUNCHES.clear()
        engine.RUNS.clear()

    def remember(name, driver):
        if name in ("water", "acetonitrile"):
            f64[name] = pipeline_energies(driver)
        elif name == "acetonitrile_derivatives":
            keep["hessian_pra"] = driver
        elif name == "acetonitrile_taper":
            keep["pra_scf"] = driver.huzinaga["scf"]
        elif name == "water_vqe":
            occ = driver.mu["scf"].mo_occ.cpu().numpy()
            nelec = (int(occ[0].sum()), int(occ[1].sum()))
            keep["water"] = (driver.mu["second_quantised"], nelec)
            hocc = driver.huzinaga["scf"].mo_occ.cpu().numpy()
            keep["water_registers"] = {
                "mu": (driver.mu["second_quantised"], nelec),
                "huzinaga": (driver.huzinaga["second_quantised"],
                             (int(hocc[0].sum()), int(hocc[1].sum())))}
            keep["water_qse"] = (driver.mu["second_quantised"], nelec,
                                 driver.mu["vqe"].params, driver.mu["e_vqe"])

    phases = (
        ("water_fleet", run_water_fleet, LANES),
        ("water_fleet_gradients", run_water_fleet_gradients, LANES),
        ("water_embed_fleet", run_water_embed_fleet, LANES),
        ("embed_tangents_graphed", run_embed_tangents_graphed, LANES),
        ("sharded", run_sharded, LANES),
        ("water", run_water, F64 + FCI),
        ("water_mixed", lambda: run_mixed("water", f64["water"]), MIXED + FCI),
        ("acetonitrile", run_acetonitrile, F64),
        ("acetonitrile_mixed", lambda: run_mixed("acetonitrile", f64["acetonitrile"]),
         MIXED),
        ("acetonitrile_taper", run_acetonitrile_taper, F64),
        ("water_vqe", run_water_vqe, F64 + FCI),
        ("vqe_20q", lambda: run_vqe_20q(keep["pra_scf"], *keep["water"]), ()),
        ("vqe_graphed", lambda: run_vqe_graphed(keep.pop("water_registers"),
                                                keep["pra_scf"]), ()),
        ("adapt_graphed", lambda: run_adapt_graphed(*keep.pop("water"), keep.pop("pra_scf")),
         ()),
        ("water_qse", lambda: run_water_qse(*keep.pop("water_qse")), FCI),
        ("water631g_localizers", run_water631g_localizers, F64),
        ("acetonitrile_pao", run_acetonitrile_pao, F64),
        ("acetonitrile_cis", run_acetonitrile_cis, F64),
        ("water_global", run_water_global, F64 + FCI),
        ("acetonitrile_post", run_acetonitrile_post, F64),
        ("h2_stability", run_h2_stability, F64),
        ("water_derivatives", run_water_derivatives, LANES),
        ("acetonitrile_derivatives", run_acetonitrile_derivatives, LANES),
        ("derivatives_graphed", run_derivatives_graphed, LANES),
        ("water_ccpvdz_gradient", run_water_ccpvdz_gradient, F64),
        ("shared_programs", run_shared_programs, F64),
        ("incremental_graphed", run_incremental_graphed, INCREMENTAL),
        ("grid_programs", run_grid_programs, ()),
        ("tddft_graphed", run_tddft_graphed, F64),
        ("water_tpss_kernel", run_water_tpss_kernel, F64),
        ("water_functionals", run_water_functionals, F64),
        ("methyl_rohf", run_methyl_rohf, F64), ("water_qmmm", run_water_qmmm, F64),
        ("acetonitrile_camb3lyp", run_acetonitrile_camb3lyp, F64),
        ("pfoa_wb97x", run_pfoa_wb97x, F64), ("pfoa", run_pfoa, F64),
    )
    for name, run, needs in phases:
        driver = None  # the previous pipeline's memory is not this one's peak
        _atomic_density.cache_clear()
        torch.cuda.reset_peak_memory_stats()
        clear()
        t0 = time.perf_counter()
        driver = run()
        phase_s[name] = time.perf_counter() - t0
        count(name)
        peak_gb[name] = torch.cuda.max_memory_allocated() / 1e9
        missing = [k for k in needs if not per_phase[name].get(k, 0)]
        if missing:
            raise RuntimeError(f"the {name} pipeline ran without launching {missing}")
        remember(name, driver)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    check_pfoa_df_and_xc(driver)  # the pfoa driver, run last
    phase_s["pfoa_df_xc_check"] = time.perf_counter() - t0
    peak_gb["pfoa_df_xc_check"] = torch.cuda.max_memory_allocated() / 1e9

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    check_pfoa_one_electron(driver)
    phase_s["pfoa_one_electron"] = time.perf_counter() - t0
    peak_gb["pfoa_one_electron"] = torch.cuda.max_memory_allocated() / 1e9

    # pfoa's incremental DF SCF, graphed: its float32 J/K of density
    # changes is DF (plain torch), so its graphs launch the eigh only
    torch.cuda.reset_peak_memory_stats()
    clear()
    t0 = time.perf_counter()
    run_pfoa_incremental(driver)
    phase_s["pfoa_incremental"] = time.perf_counter() - t0
    count("pfoa_incremental")
    peak_gb["pfoa_incremental"] = torch.cuda.max_memory_allocated() / 1e9
    if not per_phase["pfoa_incremental"].get("eigh_f64"):
        raise RuntimeError("the pfoa_incremental phase ran without launching eigh_f64")

    # pfoa's float32 warm-up graphed against eager: exact float32 J/K
    torch.cuda.reset_peak_memory_stats()
    clear()
    t0 = time.perf_counter()
    run_pfoa_warmup_graphed(driver)
    phase_s["pfoa_warmup_graphed"] = time.perf_counter() - t0
    count("pfoa_warmup_graphed")
    peak_gb["pfoa_warmup_graphed"] = torch.cuda.max_memory_allocated() / 1e9
    missing = [k for k in MIXED if not per_phase["pfoa_warmup_graphed"].get(k, 0)]
    if missing:
        raise RuntimeError(f"the pfoa_warmup_graphed phase ran without launching {missing}")

    # the post-SCF slice on the pfoa driver: DF throughout, so no fused
    # J/K launch is expected; its count is read all the same
    torch.cuda.reset_peak_memory_stats()
    clear()
    t0 = time.perf_counter()
    run_pfoa_post(driver)
    phase_s["pfoa_post"] = time.perf_counter() - t0
    count("pfoa_post")
    peak_gb["pfoa_post"] = torch.cuda.max_memory_allocated() / 1e9

    # the CCSD sweep and (T) as graphs against eager, pfoa's mu space among
    # them: the DIIS eigh launches inside the sweep's graphs
    torch.cuda.reset_peak_memory_stats()
    clear()
    t0 = time.perf_counter()
    run_ccsd_graphed(driver)
    phase_s["ccsd_graphed"] = time.perf_counter() - t0
    count("ccsd_graphed")
    peak_gb["ccsd_graphed"] = torch.cuda.max_memory_allocated() / 1e9
    if not per_phase["ccsd_graphed"].get("eigh_f64"):
        raise RuntimeError("the ccsd_graphed phase ran without launching eigh_f64")

    # MP2's contraction as a graph against eager, pfoa's mu space among them
    torch.cuda.reset_peak_memory_stats()
    clear()
    t0 = time.perf_counter()
    run_mp2_graphed(driver)
    phase_s["mp2_graphed"] = time.perf_counter() - t0
    count("mp2_graphed")
    peak_gb["mp2_graphed"] = torch.cuda.max_memory_allocated() / 1e9

    # the split DF-UKS at pfoa's size: DF J/K and XC, no fused J/K launch
    torch.cuda.reset_peak_memory_stats()
    clear()
    t0 = time.perf_counter()
    run_pfoa_sharded(driver)
    phase_s["pfoa_sharded"] = time.perf_counter() - t0
    count("pfoa_sharded")
    peak_gb["pfoa_sharded"] = torch.cuda.max_memory_allocated() / 1e9

    # the graphed SCF programs, pfoa's on the pfoa driver's factor
    torch.cuda.reset_peak_memory_stats()
    clear()
    t0 = time.perf_counter()
    run_graphed_scf(driver)
    phase_s["graphed_scf"] = time.perf_counter() - t0
    count("graphed_scf")
    peak_gb["graphed_scf"] = torch.cuda.max_memory_allocated() / 1e9
    missing = [k for k in F64 if not per_phase["graphed_scf"].get(k, 0)]
    if missing:
        raise RuntimeError(f"the graphed_scf phase ran without launching {missing}")

    # the acetonitrile Hessian's lanes in two groups of a mesh
    torch.cuda.reset_peak_memory_stats()
    clear()
    t0 = time.perf_counter()
    run_hessian_mesh(keep.pop("hessian_pra"))
    phase_s["hessian_mesh"] = time.perf_counter() - t0
    count("hessian_mesh")
    peak_gb["hessian_mesh"] = torch.cuda.max_memory_allocated() / 1e9
    if not per_phase["hessian_mesh"]["lanes"]:
        raise RuntimeError("the hessian_mesh phase ran without a lane launch")
    for name in NEW_PHASES:
        print(f"{name}_summary", json.dumps({"s": phase_s[name], "peak_gb": peak_gb[name],
                                             "fused_jk": per_phase[name]}), flush=True)
    # how each phase's SCFs ran: graphed and eager kernel() calls, replays,
    # host reads, captures and their seconds, SCF cycles
    print(f"scf runs: {json.dumps(runs)}", flush=True)
    print(f"fused_jk and eigh launches: {json.dumps(per_phase)}", flush=True)
    print(f"fused_jk launches by M: {json.dumps(by_m)}", flush=True)
    print(f"fused_jk launches by (dtype, M, R, B): {json.dumps(by_shape)}", flush=True)
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
            "ms_stream": main_row["ms_stream"], "host_us": main_row["host_us"],
            "kernel_device_us": main_row["kernel_device_us"],
            "m": main_row["m"], "dtype": dtype, "path": main_row["path"],
        })
    # the lane/slab entry of the same kernel at the acetonitrile Hessian's
    # shape (B = 36 lanes of M = 324), the largest batch of the main path
    lane_row = next(r for r in lane_rows if r["batch"] == 36 and r["dtype"] == "float64")
    kernels.append({
        "name": "fused_jk_lanes_f64", "route": "cuda",
        "source": "nbed_tpu_torch/csrc/fused_jk.cu",
        "replaces": "nbed_tpu/ops/pallas_jk.py:82",
        "launches": sum(c.get("lanes", 0) for c in per_phase.values()),
        "max_abs_err": max(r["max_abs_err"] for r in lane_rows if r["dtype"] == "float64"),
        **{k: lane_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "ms_stream", "host_us", "kernel_device_us", "m", "rows",
                                    "batch", "dtype", "path")},
    })
    # the capturable eigh at acetonitrile's Fock shape (both spins, n = 18),
    # in float64 and in the float32 warm-up's
    for dtype in ("float64", "float32"):
        name = f"eigh_{dtype[0]}{dtype[-2:]}"
        row = next(r for r in eigh_rows if r["n"] == 18 and r["dtype"] == dtype)
        kernels.append({
            "name": name, "route": "cuda", "source": "nbed_tpu_torch/csrc/eigh.cu",
            "replaces": "nbed_tpu/scf/hf.py:63",
            "launches": sum(c.get(name, 0) for c in per_phase.values()),
            "max_abs_err": max(r["max_abs_err"] for r in eigh_rows if r["dtype"] == dtype),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "ms_stream", "host_us", "kernel_device_us", "n", "batch",
                                   "dtype")},
        })
    # the FCI sector matrix at water's embedded mu sector (D = 100)
    row = next(r for r in fci_rows if r["dim"] == 100)
    kernels.append({
        "name": "fci_hamiltonian", "route": "cuda",
        "source": "nbed_tpu_torch/csrc/fci_hamiltonian.cu",
        "replaces": "nbed_tpu/solvers/fci.py:60",
        "launches": sum(c.get("fci_hamiltonian", 0) for c in per_phase.values()),
        "max_abs_err": max(r["max_abs_err"] for r in fci_rows),
        "library_ms": None,
        # the plain version: the host oracle, sector_hamiltonian(...).toarray()
        "plain_ms": row["oracle_ms"],
        **{k: row[k] for k in ("ms", "bound_ms", "bound_by", "ms_stream",
                               "kernel_device_us", "dim")},
    })
    # the matrix-free product's gather and scatter on acetonitrile's
    # published 28-qubit sector (six blocks of 620 alpha rows); launches of
    # one warm nbed() request, counted from 0
    kernels.append({
        "name": "fci_sigma", "route": "cuda", "source": "nbed_tpu_torch/csrc/fci_sigma.cu",
        "replaces": None, "launches": fci_acetonitrile["launches_warm"],
        "rel_err": fci_acetonitrile["rel_err"],
        **{k: fci_acetonitrile[k] for k in ("sigma_ms", "gather_device_us",
                                            "scatter_device_us", "dim", "block_rows")},
    })
    # the ERI tensor of one acetonitrile request and of the fleet's 36 lanes;
    # launches summed over the phases
    for row in eri_rows:
        kernels.append({
            "name": f"md_eri B={row['batch']}", "route": "cuda",
            "source": "nbed_tpu_torch/csrc/md_eri.cu", "replaces": None,
            "launches": sum(c.get("md_eri", 0) for c in per_phase.values()),
            "library_ms": None,
            **{k: row[k] for k in ("ms", "plain_ms", "host_ms", "bound_ms", "bound_by",
                                   "ms_stream", "kernel_device_us", "roofline_pct",
                                   "max_abs_err", "nao", "batch", "quartets")},
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
