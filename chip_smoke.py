"""Smoke run of nbed_tpu_torch on one CUDA card.

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, then drives the embedding
pipeline end to end through ``nbed_tpu_torch.nbed(..., device="cuda")`` on
water (both projectors, CCSD and FCI) and on the acetonitrile
configuration of the PRA 109, 022418 notebook (28-qubit embedded
register), and checks the energies against the reference values.

    python3 chip_smoke.py

Every phase raises on failure. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launches in the pipeline runs, its error against the plain version and
both times. Exits non-zero, printing no result, where CUDA is unavailable.
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

WATER = Path(__file__).resolve().parent / "tests" / "molecules" / "water.xyz"

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
    supermatrices of water and acetonitrile STO-3G, and seeded random
    symmetric ones at nao = 64."""
    from nbed_tpu_torch.chem import build_molecule
    from nbed_tpu_torch.scf import SCFEngine

    rng = np.random.default_rng(11)
    cases = []
    for label, xyz in (("water", WATER.read_text()), ("acetonitrile", ACETONITRILE)):
        eng = SCFEngine(build_molecule(xyz, "sto-3g"), device="cuda")
        n = eng.mol.nao
        dm = rng.standard_normal((2, n, n))
        dm = 0.5 * (dm + dm.swapaxes(-1, -2))
        cases.append((label, eng.eri_j, eng.eri_k,
                      torch.tensor(dm, dtype=torch.float64, device="cuda")))
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


def run_water():
    from nbed_tpu_torch import nbed

    t0 = time.perf_counter()
    driver = nbed(geometry=str(WATER), n_active_atoms=1, basis="STO-3G",
                  xc_functional="b3lyp", projector="both", localization="spade",
                  convergence=1e-6, run_ccsd_emb=True, run_fci_emb=True,
                  device="cuda")
    wall = time.perf_counter() - t0
    e_uks = driver._global_ks.e_tot
    if abs(e_uks - E_UKS_WATER) > 2e-7:
        raise RuntimeError(f"water global UKS {e_uks} vs oracle {E_UKS_WATER}")
    for name, res in (("mu", driver.mu), ("huzinaga", driver.huzinaga)):
        for key, oracle in (("e_ccsd", E_CCSD_WATER), ("e_fci", E_FCI_WATER)):
            if not np.isfinite(res[key]) or abs(res[key] - oracle) > 1e-5:
                raise RuntimeError(f"water {name} {key} {res[key]} vs oracle {oracle}")
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


def run_acetonitrile():
    from nbed_tpu_torch import nbed

    t0 = time.perf_counter()
    driver = nbed(geometry=ACETONITRILE, n_active_atoms=2, basis="STO-3G",
                  xc_functional="b3lyp5", projector="huzinaga",
                  localization="spade", convergence=1e-6, run_ccsd_emb=True,
                  device="cuda")
    wall = time.perf_counter() - t0
    res = driver.huzinaga
    qubits = res["second_quantised"][1].shape[0]
    if qubits != 28:
        raise RuntimeError(f"acetonitrile embedded register {qubits} qubits, expected 28")
    for key, ref in (("e_rhf", E_RHF_PRA), ("e_ccsd", E_CCSD_PRA)):
        if not np.isfinite(res[key]) or abs(res[key] - ref) > 1e-6:
            raise RuntimeError(f"acetonitrile {key} {res[key]} vs nbed_tpu {ref}")
    print("acetonitrile", json.dumps({
        "wall_s": wall, "qubits": qubits, "e_rhf": res["e_rhf"],
        "e_ccsd": res["e_ccsd"], "stages_s": driver.timings}), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    from nbed_tpu_torch._reference_files import native_integrals_library
    from nbed_tpu_torch.ops import jk

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    jk.build_kernels()
    native_integrals_library()
    print(f"build_s {time.perf_counter() - t0:.3f}", flush=True)

    rows = check_kernels()

    jk.LAUNCHES.clear()
    run_water()
    water_launches = jk.LAUNCHES["fused_jk"]
    run_acetonitrile()
    launches = jk.LAUNCHES["fused_jk"]
    print(f"fused_jk launches: water {water_launches}, "
          f"acetonitrile {launches - water_launches}", flush=True)
    if water_launches == 0 or launches == water_launches:
        raise RuntimeError("the pipeline ran without launching fused_jk")

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
