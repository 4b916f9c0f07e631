"""Where the time goes in one nbed_tpu_torch embedding on a CUDA card.

    python3 scripts/profile_port.py [NAME] [--jit-kernel auto|off]    (default pfoa, auto)

NAME is a key of ``chip_smoke.CONFIGS``: water, acetonitrile, pfoa,
water_qmmm, acetonitrile_camb3lyp, pfoa_wb97x, the float32 warm-up
configurations water_mixed and acetonitrile_mixed, acetonitrile_taper (JW
mapping and Z2 tapering) or water_vqe (embedded VQE and DFT-in-DFT). Runs
that configuration once cold,
then profiles a second ``nbed()`` call in the same process (SAD atoms and,
with density fitting, the DF factor recomputed; kernels already built) and
the global SCF alone at the built engine, each with
``nbed_tpu_torch.profiling.device_profile``: host wall time, device busy
time (self device time of every kernel and copy, summed), device idle share
and event count. With density fitting it also times the three-centre
integrals on every core of the process's affinity mask and on one core, in
the same process, and reports the seconds of each DF factor's build (the
long-range one too, under range separation) with their share of the
profiled call. Prints the card's name and power limit first, then one
labelled JSON object per measurement; the profiled call's line carries
its fused J/K and eigh launches by dtype (``fused_jk_f64``,
``fused_jk_f32``, ``eigh_f64``, ``eigh_f32``) and how its SCFs ran
(``nbed_tpu_torch.scf.engine.RUNS``). ``--jit-kernel`` sets the driver's
engines' ``jit_kernel``: "auto" graphs their SCFs on the card (the
default), "off" runs them eagerly.
"""

import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import CONFIGS, card_line, driver_engines  # noqa: E402
from nbed_tpu_torch import nbed  # noqa: E402
from nbed_tpu_torch.chem.basis.auxiliary import make_auxiliary_molecule  # noqa: E402
from nbed_tpu_torch.integrals import native  # noqa: E402
from nbed_tpu_torch.ops import eigh, jk  # noqa: E402
from nbed_tpu_torch.profiling import device_profile  # noqa: E402
from nbed_tpu_torch.scf.engine import RUNS, _atomic_density  # noqa: E402


def show(label, obj):
    print(label, json.dumps(obj), flush=True)


def timed_eri_3c(mol, aux, cpus) -> float:
    """Seconds of ``native.eri_3c`` with the process pinned to ``cpus``
    (it runs one thread per core of the affinity mask)."""
    saved = os.sched_getaffinity(0)
    os.sched_setaffinity(0, cpus)
    try:
        t0 = time.perf_counter()
        native.eri_3c(mol, aux)
        return time.perf_counter() - t0
    finally:
        os.sched_setaffinity(0, saved)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_port.py: torch.cuda.is_available() is False")
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", default="pfoa")
    ap.add_argument("--jit-kernel", default="auto", choices=("auto", "off"))
    args = ap.parse_args()
    config = CONFIGS[args.name]
    print(card_line(), flush=True)
    jk.build_kernels()
    with driver_engines(args.jit_kernel):
        profile(config)


def profile(config):
    t0 = time.perf_counter()
    driver = nbed(**config, device="cuda")
    show("cold", {"wall_s": time.perf_counter() - t0, "stages_s": driver.timings})

    _atomic_density.cache_clear()
    jk.LAUNCHES.clear()
    eigh.LAUNCHES.clear()
    RUNS.clear()
    driver, summary = device_profile(lambda: nbed(**config, device="cuda"))
    launches = {**jk.LAUNCHES, **eigh.LAUNCHES}
    runs = dict(RUNS)
    ks = driver._ks_engine
    factor_s = {"df_build_s": ks.df_timings, "df_lr_build_s": ks.df_lr_timings}
    host_s = sum(t[k] for t in factor_s.values() for k in ("eri_3c", "eri_2c", "eigh")
                 if k in t)
    show("embed_profiled", {**summary, "stages_s": driver.timings, **factor_s,
                            "launches": launches, "scf_runs": runs,
                            "df_factors_host_s": host_s,
                            "df_factors_host_share": host_s / summary["wall_s"]})

    eng = driver._ks_engine
    t0 = time.perf_counter()
    eng.kernel()
    torch.cuda.synchronize()
    show("global_scf_unprofiled", {"wall_s": time.perf_counter() - t0})
    _, summary = device_profile(eng.kernel)
    show("global_scf_profiled", {**summary, "last_run": eng.last_run})

    if eng.density_fitting:
        aux = make_auxiliary_molecule(eng.mol, beta=eng.df_beta)
        cpus = os.sched_getaffinity(0)
        show("eri_3c_s", {"naux": aux.nao,
                          f"{len(cpus)}_threads": timed_eri_3c(eng.mol, aux, cpus),
                          "1_thread": timed_eri_3c(eng.mol, aux, {min(cpus)})})


if __name__ == "__main__":
    main()
