"""The derivative programs of nbed_tpu_torch against the eager route on one
CUDA card.

    python3 scripts/bench_gradient_programs.py [--device cpu] [--cases ...]
                                               [--no-profile] [--keep-going]

For each case the graphed route (``jit_kernel="auto"``: the SCFs, the
"eri" program and the "hf_grad"/"ks_grad" gradient programs as CUDA
graphs) and the eager route (``"off"``), host clock, synchronised:

- ``first_s``: the graphed route's first call of the structure (its
  captures included), after one eager call that built the host tables;
- ``warm_s``: a graphed call at a second geometry (0.01 bohr off), which
  must capture nothing;
- ``eager_s``: the eager route at that second geometry;
- ``max_dev``: the largest difference of the two routes' results there
  (Ha/bohr, Ha/bohr^2 for Hessians);
- the captures, capture seconds and, per derivative program,
  ``memory_reserved`` just before and after its capture (the growth is
  its graph's pool; programs of a structure share one pool).

Cases: ``water_hf``, ``water_b3lyp``, ``water_camb3lyp`` (water/STO-3G
gradients), ``acetonitrile_hf``, ``acetonitrile_b3lyp5``, ``water_ccpvdz_hf``
(M = 576), ``water_optimize`` (BFGS to gtol 1e-6, from the molecule's
geometry both ways), ``acetonitrile_hessian`` (36 lanes), ``water_ks_hessian``
(B3LYP, 18 ``ks_gradient`` calls) and ``eri`` (water/cc-pVDZ
``eri_program`` against ``eri_tensor``, full and omega = 0.33). The two
Hessians are then profiled warm both ways (``device_profile``: wall,
device busy time, idle share). Prints the card's name and power limit
first and one JSON line per case. ``--device cpu`` rehearses it without a
card, the graphed route as the programs' bodies run uncaptured
(``jit_kernel="on"``); its times say nothing about the card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import ACETONITRILE, WATER  # noqa: E402
from nbed_tpu_torch.chem import build_molecule  # noqa: E402
from nbed_tpu_torch.integrals import eri_tensor  # noqa: E402
from nbed_tpu_torch.integrals.eri import eri_program  # noqa: E402
from nbed_tpu_torch.ops.programs import DERIVATIVE_PROGRAMS, RUNS  # noqa: E402
from nbed_tpu_torch.profiling import device_profile  # noqa: E402
from nbed_tpu_torch.solvers import (hessian_fd, hf_gradient, ks_gradient,  # noqa: E402
                                    optimize_geometry)

TIGHT = dict(conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=200)
CUDA_CASES = ("water_hf", "water_b3lyp", "water_camb3lyp", "acetonitrile_hf",
              "acetonitrile_b3lyp5", "water_ccpvdz_hf", "water_optimize",
              "acetonitrile_hessian", "water_ks_hessian", "eri")
CPU_CASES = ("water_hf", "water_b3lyp", "water_optimize", "eri")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def _result(out):
    """The array a case compares: a gradient, a Hessian, coordinates or an
    ERI tensor."""
    if isinstance(out, tuple):
        out = out[1] if len(out) == 3 else out[0]
    return out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def cases(device):
    """{name: (molecule, run(coords, jit_kernel))}."""
    water = build_molecule(WATER.read_text(), "sto-3g")
    pra = build_molecule(ACETONITRILE, "sto-3g")
    dz = build_molecule(WATER.read_text(), "cc-pvdz")

    def eri_pair(x, mode):
        xt = torch.tensor(x, dtype=torch.float64, device=device)
        if mode == "off":
            return torch.stack([eri_tensor(dz, xt, device=device),
                                eri_tensor(dz, xt, omega=0.33, device=device)])
        return torch.stack([eri_program(dz, xt, jit_kernel=mode),
                            eri_program(dz, xt, omega=0.33, jit_kernel=mode)])

    return {
        "water_hf": (water, lambda x, m: hf_gradient(water, coords=x, device=device,
                                                     jit_kernel=m, **TIGHT)),
        "water_b3lyp": (water, lambda x, m: ks_gradient(water, "b3lyp", coords=x,
                                                        device=device, jit_kernel=m, **TIGHT)),
        "water_camb3lyp": (water, lambda x, m: ks_gradient(water, "cam-b3lyp", coords=x,
                                                           device=device, jit_kernel=m,
                                                           **TIGHT)),
        "acetonitrile_hf": (pra, lambda x, m: hf_gradient(pra, coords=x, device=device,
                                                          jit_kernel=m, **TIGHT)),
        "acetonitrile_b3lyp5": (pra, lambda x, m: ks_gradient(pra, "b3lyp5", coords=x,
                                                              device=device, jit_kernel=m,
                                                              **TIGHT)),
        "water_ccpvdz_hf": (dz, lambda x, m: hf_gradient(dz, coords=x, device=device,
                                                         jit_kernel=m, **TIGHT)),
        "water_optimize": (water, lambda x, m: optimize_geometry(
            water, coords0=x, gtol=1e-6, device=device, jit_kernel=m)),
        "acetonitrile_hessian": (pra, lambda x, m: hessian_fd(pra, coords=x, device=device,
                                                              jit_kernel=m)),
        "water_ks_hessian": (water, lambda x, m: hessian_fd(water, coords=x, xc="b3lyp",
                                                            device=device, jit_kernel=m)),
        "eri": (dz, eri_pair),
    }


def programs_memory() -> list:
    """[kind, shape, memory_reserved GB before and after its capture] of
    every captured derivative program, in capture order: the growth is the
    memory its graph took into its structure's pool."""
    out = []
    for key, prog in DERIVATIVE_PROGRAMS.items():
        r = prog.captured.reserved
        if r is not None:
            out.append([key[0], list(key[2]), r[0] / 1e9, r[1] / 1e9])
    return out


def run_case(name, mol, run, device, graphed: str, profile: bool) -> dict:
    x0 = np.asarray(mol.coords, dtype=np.float64)
    x1 = x0.copy()
    x1[0] += 0.01  # a second geometry of the structure
    run(x0, "off")  # host tables (angular classes, grids) built once
    DERIVATIVE_PROGRAMS.clear()
    before = dict(RUNS)
    reserved = torch.cuda.memory_reserved() if torch.device(device).type == "cuda" else 0
    first_s, _ = _timed(lambda: run(x0, graphed), device)
    first = {k: RUNS[k] - before.get(k, 0) for k in RUNS
             if k.endswith(("captures", "capture_s", "pool_gb")) and RUNS[k] != before.get(k, 0)}
    mid = dict(RUNS)
    warm_s, ours = _timed(lambda: run(x1, graphed), device)
    warm_captures = RUNS["captures"] - mid.get("captures", 0)
    eager_s, eager = _timed(lambda: run(x1, "off"), device)
    row = {"case": name, "first_s": first_s, "warm_s": warm_s, "eager_s": eager_s,
           "max_dev": float(np.max(np.abs(_result(ours) - _result(eager)))),
           "warm_captures": warm_captures, "first": first,
           "programs_memory": programs_memory(),
           "reserved_gb": [reserved / 1e9, (torch.cuda.memory_reserved() / 1e9
                                            if torch.device(device).type == "cuda" else 0)],
           "device": device, "jit_kernel": graphed}
    if profile and name.endswith("hessian"):
        for mode in (graphed, "off"):
            _, prof = device_profile(lambda: run(x1, mode))
            row[f"profile_{mode}"] = {k: prof[k] for k in ("wall_s", "device_busy_s",
                                                           "device_idle_share",
                                                           "device_events")}
            row[f"profile_{mode}"]["top"] = prof["top"][:5]
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cases", nargs="+", default=None)
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--keep-going", action="store_true",
                    help="print a failed case's error and go on (exit 1 at the end)")
    args = ap.parse_args()
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("bench_gradient_programs.py: no CUDA device")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    else:
        torch.set_num_threads(1)
    names = args.cases or (CUDA_CASES if cuda else CPU_CASES)
    table = cases(args.device)
    failed = []
    for name in names:
        mol, run = table[name]
        try:
            row = run_case(name, mol, run, args.device, "auto" if cuda else "on",
                           not args.no_profile)
        except Exception as err:  # noqa: BLE001 -- reported, and the exit code says so
            if not args.keep_going:
                raise
            failed.append(name)
            print(json.dumps({"case": name, "error": f"{type(err).__name__}: {err}"}),
                  flush=True)
            continue
        print(json.dumps(row), flush=True)
    if failed:
        raise SystemExit(f"failed cases: {failed}")


if __name__ == "__main__":
    main()
