"""The CCSD programs on one CUDA card: the amplitude sweep by cycles per
replay, and the (T) energy, each graphed against its eager loop.

    python3 scripts/bench_ccsd_graphs.py [--cycles 1 2 4 8] [--device cuda|cpu]

The spin-orbital Hamiltonians of water's mu-embedded space and
acetonitrile's Huzinaga-embedded one (the ``chip_smoke.CONFIGS`` drivers)
and water's global HF (``water_global``). For each ``SWEEP_CYCLES`` K of
``--cycles``, from an empty program cache: the first ``run_ccsd`` (its
capture, K cycles per replay) with its wall, capture seconds and capture
seconds per captured cycle, then a warm one with its wall, replays and
host reads; beside them the warm eager wall (the same cycle function
uncaptured, one host read per cycle) and the energy differences. For
water_global also CCSD(T)'s (T) graphed against eager. The grid and AO
tables and the TDA/RPA blocks are measured by ``chip_smoke.py``'s
``grid_programs`` and ``tddft_graphed`` phases.

Every wall is the host clock with the card synchronised before and after.
Prints the card's name and power limit first, then one JSON object per
system. ``--device cpu`` rehearses the control flow (the programs run
uncaptured there, so its seconds say nothing about the card).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nbed_tpu_torch import nbed  # noqa: E402
from nbed_tpu_torch.ham import HamiltonianBuilder  # noqa: E402
from nbed_tpu_torch.ops.programs import RUNS  # noqa: E402
from nbed_tpu_torch.solvers import ccsd, run_ccsd  # noqa: E402


def timed(fn, cuda: bool):
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(fn, cuda: bool):
    """(fn(), wall seconds, the RUNS counts it added)."""
    before = dict(RUNS)
    out, wall = timed(fn, cuda)
    return out, wall, {k: v - before.get(k, 0) for k, v in RUNS.items() if v != before.get(k, 0)}


def hamiltonians(device) -> dict:
    """{label: (h1, h2, occupation)} of the embedded and global spaces."""
    out = {}
    water = nbed(**chip_smoke.CONFIGS["water"], device=device)
    aceto = nbed(**chip_smoke.CONFIGS["acetonitrile"], device=device)
    glob = nbed(**chip_smoke.CONFIGS["water_global"], device=device)
    for label, sol in (("water_mu", water.mu["scf"]), ("acetonitrile_huzinaga",
                                                        aceto.huzinaga["scf"]),
                       ("water_global", glob._global_hf)):
        _, h1, h2 = HamiltonianBuilder(sol, 0.0).build()
        out[label] = (h1, h2, chip_smoke._interleaved(sol))
    return out


def bench_ccsd(label, h1, h2, occ, cycles, cuda: bool) -> dict:
    out = {"system": label, "n_spin_orbitals": h1.shape[0], "n_occ": int(occ.sum())}
    ccsd._GRAPHED = False
    try:
        run_ccsd(h1, h2, occ, conv_tol=1e-10)
        (e_eager, _), eager_s, eager_runs = counted(
            lambda: run_ccsd(h1, h2, occ, conv_tol=1e-10), cuda)
    finally:
        ccsd._GRAPHED = True
    out["eager"] = {"wall_s": eager_s, "host_reads": eager_runs.get("ccsd_host_reads", 0)}
    for k in cycles:
        ccsd.SWEEP_CYCLES = k
        ccsd._SWEEP_PROGRAMS.clear()
        (e_first, _), first_s, first = counted(lambda: run_ccsd(h1, h2, occ, conv_tol=1e-10),
                                               cuda)
        (e_warm, _), warm_s, warm = counted(lambda: run_ccsd(h1, h2, occ, conv_tol=1e-10),
                                            cuda)
        capture_s = first.get("ccsd_graph_capture_s", 0.0)
        out[f"k{k}"] = {"first_wall_s": first_s, "captures": first.get("ccsd_graph_captures", 0),
                        "capture_s": capture_s, "capture_s_per_cycle": capture_s / k,
                        "warm_wall_s": warm_s, "replays": warm.get("ccsd_graph", 0),
                        "host_reads": warm.get("ccsd_host_reads", 0),
                        "warm_captures": warm.get("captures", 0),
                        "de_vs_eager": e_warm - e_eager, "de_first": e_first - e_eager}
    ccsd.SWEEP_CYCLES = 1
    return out


def bench_triples(h1, h2, occ, cuda: bool) -> dict:
    ccsd._GRAPHED = False
    try:
        (_, t_eager, _), eager_s = timed(lambda: run_ccsd(h1, h2, occ, conv_tol=1e-10,
                                                          triples=True), cuda)
    finally:
        ccsd._GRAPHED = True
    ccsd._TRIPLES_PROGRAMS.clear()
    (_, t_first, _), first_s, first = counted(
        lambda: run_ccsd(h1, h2, occ, conv_tol=1e-10, triples=True), cuda)
    (_, t_warm, _), warm_s = timed(lambda: run_ccsd(h1, h2, occ, conv_tol=1e-10,
                                                    triples=True), cuda)
    return {"eager_ccsd_t_s": eager_s, "first_ccsd_t_s": first_s, "warm_ccsd_t_s": warm_s,
            "triples_capture_s": first.get("triples_graph_capture_s", 0.0),
            "de_t": t_warm - t_eager, "de_t_first": t_first - t_eager}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cycles", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cuda = args.device == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("bench_ccsd_graphs.py: torch.cuda.is_available() is False")
        print(chip_smoke.card_line(), flush=True)
        chip_smoke.build_all()
    for label, (h1, h2, occ) in hamiltonians(args.device).items():
        row = bench_ccsd(label, h1, h2, occ, args.cycles, cuda)
        if label == "water_global":
            row["triples"] = bench_triples(h1, h2, occ, cuda)
        print("ccsd", json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
