"""The VQE programs on one CUDA card: the sweep chunk size, and a full
20-qubit VQE graphed and eager.

    python3 scripts/bench_vqe.py [--chunks 8 32 128 512] [--full] [--eager-full]
                                 [--maxiter 500] [--n-mo 10] [--device cuda|cpu]

The register is the PRA acetonitrile configuration's Huzinaga-embedded SCF
(``chip_smoke.CONFIGS["acetonitrile"]``) cut to ``--n-mo`` MOs: 10 MOs are
the 20-qubit register of ``chip_smoke.py``'s ``vqe_20q`` phase (Jordan-
Wigner, full UCCSD). First the eager route's value and gradient (autograd
through the adjoint sweep, ``solvers.vqe._value_and_grad``). Then for each
rotations-per-chunk K of ``--chunks``, from an empty program cache: the
first value and gradient (its captures and capture seconds), the device
memory its graphs keep (``memory_reserved`` growth over the first call,
after ``empty_cache``), the warm value and gradient (3 calls), its replays
and host reads, and its energy and gradient against the eager route's.

``--full`` runs ``run_vqe`` from the reference determinant with the
programs (``SWEEP_CHUNK`` as the module sets it) to convergence or
``--maxiter`` L-BFGS-B iterations: iterations, evaluations, total wall and
e_vqe; ``--eager-full`` also on the eager route (the same iterates:
e_vqe must be equal to the bit).

Every wall is the host clock with the card synchronised before and after.
Prints the card's name and power limit first, then one JSON object per
measurement. ``--device cpu`` rehearses the control flow (the programs run
uncaptured there, so its seconds say nothing about the card).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nbed_tpu_torch import nbed  # noqa: E402
from nbed_tpu_torch.ops.programs import RUNS  # noqa: E402
from nbed_tpu_torch.solvers import run_vqe, vqe  # noqa: E402


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


def reserved(cuda: bool) -> int:
    return torch.cuda.memory_reserved() if cuda else 0


def bench_chunk(k: int, prog, psi0, thetas, eager, cuda: bool) -> dict:
    vqe._PROGRAMS.clear()
    if cuda:
        torch.cuda.empty_cache()
    before = reserved(cuda)
    ap = vqe._vqe_program(prog, psi0, k=min(k, len(prog.strings)))
    (e1, g1), first_s, first = counted(lambda: ap.value_and_grad(thetas), cuda)
    pool_bytes = reserved(cuda) - before
    walls = []
    for _ in range(3):
        (e, g), wall, warm = counted(lambda: ap.value_and_grad(thetas), cuda)
        walls.append(wall)
    e_eager, g_eager = eager
    return {"k": ap.k, "chunks_each_way": ap.n_chunks, "padded_strings": ap.n_cap,
            "first_s": first_s, "captures": first.get("captures", 0),
            "capture_s": first.get("capture_s", 0.0),
            "capture_s_by_kind": {kind: first.get(f"{kind}_capture_s", 0.0)
                                  for kind in ap.graphs},
            "graph_pool_bytes": pool_bytes, "warm_s": walls,
            "replays": warm.get("replays", 0), "host_reads": warm.get("host_reads", 0),
            "warm_captures": warm.get("captures", 0), "de": e - e_eager,
            "dg_max": float(np.max(np.abs(g - g_eager))),
            "bitwise": bool(e == e_eager and np.array_equal(g, g_eager)
                            and e1 == e and np.array_equal(g1, g))}


def full_vqe(sq, nelec, maxiter: int, cuda: bool, graphed: bool) -> tuple:
    vqe._GRAPHED = graphed
    try:
        res, wall, runs = counted(lambda: run_vqe(*sq, nelec=nelec, maxiter=maxiter,
                                                  device="cuda" if cuda else "cpu"), cuda)
    finally:
        vqe._GRAPHED = True
    evaluations = len(res.history) - 1
    return res, {"route": "graphed" if graphed else "eager", "maxiter": maxiter,
                 "iterations": res.n_iterations, "evaluations": evaluations,
                 "converged": res.converged, "wall_s": wall,
                 "s_per_evaluation": wall / max(evaluations, 1), "e_vqe": res.e_vqe,
                 "e_reference": res.e_reference, "captures": runs.get("captures", 0),
                 "capture_s": runs.get("capture_s", 0.0), "sweep_chunk": vqe.SWEEP_CHUNK,
                 "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                             if cuda else None),
                 "reserved_gb": reserved(cuda) / 1e9}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, nargs="*", default=[8, 32, 128, 512])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--eager-full", action="store_true")
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--n-mo", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cuda = args.device == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("bench_vqe.py: torch.cuda.is_available() is False")
        print(chip_smoke.card_line(), flush=True)
        chip_smoke.build_all()
    driver = nbed(**{**chip_smoke.CONFIGS["acetonitrile"], "run_ccsd_emb": False},
                  device=args.device)
    sq, nelec = chip_smoke.pra_register(driver.huzinaga["scf"], args.n_mo)
    psum, prog, psi0, n_params = vqe._ansatz_setup(*sq, nelec, "jw", None,
                                                   torch.device(args.device))
    thetas = 0.05 * np.random.default_rng(20).standard_normal(n_params)
    timed(lambda: vqe._value_and_grad(thetas, psi0, prog), cuda)
    eager, eager_s = timed(lambda: vqe._value_and_grad(thetas, psi0, prog), cuda)
    print("register", json.dumps({"n_qubits": psum.n_qubits, "nelec": nelec,
                                  "n_params": n_params, "n_strings": len(prog.strings),
                                  "n_terms": len(psum), "n_hamiltonian_blocks": len(prog.blocks),
                                  "eager_value_and_grad_s": eager_s}), flush=True)
    for k in args.chunks:
        print("chunk", json.dumps(bench_chunk(k, prog, psi0, thetas, eager, cuda)), flush=True)
    if args.full or args.eager_full:
        graphed, row = full_vqe(sq, nelec, args.maxiter, cuda, graphed=True)
        print("full_vqe", json.dumps(row), flush=True)
        if args.eager_full:
            eager_res, row = full_vqe(sq, nelec, args.maxiter, cuda, graphed=False)
            row["same_as_graphed"] = bool(eager_res.e_vqe == graphed.e_vqe
                                          and eager_res.n_iterations == graphed.n_iterations)
            print("full_vqe", json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
