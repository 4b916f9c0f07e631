"""The graphed SCF programs on one CUDA card: capture cost against host
reads, by the number of cycles per replay.

    python3 scripts/bench_graphs.py [--chunks 1 2 4 8 0] [--device cuda|cpu]

For the global SCFs of water (B3LYP) and the acetonitrile molecule of
``chip_smoke.ACETONITRILE`` (B3LYP5), both STO-3G at conv_tol 1e-9, and,
unless ``--no-pfoa``, pfoa (DF-B3LYP, STO-3G, 126 AOs, its full grid),
on one engine each (its grid, AO tables, SAD atoms and DF factor built
before any timing):

- eager (``jit_kernel="off"``): a warm ``kernel()``'s wall seconds and
  cycles, and ``nbed_tpu_torch.profiling.device_profile`` of another
  (device busy time and idle share);
- for each ``dispatch_cycles`` K of ``--chunks`` (0: one replay of all
  max_cycle cycles): the first graphed ``kernel()`` (its two captures, the
  warm-up cycle and the replays) with its wall and capture seconds and
  the peak device memory, then a second one (replays only) with its wall,
  replays and host reads; for the default K also its device profile.

Every wall is the host clock with the card synchronised before and after.
Prints the card's name and power limit first, then one JSON object per
molecule. ``--device cpu`` rehearses the control flow (the chunk body runs
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
from nbed_tpu_torch.chem import build_molecule  # noqa: E402
from nbed_tpu_torch.profiling import device_profile  # noqa: E402
from nbed_tpu_torch.scf import SCFEngine  # noqa: E402
from nbed_tpu_torch.scf.engine import DISPATCH_CYCLES  # noqa: E402


def timed(fn, cuda: bool):
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bench(label, eng, chunks, cuda: bool) -> dict:
    eng._sad_guess(), eng._xc  # noqa: B018 (atoms, grid, AO tables)
    if eng.density_fitting:
        eng.df_factor()
    out = {"molecule": label, "nao": eng.mol.nao, "default_chunk": DISPATCH_CYCLES}
    eng.jit_kernel = "off"
    eng.kernel()
    sol, wall = timed(eng.kernel, cuda)
    out["eager"] = {"wall_s": wall, "cycles": eng.last_run["cycles"], "e_tot": sol.e_tot}
    if cuda:
        out["eager"]["profile"] = {k: v for k, v in device_profile(eng.kernel)[1].items()
                                   if k != "top"}
    eng.jit_kernel = "on"
    for k in chunks:
        eng.dispatch_cycles = k
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _, first_s = timed(eng.kernel, cuda)
        first = dict(eng.last_run)
        row = {"first_wall_s": first_s, "capture_s": first["capture_s"],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
        sol, warm_s = timed(eng.kernel, cuda)
        run = eng.last_run
        row.update(warm_wall_s=warm_s, replays=run["replays"], host_reads=run["host_reads"],
                   cycles=run["cycles"], cycles_per_replay=run["cycles_per_replay"],
                   de_vs_eager=sol.e_tot - out["eager"]["e_tot"])
        if cuda and k == DISPATCH_CYCLES:
            row["profile"] = {key: v for key, v in device_profile(eng.kernel)[1].items()
                              if key != "top"}
        out[f"K={k}"] = row
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[1, 2, 4, 8, 0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--no-pfoa", action="store_true")
    args = ap.parse_args()
    cuda = args.device == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("bench_graphs.py: torch.cuda.is_available() is False")
        print(chip_smoke.card_line(), flush=True)
        chip_smoke.build_all()
    scf = dict(conv_tol=1e-9, max_cycle=40, device=args.device)
    water = build_molecule(chip_smoke.WATER.read_text(), "sto-3g")
    acn = build_molecule(chip_smoke.ACETONITRILE, "sto-3g")
    bench("water b3lyp", SCFEngine(water, xc="b3lyp", **scf), args.chunks, cuda)
    bench("acetonitrile b3lyp5", SCFEngine(acn, xc="b3lyp5", **scf), args.chunks, cuda)
    if not args.no_pfoa:
        pfoa = build_molecule(chip_smoke.PFOA.read_text(), "sto-3g")
        bench("pfoa df-b3lyp", SCFEngine(pfoa, xc="b3lyp", density_fitting=True, **scf),
              args.chunks, cuda)


if __name__ == "__main__":
    main()
