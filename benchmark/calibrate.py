"""The readings that the check's limits are set from, for one cell, in one
process: the program's gaps to the reference on each of ``--seeds`` (the
requests a run checks, from that seed's window stream), and the control's:
the reference computed in float32 (TF32 off) in the program's place, on
each of ``--control-seeds``. The benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 1 2 3 [--out chiprun_out/calibrate_<cell>.json]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _requests(cell, seed):
    """The requests a run with ``seed`` checks: as many as it keeps, taken
    from the start of that seed's window stream, one per molecule first."""
    from harness.traffic import Traffic

    gen = Traffic(cell.config, cell.traffic, seed)
    per = int(cell.traffic.get("check_per_molecule", 1))
    count = per * len(gen.molecules)
    return [gen.request("window", i) for i in range(count)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    from harness.main import Cell
    from harness.traffic import Traffic

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = Cell(ROOT, args.workload, args.device)
    entry = cell.entry
    first = Traffic(cell.config, cell.traffic, (args.seeds or args.control_seeds)[0])
    entry.setup(first)
    for i in range(int(cell.traffic.get("warmup_requests", 0))):
        entry.run(first.request("warmup", i))
    rows = []
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            worst, t_ref = {}, 0.0
            for request in _requests(cell, seed):
                t0 = time.perf_counter()
                ref = entry.reference(request, torch.float64, args.device, seed)
                t_ref += time.perf_counter() - t0
                if kind == "program":
                    out, _ = entry.run(request)
                    prog = entry.answers(out, request)
                    del out
                else:
                    low = entry.reference(request, torch.float32, args.device, seed)
                    prog = _as_program(low, request)
                for name, gap in entry.compare(prog, ref).items():
                    worst[name] = max(worst.get(name, 0.0), gap)
            row = {"kind": kind, "seed": seed, "gaps": worst, "reference_s": t_ref}
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for name in sorted({n for r in rows for n in r["gaps"]}):
        lower = max((r["gaps"][name] for r in rows if r["kind"] == "program"), default=None)
        upper = min((r["gaps"][name] for r in rows if r["kind"] == "control"), default=None)
        summary[name] = {"lower": lower, "upper": upper}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


def _as_program(low: dict, request) -> dict:
    """A control's answers in the program's form (a fleet's per-conformer
    arrays at full batch, the unchecked conformers NaN)."""
    if "conformers" not in low:
        return low
    n = len(request.geometries)
    out = {"converged": np.ones(n, dtype=bool)}
    for key in ("e_global", "e_emb"):
        full = np.full(n, np.nan)
        full[low["conformers"]] = low[key]
        out[key] = full
    return out


if __name__ == "__main__":
    sys.exit(main())
