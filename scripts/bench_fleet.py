"""Conformer-fleet throughput of nbed_tpu_torch.parallel on one CUDA card.

    python3 scripts/bench_fleet.py [--device cpu] [--batches 1 8 36]
                                   [--jit-kernel auto off]

The counterpart of ``scripts/embed_fleet_tpu.py``. For each batch size B,
warm (one untimed call of the same shape first; host clock, synchronised):

- ``hf``: ``batched_hf_energies`` on water/STO-3G conformers jittered by
  0.02 bohr (``np.random.default_rng(11)``, lane 0 unperturbed);
- ``embed``: ``batched_embedding_energies`` (B3LYP, grid level 1, four
  active MOs) on water with the second O-H bond stretched 0-0.04 bohr;
- ``hessian_lanes``: ``batched_hf_gradients`` on the first B of the
  acetonitrile molecule's 36 centrally displaced geometries (B = 36 is a
  whole Hessian's gradients);

each with conformers/s, seconds, fused J/K launches and peak device
memory. Then ``hessian_fd`` of acetonitrile once more (warm) under
``nbed_tpu_torch.profiling.device_profile``: its wall time, device busy
time and idle share. Each measurement runs for every ``--jit-kernel``
mode: "auto", the lane SCFs as shared CUDA-graph programs, and "off", the
eager lane loop. Prints the card's name and power limit first and one
JSON line per measurement. ``--device cpu`` rehearses it without a card
(its times say nothing about the card).
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

from chip_smoke import ACETONITRILE, WATER, stretch_coords, water_fleet_coords  # noqa: E402
from nbed_tpu_torch.chem import build_molecule  # noqa: E402
from nbed_tpu_torch.ops import jk  # noqa: E402
from nbed_tpu_torch.parallel import (batched_embedding_energies,  # noqa: E402
                                     batched_hf_energies, batched_hf_gradients)
from nbed_tpu_torch.profiling import device_profile  # noqa: E402
from nbed_tpu_torch.solvers import hessian_fd  # noqa: E402
from nbed_tpu_torch.solvers.hessian import _displacements  # noqa: E402


def timed(fn, cuda: bool) -> tuple:
    """(seconds, fused J/K launches, peak GB) of a warm call of ``fn``."""
    fn()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    jk.LAUNCHES.clear()
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    return wall, sum(jk.LAUNCHES.values()), peak


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 36])
    ap.add_argument("--jit-kernel", nargs="+", default=["auto", "off"])
    args = ap.parse_args()
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("bench_fleet.py: no CUDA device")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    water = build_molecule(WATER.read_text(), "sto-3g")
    pra = build_molecule(ACETONITRILE, "sto-3g")
    disp = _displacements(np.asarray(pra.coords), 5e-3)
    dev = args.device
    for mode in args.jit_kernel:
        kw = dict(device=dev, jit_kernel=mode)
        work = {
            "hf": lambda b: (lambda: batched_hf_energies(
                water, water_fleet_coords(water, b), conv_tol=1e-8, max_cycle=100,
                **kw)[0].cpu()),
            "embed": lambda b: (lambda: batched_embedding_energies(
                water, stretch_coords(water, b, 0.04), 1, 4, xc="b3lyp", grid_level=1,
                conv_tol=1e-9, dm_conv_tol=1e-7, **kw)["e_emb_rhf"].cpu()),
            "hessian_lanes": lambda b: (lambda: batched_hf_gradients(
                pra, disp[:b], **kw)[1].cpu()),
        }
        for name, make in work.items():
            for b in args.batches:
                wall, launches, peak = timed(make(b), cuda)
                print(json.dumps({"bench": name, "batch": b, "s": wall,
                                  "conformers_per_s": b / wall,
                                  "fused_jk_launches": launches, "peak_gb": peak,
                                  "device": dev, "jit_kernel": mode}), flush=True)
        hessian_fd(pra, **kw)
        _, prof = device_profile(lambda: hessian_fd(pra, **kw))
        print(json.dumps({"bench": "hessian_fd_profile", "molecule": "acetonitrile",
                          "wall_s": prof["wall_s"], "device_busy_s": prof["device_busy_s"],
                          "device_idle_share": prof["device_idle_share"],
                          "device_events": prof["device_events"], "top": prof["top"][:6],
                          "device": dev, "jit_kernel": mode}), flush=True)


if __name__ == "__main__":
    main()
