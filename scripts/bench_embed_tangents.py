"""Forward-mode geometry derivatives of the embedding program on one CUDA
card: graphed against eager.

    python3 scripts/bench_embed_tangents.py [--device cpu] [--cycles 40 0]
                                            [--modes auto off] [--lanes 8]
                                            [--no-profile]

Water/STO-3G, B3LYP at grid level 1, ``n_act_mos`` 3 (the host driver's
count on water, as in ``chip_smoke.py``'s ``water_embed_fleet``), SCF
tolerances 1e-10/1e-8: the derivative d e_emb_rhf / dz of the second H,
``fn(forward_ad.make_dual(x, t))``, for each ``grad_cycles`` in
``--cycles`` and each ``jit_kernel`` in ``--modes`` ("auto": the tangent
programs as CUDA graphs; "off": the eager dual route). Per mode: the
first call with the program caches cleared (its captures and capture
seconds), a warm call at a second geometry (the H moved 0.01 bohr; its
captures, which should be none), and under ``torch.profiler`` the warm
call's wall, device busy time (kernels and copies), idle share and the
split between the program's stages (``embed.*`` ranges: operators,
global KS, SPADE and subsystem, embedded HF; their spans on the device
timeline and their host time). Then the same derivative over ``--lanes``
conformers along the stretch, warm, per mode, and the primal program
over the same lanes for scale. Prints the card's name and power limit
first and one JSON line per measurement (host clock, synchronised).
``--device cpu`` rehearses it here (its times say nothing about the
card).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import forward_ad

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import WATER, stretch_coords  # noqa: E402
from nbed_tpu_torch.chem import build_molecule  # noqa: E402
from nbed_tpu_torch.ops import jk  # noqa: E402
from nbed_tpu_torch.ops.programs import DERIVATIVE_PROGRAMS, RUNS  # noqa: E402
from nbed_tpu_torch.parallel import make_mu_embed_energy  # noqa: E402
from nbed_tpu_torch.scf import engine  # noqa: E402

STAGES = ("embed.operators", "embed.global_ks", "embed.spade_subsystem",
          "embed.embedded_hf")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def tangent(fn, x, t):
    """(e_emb_rhf, its tangent) of ``fn`` at the dual ``x`` + eps ``t``, as
    tensors on the device."""
    with forward_ad.dual_level():
        p, d = forward_ad.unpack_dual(fn(forward_ad.make_dual(x, t))["e_emb_rhf"])
        return p.detach().clone(), d.clone()


def timed(call, device) -> tuple:
    """(seconds, result, RUNS delta, fused J/K launches) of ``call()``."""
    before = dict(RUNS)
    jk.LAUNCHES.clear()
    _sync(device)
    t0 = time.perf_counter()
    out = call()
    _sync(device)
    wall = time.perf_counter() - t0
    delta = {k: RUNS[k] - before.get(k, 0) for k in RUNS if RUNS[k] != before.get(k, 0)}
    return wall, out, delta, sum(jk.LAUNCHES.values())


def profiled(call) -> dict:
    """The wall, device busy time, idle share and the host seconds of each
    ``embed.*`` stage of one ``call()`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        call()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # the stages' ranges show on the device timeline too, as spans from
    # their first kernel to their last: the split, not busy time
    ranges = {e.key for e in events if getattr(e, "is_user_annotation", False)} | set(STAGES)
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    spans = {e.key: e.self_device_time_total / 1e6 for e in events
             if e.device_type == DeviceType.CUDA and e.key in STAGES}
    host = {e.key: e.cpu_time_total / 1e6 for e in events
            if e.device_type != DeviceType.CUDA and e.key in STAGES}
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_s": wall, "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
            "device_events": sum(e.count for e in dev), "stage_device_span_s": spans,
            "stage_host_s": host,
            "top": [[e.key, e.count, e.self_device_time_total / 1e3] for e in top]}


def clear_programs():
    engine._JIT_PROGRAM_CACHE.clear()
    DERIVATIVE_PROGRAMS.clear()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cycles", type=int, nargs="+", default=[40, 0])
    ap.add_argument("--modes", nargs="+", default=["auto", "off"])
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args()
    device = args.device
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_embed_tangents.py: no CUDA device")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    mol = build_molecule(WATER.read_text(), "sto-3g")
    kw = dict(xc="b3lyp", grid_level=1, conv_tol=1e-10, dm_conv_tol=1e-8, device=device)
    x0 = torch.tensor(np.asarray(mol.coords), device=device)
    t = torch.zeros_like(x0)
    t[2, 2] = 1.0
    x1 = x0 + 0.01 * t
    for cycles in args.cycles:
        results = {}
        for mode in args.modes:
            fn = make_mu_embed_energy(mol, 1, 3, grad_cycles=cycles, jit_kernel=mode, **kw)
            clear_programs()
            first_s, _, first_runs, _ = timed(lambda: tangent(fn, x0, t), device)
            warm_s, (e, d), warm_runs, launches = timed(lambda: tangent(fn, x1, t), device)
            results[mode] = float(d)
            row = {"case": "single", "grad_cycles": cycles, "jit_kernel": mode,
                   "first_s": first_s, "warm_s": warm_s, "e_emb_rhf": float(e),
                   "de_dz": float(d), "fused_jk_launches": launches,
                   "first_runs": first_runs, "warm_captures": warm_runs.get("captures", 0),
                   "warm_runs": warm_runs}
            if not args.no_profile:
                row["profile"] = profiled(lambda: tangent(fn, x1, t))
            print(json.dumps(row), flush=True)
        if len(results) > 1:
            vals = list(results.values())
            print(json.dumps({"case": "single", "grad_cycles": cycles,
                              "max_mode_difference": max(vals) - min(vals)}), flush=True)
    if args.lanes:
        xb = torch.tensor(stretch_coords(mol, args.lanes, 0.04), device=device)
        tb = torch.zeros_like(xb)
        tb[:, 2, 2] = 1.0
        for mode in args.modes:
            fn = make_mu_embed_energy(mol, 1, 3, grad_cycles=40, jit_kernel=mode, **kw)
            tangent(fn, xb, tb)
            fn(xb)
            warm_s, (_, d), runs, launches = timed(lambda: tangent(fn, xb, tb), device)
            primal_s, _, _, _ = timed(lambda: fn(xb), device)
            print(json.dumps({"case": "lanes", "lanes": args.lanes, "grad_cycles": 40,
                              "jit_kernel": mode, "warm_s": warm_s, "primal_warm_s": primal_s,
                              "de_dz": d.tolist(), "fused_jk_launches": launches,
                              "warm_captures": runs.get("captures", 0)}), flush=True)


if __name__ == "__main__":
    main()
