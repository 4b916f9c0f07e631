"""Seconds of the derivatives slice, a molecule's first call against later
ones, and the device's idle share during a gradient.

    python3 scripts/bench_derivatives.py [--device cuda|cpu] [--old DIR]

For water/STO-3G, the acetonitrile molecule of ``chip_smoke.ACETONITRILE``
(STO-3G) and water/cc-pVDZ, in one process after the kernel build: three
calls each of ``hf_gradient``, ``ks_gradient`` (B3LYP; not at cc-pVDZ) and
``eri_tensor`` forward and backward (the backward of a seeded linear
functional), each on the host clock with the device synchronised at its
end, and the peak device memory of each kind; then ``torch.profiler`` over
one more ``hf_gradient`` (``nbed_tpu_torch.profiling.device_profile``:
wall, device busy time, idle share, device events, top events). A first
call pays the molecule's host class tables and the first launch of each
torch op; the later ones show the steady cost. Prints the card's name and
power limit first (on the card), then one JSON object per molecule.

``--old DIR``: DIR holds an earlier ``integrals/eri.py``, ``md.py`` and
``core.py`` of this package (written there from git, e.g. ``git show
<rev>:nbed_tpu_torch/integrals/eri.py``); each molecule's line then also
has ``eri_old_vs_new``: the earlier and the present ``eri_tensor``'s
forward and backward seconds, timed in turns (old, new, new, old) after
one call of each, each the mean of its two turns, and the largest
difference of the two tensors.
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
from nbed_tpu_torch.chem import build_molecule  # noqa: E402
from nbed_tpu_torch.integrals import eri_tensor  # noqa: E402
from nbed_tpu_torch.ops import jk  # noqa: E402
from nbed_tpu_torch.profiling import device_profile  # noqa: E402
from nbed_tpu_torch.solvers import hf_gradient, ks_gradient  # noqa: E402

CALLS = 3


def timed(fn, device):
    """(seconds of ``fn()`` with the device synchronised, peak GB)."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize()
    return time.perf_counter() - t0, (torch.cuda.max_memory_allocated() / 1e9 if cuda
                                      else None)


def load_old_integrals(root: Path):
    """The earlier ``integrals/eri.py`` under ``root`` as a module of a
    package of its own beside ``nbed_tpu_torch.integrals``, so that its
    relative imports take the earlier ``md.py`` and ``core.py`` beside it
    and the present package's other modules."""
    import importlib
    import types

    name = "nbed_tpu_torch._old_integrals"
    pkg = types.ModuleType(name)
    pkg.__path__ = [str(root)]
    sys.modules[name] = pkg
    return importlib.import_module(f"{name}.eri")


def eri_old_vs_new(mol, device, old) -> dict:
    """Forward and backward seconds of the earlier and the present
    ``eri_tensor`` in turns, and the largest difference of their tensors."""
    w = torch.tensor(np.random.default_rng(0).standard_normal((mol.nao,) * 4), device=device)
    fns = {"old": old.eri_tensor, "new": eri_tensor}

    def one(fn):
        x = torch.tensor(mol.coords, device=device, requires_grad=True)
        box = {}
        s_fwd, _ = timed(lambda: box.update(g=fn(mol, x, device=device)), device)
        s_bwd, _ = timed(lambda: torch.autograd.grad(torch.sum(w * box["g"]), x), device)
        return s_fwd, s_bwd, box["g"].detach()

    for fn in fns.values():
        one(fn)
    times = {"old": [], "new": []}
    out = {}
    for key in ("old", "new", "new", "old"):
        s_fwd, s_bwd, g = one(fns[key])
        times[key].append((s_fwd, s_bwd))
        out[key] = g
    return {"forward_s": {k: float(np.mean([t[0] for t in v])) for k, v in times.items()},
            "backward_s": {k: float(np.mean([t[1] for t in v])) for k, v in times.items()},
            "turns_s": times,
            "max_abs_diff": float(torch.max(torch.abs(out["old"] - out["new"])))}


def bench(label, mol, device, ks: bool, old=None):
    out = {"molecule": label, "nao": mol.nao, "m": mol.nao ** 2}
    w = torch.tensor(np.random.default_rng(0).standard_normal((mol.nao,) * 4),
                     device=device)

    def eri_pass():
        x = torch.tensor(mol.coords, device=device, requires_grad=True)
        box = {}
        s_fwd, peak_f = timed(lambda: box.update(g=eri_tensor(mol, x, device=device)), device)
        s_bwd, peak_b = timed(lambda: torch.autograd.grad(torch.sum(w * box["g"]), x), device)
        return s_fwd, s_bwd, None if peak_f is None else max(peak_f, peak_b)

    kinds = {"hf_gradient": lambda: hf_gradient(mol, device=device)}
    if ks:
        kinds["ks_gradient_b3lyp"] = lambda: ks_gradient(mol, "b3lyp", device=device)
    jk.LAUNCHES.clear()
    for name, fn in kinds.items():
        runs = [timed(fn, device) for _ in range(CALLS)]
        out[f"{name}_s"] = [r[0] for r in runs]
        out[f"{name}_peak_gb"] = max((r[1] for r in runs if r[1] is not None), default=None)
    out["fused_jk_launches"] = dict(jk.LAUNCHES)
    runs = [eri_pass() for _ in range(CALLS)]
    out["eri_forward_s"] = [r[0] for r in runs]
    out["eri_backward_s"] = [r[1] for r in runs]
    out["eri_peak_gb"] = runs[-1][2]
    if old is not None:
        out["eri_old_vs_new"] = eri_old_vs_new(mol, device, old)
    _, prof = device_profile(lambda: hf_gradient(mol, device=device))
    out["hf_gradient_profile"] = prof
    print(json.dumps(out), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--old", type=Path, help="directory of an earlier eri.py, md.py "
                                                 "and core.py")
    args = parser.parse_args()
    old = None if args.old is None else load_old_integrals(args.old)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_derivatives.py: torch.cuda.is_available() is False")
        print(chip_smoke.card_line(), flush=True)
        chip_smoke.build_all()
    water = chip_smoke.WATER.read_text()
    bench("water/STO-3G", build_molecule(water, "sto-3g"), args.device, ks=True, old=old)
    bench("acetonitrile/STO-3G", build_molecule(chip_smoke.ACETONITRILE, "sto-3g"),
          args.device, ks=True, old=old)
    bench("water/cc-pVDZ", build_molecule(water, "cc-pvdz"), args.device, ks=False, old=old)


if __name__ == "__main__":
    main()
