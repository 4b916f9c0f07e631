"""Checkpoint and resume of SCF solutions and driver results (port of
``nbed_tpu/checkpoint.py``).

A solution round-trips through ``.npz`` with the reference's keys, so either
package loads the other's file; loading puts the arrays on the engine's
device, and the loaded solution seeds a warm restart through
``engine.kernel(dm0=sol.make_rdm1())``. Driver results go to JSON: scalars
and small arrays (tensors included), everything else dropped.
"""

import json
import logging

import numpy as np
import torch

from ._device import to_host

logger = logging.getLogger(__name__)

__all__ = ["save_solution", "load_solution", "save_results", "load_results"]


def save_solution(path, sol) -> None:
    """Persist an :class:`nbed_tpu_torch.scf.SCFSolution` to ``.npz``."""
    data = {
        "mo_coeff": to_host(sol.mo_coeff),
        "mo_energy": to_host(sol.mo_energy),
        "mo_occ": to_host(sol.mo_occ),
        "e_tot": np.asarray(sol.e_tot),
        "converged": np.asarray(sol.converged),
        "nelec": np.asarray(sol.nelec),
    }
    if sol.v_emb is not None:
        data["v_emb"] = to_host(sol.v_emb)
    if sol.huzinaga_op is not None:
        data["huzinaga_op"] = to_host(sol.huzinaga_op)
    np.savez(path, **data)
    logger.info("Saved SCF solution to %s", path)


def load_solution(path, engine):
    """Rebuild an SCFSolution against ``engine`` (same molecule and method),
    its arrays float64 tensors on the engine's device."""
    from .scf.engine import SCFSolution

    with np.load(path) as data:
        def opt(key):
            return engine._tensor(data[key]) if key in data else None

        return SCFSolution(
            engine=engine,
            nelec=tuple(int(x) for x in data["nelec"]),
            mo_coeff=engine._tensor(data["mo_coeff"]),
            mo_energy=engine._tensor(data["mo_energy"]),
            mo_occ=engine._tensor(data["mo_occ"]),
            e_tot=float(data["e_tot"]),
            converged=bool(data["converged"]),
            v_emb=opt("v_emb"),
            huzinaga_op=opt("huzinaga_op"),
        )


def _clean(obj):
    """JSON form of a result value: numbers as floats, arrays and tensors of
    at most 4096 elements as lists, dicts and tuples recursively; None for
    anything else (dropped from dicts)."""
    if isinstance(obj, torch.Tensor):
        obj = to_host(obj)
    if isinstance(obj, dict):
        cleaned = {k: _clean(v) for k, v in obj.items()}
        return {k: v for k, v in cleaned.items() if v is not None}
    if isinstance(obj, (int, float, np.floating, np.integer)):
        return float(obj)
    if isinstance(obj, np.ndarray) and obj.size <= 4096:
        return obj.tolist()
    if isinstance(obj, tuple):
        return [_clean(x) for x in obj]
    return None


def save_results(path, driver) -> None:
    """JSON dump of the driver's scalar and small-array results, with the
    reference's keys."""
    payload = {
        "mu": _clean(driver.mu) if driver.mu else None,
        "huzinaga": _clean(driver.huzinaga) if driver.huzinaga else None,
        "e_act": float(driver.e_act),
        "e_env": float(driver.e_env),
        "two_e_cross": float(driver.two_e_cross),
        "e_nuc": float(driver.e_nuc),
        "timings": getattr(driver, "timings", {}),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    logger.info("Saved driver results to %s", path)


def load_results(path) -> dict:
    with open(path) as f:
        return json.load(f)
