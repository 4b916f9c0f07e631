"""Every entry point of nbed_tpu_torch that takes a device defaults to
"cuda" and, where CUDA is absent, raises through ``_device.resolve_device``
before any work: the port never drops to the CPU on its own."""

import inspect

import numpy as np
import pytest
import torch

from nbed_tpu_torch import interop, nbed
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.driver import NbedDriver
from nbed_tpu_torch.grids import build_grid
from nbed_tpu_torch.integrals import dipole_integrals, kinetic, overlap, overlap_cross
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.scf.engine import df_b_factor
from nbed_tpu_torch.solvers import vqe

torch.set_num_threads(1)

H2 = "2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.74\n"


def _h2():
    return build_molecule(H2, "sto-3g")


def _sq():
    n = 4
    return 0.0, np.zeros((n, n)), np.zeros((n, n, n, n)), (1, 1)


ENTRY_POINTS = {
    "nbed": (nbed, lambda: nbed(geometry=H2, n_active_atoms=1, basis="STO-3G",
                                xc_functional="b3lyp")),
    "NbedDriver": (NbedDriver.__init__, None),
    "SCFEngine": (SCFEngine, lambda: SCFEngine(_h2())),
    "df_b_factor": (df_b_factor, lambda: df_b_factor(_h2())),
    "build_grid": (build_grid, lambda: build_grid(_h2())),
    "run_vqe": (vqe.run_vqe, lambda: vqe.run_vqe(*_sq())),
    "run_adapt_vqe": (vqe.run_adapt_vqe, lambda: vqe.run_adapt_vqe(*_sq())),
    "vqe_statevector": (vqe.vqe_statevector, lambda: vqe.vqe_statevector(*_sq())),
    "solution_from_reference": (interop.solution_from_reference,
                                lambda: interop.solution_from_reference(None)),
    "overlap": (overlap, lambda: overlap(_h2())),
    "overlap_cross": (overlap_cross, lambda: overlap_cross(_h2(), _h2())),
    "kinetic": (kinetic, lambda: kinetic(_h2())),
    "dipole_integrals": (dipole_integrals, lambda: dipole_integrals(_h2())),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda(name):
    fn, _ = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(k for k, v in ENTRY_POINTS.items() if v[1]))
def test_entry_point_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        ENTRY_POINTS[name][1]()
