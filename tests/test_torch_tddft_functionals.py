"""TDA-TDDFT of nbed_tpu_torch against nbed_tpu for PBE and CAM-B3LYP
(water/STO-3G, exact ERIs, 1e-8), the range-separated exchange folded into
K as the engines fold it; and on the density-fitted route with PBE, where
hyb = 0 and no exchange enters, against nbed_tpu's DF TDA (1e-8)."""

import numpy as np
import pytest
import torch

from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.solvers import run_tddft_tda as ref_tda
from nbed_tpu_torch.interop import solution_from_reference
from nbed_tpu_torch.solvers import run_tddft_tda

torch.set_num_threads(1)

SCF = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)


@pytest.mark.parametrize("xc, density_fitting", [("pbe", False), ("camb3lyp", False),
                                                 ("pbe", True)])
def test_tda_matches_nbed_tpu(water_molecule, xc, density_fitting):
    ref_sol = RefEngine(water_molecule, xc=xc, density_fitting=density_fitting,
                        **SCF).kernel()
    sol = solution_from_reference(ref_sol, "cpu")
    assert sol.engine.density_fitting == density_fitting
    ours, theirs = run_tddft_tda(sol), ref_tda(ref_sol)
    np.testing.assert_allclose(ours.excitations, theirs.excitations, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(ours.pairs, theirs.pairs)
