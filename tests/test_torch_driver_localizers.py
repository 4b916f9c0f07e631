"""The embedding driver of nbed_tpu_torch with the Jacobi-sweep localizers,
PAO virtuals and embedded CIS/RPA, against an nbed_tpu NbedDriver run of the
same config on water/STO-3G.

The two packages run independent global SCFs, and the sweeps' skip
thresholds (nbed_tpu/localizers/occupied.py:234,249) could make them rotate
slightly different pairs; 1e-8 Ha holds on this system all the same.
"""

import numpy as np
import pytest
import torch

from nbed_tpu.config import NbedConfig as RefConfig
from nbed_tpu.driver import NbedDriver as RefDriver
from nbed_tpu_torch.config import NbedConfig
from nbed_tpu_torch.driver import NbedDriver

torch.set_num_threads(1)

ENERGY_KEYS = ("e_rhf", "e_ccsd", "classical_energy", "hf_emb", "correction",
               "beta_correction")


def _both(config: dict):
    """(port driver, nbed_tpu driver), each embedded with ``config``."""
    ours = NbedDriver(NbedConfig(**config), device="cpu")
    ours.embed()
    theirs = RefDriver(RefConfig(**config))
    theirs.embed()
    return ours, theirs


@pytest.fixture(scope="module", params=["pm", "boys", "ibo"])
def jacobi_drivers(request, nbed_args):
    """Both projectors with CCSD, four CIS and three RPA roots."""
    return _both({**nbed_args, "projector": "both", "localization": request.param,
                  "run_fci_emb": False, "run_cis_emb": 4, "run_rpa_emb": 3})


@pytest.fixture(scope="module")
def pao_drivers(nbed_args):
    return _both({**nbed_args, "projector": "huzinaga", "virtual_localization": "pao",
                  "run_fci_emb": False})


@pytest.mark.parametrize("projector", ["mu", "huzinaga"])
def test_jacobi_energies_match_nbed_tpu(jacobi_drivers, projector):
    ours, theirs = jacobi_drivers
    np.testing.assert_array_equal(ours.localized_system.active_mo_inds,
                                  theirs.localized_system.active_mo_inds)
    assert abs(ours._global_ks.e_tot - theirs._global_ks.e_tot) < 1e-8
    res, ref = getattr(ours, projector), getattr(theirs, projector)
    assert set(res) == set(ref)
    for key in ENERGY_KEYS:
        assert abs(float(res[key]) - float(ref[key])) < 1e-8, key


@pytest.mark.parametrize("projector", ["mu", "huzinaga"])
def test_cis_rpa_results_match_nbed_tpu(jacobi_drivers, projector):
    ours, theirs = jacobi_drivers
    res, ref = getattr(ours, projector), getattr(theirs, projector)
    assert res["cis"].excitations.shape == (4,) and res["e_rpa"].shape == (3,)
    for key in ("e_cis", "e_rpa"):
        np.testing.assert_allclose(res[key], ref[key], rtol=0, atol=1e-8)
    np.testing.assert_allclose(res["rpa"].excitations, ref["rpa"].excitations,
                               rtol=0, atol=1e-8)
    # the lowest roots of embedded water are non-degenerate (1e-3 Ha apart)
    for key in ("cis_oscillator_strengths", "rpa_oscillator_strengths"):
        np.testing.assert_allclose(res[key], ref[key], rtol=0, atol=1e-9)


def test_pao_huzinaga_matches_nbed_tpu(pao_drivers):
    ours, theirs = pao_drivers
    cv = ours.localized_system.c_loc_virt
    assert cv is not None and tuple(cv.shape) == np.asarray(
        theirs.localized_system.c_loc_virt).shape
    res, ref = ours.huzinaga, theirs.huzinaga
    assert set(res) == set(ref) and "cl" not in res
    for key in ("e_rhf", "e_ccsd"):
        assert abs(res[key] - ref[key]) < 1e-8, key
    assert "pao" in ours.timings


def test_pao_needs_huzinaga(nbed_args):
    """PAO with the mu projector raises in both packages before any SCF."""
    config = {**nbed_args, "projector": "mu", "virtual_localization": "pao"}
    for driver in (NbedDriver(NbedConfig(**config), device="cpu"),
                   RefDriver(RefConfig(**config))):
        with pytest.raises(NotImplementedError, match="requires projector='huzinaga'"):
            driver.embed()
