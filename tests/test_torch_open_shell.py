"""Open-shell slice: the methyl radical (spin 1), where SPADE keeps ragged
per-spin partitions (4 alpha / 3 beta active MOs) and environment deletion
equalizes the spin channels. nbed_tpu_torch on the CPU against nbed_tpu."""

from pathlib import Path

import numpy as np
import pytest

from nbed_tpu.config import NbedConfig as RefConfig
from nbed_tpu.driver import NbedDriver as RefDriver
from nbed_tpu_torch import nbed

KW = dict(n_active_atoms=1, basis="STO-3G", xc_functional="b3lyp", spin=1,
          localization="spade", convergence=1e-6, run_ccsd_emb=True,
          run_fci_emb=True)


@pytest.fixture(scope="module")
def drivers():
    geometry = str(Path(__file__).parent / "molecules" / "methyl_radical.xyz")
    port = nbed(geometry=geometry, projector="both", device="cpu", **KW)
    refs = {}
    for projector in ("mu", "huzinaga"):
        ref = RefDriver(RefConfig(geometry=geometry, projector=projector, **KW))
        ref.embed()
        refs[projector] = ref
    return port, refs


def test_ragged_partition_matches(drivers):
    port, refs = drivers
    for ref in refs.values():
        for ours, theirs in zip(port.localized_system.active_mo_inds,
                                ref.localized_system.active_mo_inds):
            np.testing.assert_array_equal(ours, theirs)
    assert [len(i) for i in port.localized_system.active_mo_inds] == [4, 3]


@pytest.mark.parametrize("projector", ["mu", "huzinaga"])
@pytest.mark.parametrize("key", ["e_rhf", "e_ccsd", "e_fci", "classical_energy"])
def test_open_shell_energies_match(drivers, projector, key):
    port, refs = drivers
    ours, theirs = getattr(port, projector), getattr(refs[projector], projector)
    assert abs(ours[key] - theirs[key]) < 1e-8
    assert ours["second_quantised"][1].shape == theirs["second_quantised"][1].shape
