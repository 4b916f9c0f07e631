"""ROHF/ROKS of nbed_tpu_torch (Roothaan's effective Fock) against
nbed_tpu, and the identities of tests/test_rohf.py: shared spatial
orbitals, <S^2> = 0.75 for the methyl radical doublet, and closed-shell
ROHF = UHF on water."""

from pathlib import Path

import numpy as np
import pytest
import torch

from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu_torch.interop import molecule_from_reference
from nbed_tpu_torch.scf import SCFEngine

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

METHYL = (Path(__file__).parent / "molecules" / "methyl_radical.xyz").read_text()
SETTINGS = {  # tests/test_rohf.py's settings for each method
    None: dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100),
    "b3lyp": dict(conv_tol=1e-9, dm_conv_tol=1e-7, max_cycle=100),
}


@pytest.fixture(scope="module")
def methyl():
    return ref_build_molecule(METHYL, "sto-3g", spin=1)


@pytest.fixture(scope="module", params=[None, "b3lyp"], ids=["rohf", "roks"])
def pair(request, methyl):
    xc = request.param
    kw = dict(xc=xc, rohf=True, **SETTINGS[xc])
    ref = RefEngine(methyl, **kw).kernel()
    ours = SCFEngine(molecule_from_reference(methyl), device="cpu", **kw).kernel()
    return ours, ref


def test_energy_matches_reference(pair):
    ours, ref = pair
    assert ours.converged and ref.converged
    assert abs(ours.e_tot - ref.e_tot) < 1e-8
    np.testing.assert_allclose(ours.make_rdm1().numpy(), ref.make_rdm1(), atol=1e-7)


def test_spin_pure_shared_orbitals(pair):
    ours, _ = pair
    torch.testing.assert_close(ours.mo_coeff[0], ours.mo_coeff[1], rtol=0, atol=1e-12)
    assert abs(ours.spin_square()[0] - 0.75) < 1e-10


def test_closed_shell_rohf_equals_uhf(water_molecule, water_uhf):
    rohf = SCFEngine(molecule_from_reference(water_molecule), rohf=True,
                     device="cpu", **SETTINGS[None]).kernel()
    assert rohf.converged
    assert abs(rohf.e_tot - water_uhf.e_tot) < 1e-9


def test_stationarity_blocks(methyl):
    """The converged ROHF equations (tests/test_rohf.py:66-84): F_beta
    (closed, open), F_alpha (open, virtual) and F_c (closed, virtual) vanish
    in the shared MO basis."""
    eng = SCFEngine(molecule_from_reference(methyl), rohf=True, device="cpu",
                    conv_tol=1e-12, dm_conv_tol=1e-10, max_cycle=200)
    sol = eng.kernel()
    assert sol.converged
    na, nb = sol.nelec
    c = sol.mo_coeff[0]
    j, k = eng.get_jk(sol.make_rdm1())
    f = eng.hcore[None] + j[None] - k
    fa, fb = c.T @ f[0] @ c, c.T @ f[1] @ c
    fc = 0.5 * (fa + fb)
    assert float(torch.max(torch.abs(fb[:nb, nb:na]))) < 1e-6
    assert float(torch.max(torch.abs(fa[nb:na, na:]))) < 1e-6
    assert float(torch.max(torch.abs(fc[:nb, na:]))) < 1e-6
