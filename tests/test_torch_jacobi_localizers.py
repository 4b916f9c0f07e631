"""The Jacobi-sweep localizers (Pipek-Mezey, Boys, IBO), PAO, ACE and
concentric localization onto another basis of nbed_tpu_torch against
nbed_tpu on water/6-31G B3LYP, both fed the same SCF state.

Jacobi sweeps converge from their starting orbitals and SVD/eigh columns
carry sign and rotation freedom, so the tests compare index sets, densities,
span projectors and shell sizes, never columns.
"""

import numpy as np
import pytest
import torch

from nbed_tpu.localizers import ACELocalizer as RefACE
from nbed_tpu.localizers import BOYSLocalizer as RefBoys
from nbed_tpu.localizers import ConcentricLocalizer as RefCL
from nbed_tpu.localizers import IBOLocalizer as RefIBO
from nbed_tpu.localizers import PAOLocalizer as RefPAO
from nbed_tpu.localizers import PMLocalizer as RefPM
from nbed_tpu.localizers import SPADELocalizer as RefSPADE
from nbed_tpu_torch.interop import solution_from_reference
from nbed_tpu_torch.localizers import (ACELocalizer, BOYSLocalizer, ConcentricLocalizer,
                                       IBOLocalizer, PAOLocalizer, PMLocalizer,
                                       SPADELocalizer, check_values)
from test_torch_localizers import uks631g  # noqa: F401  (module-scoped fixture)

torch.set_num_threads(1)

LOCALIZERS = {"pm": (PMLocalizer, RefPM), "boys": (BOYSLocalizer, RefBoys),
              "ibo": (IBOLocalizer, RefIBO)}


@pytest.fixture(scope="module")
def sol631g(uks631g):  # noqa: F811
    return solution_from_reference(uks631g, "cpu")


@pytest.fixture(scope="module", params=sorted(LOCALIZERS))
def jacobi_pair(request, uks631g, sol631g):  # noqa: F811
    ours, theirs = LOCALIZERS[request.param]
    return ours(sol631g, 1).localize(), theirs(uks631g, 1).localize()


def _span_projector(c, s):
    """S-orthogonal projector onto the span of the columns of ``c``."""
    return c @ np.linalg.pinv(c.T @ s @ c, rcond=1e-10, hermitian=True) @ c.T @ s


def test_jacobi_active_sets_and_densities_match(jacobi_pair):
    ours, theirs = jacobi_pair
    np.testing.assert_array_equal(ours.active_mo_inds, theirs.active_mo_inds)
    np.testing.assert_array_equal(ours.enviro_mo_inds, theirs.enviro_mo_inds)
    for name in ("dm_active", "dm_enviro", "dm_loc_occ"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(theirs, name)), rtol=0, atol=1e-8)


def test_jacobi_check_values(jacobi_pair, sol631g):
    check_values(jacobi_pair[0], sol631g)


@pytest.mark.parametrize("name", sorted(LOCALIZERS))
@pytest.mark.parametrize("field", ["occ_cutoff", "virt_cutoff"])
def test_jacobi_threshold_validation(sol631g, uks631g, name, field):  # noqa: F811
    """Thresholds outside [0, 1] raise ValueError in both packages."""
    ours, theirs = LOCALIZERS[name]
    for cls, sol in ((ours, sol631g), (theirs, uks631g)):
        with pytest.raises(ValueError, match="not in range"):
            cls(sol, 1, **{field: 1.5})


def test_ace_localizer(uks631g, sol631g):  # noqa: F811
    """ACE-of-SPADE gives (3, 3), as in the reference
    (tests/test_localizers.py:133-138)."""
    ours = ACELocalizer([sol631g] * 3, 1).localize_path()
    assert ours == RefACE([uks631g] * 3, 1).localize_path() == (3, 3)


def test_pao_span_matches_reference(uks631g, sol631g):  # noqa: F811
    """PAOs of the SPADE occupied space: the same span to 1e-10 and no
    overlap with the occupied space."""
    loc = SPADELocalizer(sol631g, 1).localize()
    ours = PAOLocalizer(sol631g, 1, loc.c_loc_occ).localize_virtual()
    theirs = np.asarray(RefPAO(uks631g, 1, RefSPADE(uks631g, 1).localize().c_loc_occ)
                        .localize_virtual())
    assert tuple(ours.shape) == theirs.shape and ours.shape[-1] > 0
    s = sol631g.engine.s
    for spin in (0, 1):
        np.testing.assert_allclose(_span_projector(ours[spin].numpy(), s.numpy()),
                                   _span_projector(theirs[spin], s.numpy()),
                                   rtol=0, atol=1e-10)
        assert float(torch.max(torch.abs(loc.c_loc_occ[spin].T @ s @ ours[spin]))) < 1e-10


def test_cl_projected_basis_matches_reference(uks631g, sol631g):  # noqa: F811
    """CL onto STO-3G (cross-basis overlaps): the reference's shells, and each
    shell's span to 1e-10."""
    theirs = RefCL(uks631g.copy(), 1, projected_basis="sto-3g")
    c_ref = np.asarray(theirs.localize_virtual().mo_coeff)
    ours = ConcentricLocalizer(solution_from_reference(uks631g, "cpu"), 1,
                               projected_basis="sto-3g")
    c = ours.localize_virtual().mo_coeff.numpy()
    assert ours.shells == tuple(theirs.shells) and c.shape == c_ref.shape
    assert ours.n_act_proj_aos == theirs.n_act_proj_aos == 5
    s = sol631g.engine.s.numpy()
    for spin in (0, 1):
        bounds = [0] + list(ours.shells[spin])
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            np.testing.assert_allclose(_span_projector(c[spin][:, lo:hi], s),
                                       _span_projector(c_ref[spin][:, lo:hi], s),
                                       rtol=0, atol=1e-10)
