"""Density fitting of nbed_tpu_torch against nbed_tpu: the auxiliary basis
and its f/g harmonics, the DF integrals and factor, DF J/K, DF-SCF
energies, the DF Hamiltonian builder and the water driver with DF on.

B itself is fixed only up to a rotation of the auxiliary axis (eigenvector
freedom of the metric eigh), so factors are compared through B B^T."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu import native as ref_native
from nbed_tpu.chem import build_molecule as ref_build_molecule
from nbed_tpu.chem.basis.auxiliary import make_auxiliary_molecule as ref_make_aux
from nbed_tpu.chem.molecule import _solid_harmonic_table as ref_harmonics
from nbed_tpu.config import NbedConfig as RefConfig
from nbed_tpu.driver import NbedDriver as RefDriver
from nbed_tpu.ham import HamiltonianBuilder as RefBuilder
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu.scf.engine import _df_k_spin as ref_df_k_spin
from nbed_tpu.scf.engine import df_b_factor as ref_df_b_factor
from nbed_tpu_torch import NbedConfig
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.chem.basis.auxiliary import make_auxiliary_molecule
from nbed_tpu_torch.chem.molecule import _solid_harmonic_table
from nbed_tpu_torch.driver import NbedDriver
from nbed_tpu_torch.ham import HamiltonianBuilder
from nbed_tpu_torch.integrals import native
from nbed_tpu_torch.interop import molecule_from_reference, solution_from_reference
from nbed_tpu_torch.scf import SCFEngine
from nbed_tpu_torch.scf.engine import _df_k_spin, df_b_factor

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

MOLECULES = Path(__file__).parent / "molecules"
# exact (non-DF) water oracles, UHF and UKS/B3LYP (tests/test_driver.py:18,31)
E_UHF = -74.96099960129165
E_UKS = -75.3091447400438


@pytest.fixture(scope="module")
def water(water_molecule):
    return molecule_from_reference(water_molecule)


@pytest.fixture(scope="module")
def factors(water_molecule, water):
    """(reference B (nao, nao, naux), port B (nao, naux, nao)) on water."""
    return (ref_df_b_factor(water_molecule, np.asarray(water_molecule.coords)),
            df_b_factor(water, device="cpu").numpy())


@pytest.mark.parametrize("l_max_factor", [3, 1])
@pytest.mark.parametrize("scheme", ["global", "product"])
@pytest.mark.parametrize("name", ["water", "pfoa"])
def test_auxiliary_molecule_matches_reference(name, scheme, l_max_factor):
    xyz = (MOLECULES / f"{name}.xyz").read_text()
    kw = dict(scheme=scheme, l_max_factor=l_max_factor)
    ref = ref_make_aux(ref_build_molecule(xyz, "sto-3g"), **kw)
    ours = make_auxiliary_molecule(build_molecule(xyz, "sto-3g"), **kw)
    assert ours.nao == ref.nao
    assert [(s.atom, s.l, s.exps, s.ao_offset) for s in ours.shells] == \
        [(s.atom, s.l, s.exps, s.ao_offset) for s in ref.shells]
    if (name, scheme, l_max_factor) == ("pfoa", "global", 3):
        assert ours.nao == 5150 and max(s.l for s in ours.shells) == 4


@pytest.mark.parametrize("l", [0, 1, 2, 3, 4])
def test_solid_harmonics_span_reference(l):
    """The port's exact solid harmonics span the reference's fitted ones:
    every reference column projects onto the port's columns with residual
    below 1e-12 (the two differ only in sign and scale at l > 2)."""
    ref, ours = ref_harmonics(l), _solid_harmonic_table(l)
    assert ours.shape == ref.shape == ((l + 1) * (l + 2) // 2, 2 * l + 1)
    q, r = np.linalg.qr(ours)
    assert np.abs(np.diag(r)).min() > 1e-3  # full rank
    assert np.abs(ref - q @ (q.T @ ref)).max() < 1e-12


def test_df_integrals_match_reference_native(water_molecule, water):
    """eri_3c (threaded over auxiliary blocks) and eri_2c on the
    reference's own auxiliary molecule."""
    aux = ref_make_aux(water_molecule)
    b3 = native.eri_3c(water, molecule_from_reference(aux))
    m2 = native.eri_2c(molecule_from_reference(aux))
    np.testing.assert_allclose(b3, ref_native.eri_3c(water_molecule, aux),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(m2, ref_native.eri_2c(aux), rtol=0, atol=1e-12)


def test_df_factor_matches_reference_and_exact(factors, water):
    ref_b, b = factors
    assert b.shape == (ref_b.shape[0], ref_b.shape[2], ref_b.shape[1])
    eri_df = np.einsum("aPb,cPd->abcd", b, b)
    np.testing.assert_allclose(eri_df, np.einsum("abP,cdP->abcd", ref_b, ref_b),
                               rtol=0, atol=1e-10)
    # the exact-ERI bounds of tests/test_df.py:28-29
    err = np.abs(native.eri(water) - eri_df)
    assert err.max() < 5e-5
    assert np.sqrt((err ** 2).mean()) < 5e-6


def test_df_k_chunked_matches_unblocked_and_reference():
    """Chunked K over a seeded factor with 700 auxiliary functions: three
    blocks of 256, the last one short, against one block and against
    nbed_tpu's padded fori_loop on the same B and D."""
    rng = np.random.default_rng(3)
    nao, naux = 9, 700
    b = rng.standard_normal((nao, naux, nao))
    b = b + b.transpose(2, 1, 0)
    d = rng.standard_normal((nao, nao))
    d = d + d.T
    k_ref = np.asarray(ref_df_k_spin(jnp.asarray(b.transpose(0, 2, 1)),
                                     jnp.asarray(d), chunk_elems=nao * nao * 7))
    bt, dt = torch.tensor(b), torch.tensor(d)
    k_one = _df_k_spin(bt, dt, chunk_elems=nao * nao * naux).numpy()
    k_chunked = _df_k_spin(bt, dt, chunk_elems=nao * nao * 7).numpy()
    np.testing.assert_allclose(k_chunked, k_one, rtol=0, atol=1e-10)
    np.testing.assert_allclose(k_chunked, k_ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.einsum("iPk,kl,jPl->ij", b, d, b), k_one,
                               rtol=0, atol=1e-10)


def test_df_jk_matches_reference_on_one_factor(factors, water):
    """get_jk of a DF engine given nbed_tpu's factor, against nbed_tpu's
    DF J/K on the same factor and density."""
    ref_b, _ = factors
    rng = np.random.default_rng(5)
    dm = rng.standard_normal((2, water.nao, water.nao))
    dm = dm + dm.swapaxes(-1, -2)
    ref_eng = RefEngine(ref_build_molecule((MOLECULES / "water.xyz").read_text(),
                                           "sto-3g"), density_fitting=True)
    j_ref, k_ref = ref_eng._df_jk_from(jnp.asarray(ref_b), None, jnp.asarray(dm))
    eng = SCFEngine(water, density_fitting=True, device="cpu",
                    df_b=torch.tensor(np.moveaxis(ref_b, -1, 1)))
    j, k = eng.get_jk(torch.tensor(dm))
    np.testing.assert_allclose(j.numpy(), np.asarray(j_ref), rtol=0, atol=1e-10)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def ref_df_uhf(water_molecule):
    return RefEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                     max_cycle=100, density_fitting=True).kernel()


@pytest.fixture(scope="module")
def df_drivers(nbed_args):
    """(nbed_tpu, port) drivers of the conftest water config with DF on and
    both projectors."""
    args = {**nbed_args, "projector": "both", "density_fitting": True}
    ref = RefDriver(RefConfig(**args))
    ref.embed()
    ours = NbedDriver(NbedConfig(**args), device="cpu")
    ours.embed()
    return ref, ours


@pytest.mark.parametrize("method", ["uhf", "b3lyp"])
def test_df_scf_energies(water, ref_df_uhf, df_drivers, method):
    """DF-UHF and DF-B3LYP (the DF drivers' global UKS) on water: within
    1e-8 of nbed_tpu's DF engine and within 1e-5 of the exact oracle
    energies (tests/test_df.py:38,61; tests/test_driver.py:18,31)."""
    if method == "uhf":
        ours = SCFEngine(water, density_fitting=True, device="cpu", conv_tol=1e-10,
                         dm_conv_tol=1e-8, max_cycle=100).kernel()
        ref, exact = ref_df_uhf, E_UHF
    else:
        ref, ours = df_drivers[0]._global_ks, df_drivers[1]._global_ks
        exact = E_UKS
    assert ours.converged and ref.converged
    assert abs(ours.e_tot - ref.e_tot) < 1e-8
    assert abs(ours.e_tot - exact) < 1e-5


def test_df_builder_blocks_match_reference(ref_df_uhf):
    """MO two-body blocks from the DF factor on a carried solution (the
    reference's factor goes across with it)."""
    ref = RefBuilder(ref_df_uhf, 0.0)._two_body_integrals()
    sol = solution_from_reference(ref_df_uhf, device="cpu")
    assert sol.engine.density_fitting
    ours = HamiltonianBuilder(sol, 0.0)._two_body_integrals()
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("projector", ["mu", "huzinaga"])
@pytest.mark.parametrize("key", ["e_rhf", "e_ccsd", "e_fci", "classical_energy",
                                 "hf_emb", "correction", "beta_correction"])
def test_df_driver_matches_nbed_tpu(df_drivers, projector, key):
    ref, ours = df_drivers
    assert ours._use_df and ref._use_df
    assert abs(float(getattr(ours, projector)[key])
               - float(getattr(ref, projector)[key])) < 1e-8


def test_df_driver_shares_one_factor(df_drivers):
    _, ours = df_drivers
    assert ours._hf_engine.df_b is ours._ks_engine.df_b


@pytest.mark.parametrize("name,expected", [("water", False), ("pfoa", True)])
def test_use_df_from_molecule_alone(name, expected):
    """nao >= 96 turns DF on by itself (pfoa: 126 AOs); nothing is
    integrated to decide it."""
    cfg = NbedConfig(geometry=str(MOLECULES / f"{name}.xyz"), n_active_atoms=4,
                     basis="STO-3G", xc_functional="b3lyp")
    driver = NbedDriver(cfg, device="cpu")
    assert driver._use_df is expected
    assert RefDriver(RefConfig(**cfg.as_dict()))._use_df is expected


@pytest.mark.parametrize("max_memory_mb,elems", [(4000.0, 20_000_000),
                                                 (8000.0, 40_000_000),
                                                 (1.0, 1_000_000)])
def test_memory_budget_scales_like_reference(water_molecule, water,
                                             max_memory_mb, elems):
    """max_ram_memory bounds the exchange intermediate and the XC tables as
    in nbed_tpu: 2e7 elements and 1e8 at 4000 MB, linear in the budget,
    the DF chunk never below 1e6."""
    eng = SCFEngine(water, density_fitting=True, device="cpu",
                    max_memory_mb=max_memory_mb)
    ref = RefEngine(water_molecule, max_memory_mb=max_memory_mb)
    assert eng._df_chunk_elems == ref._df_chunk_elems == elems
    assert eng._XC_TABLE_LIMIT == ref._XC_TABLE_LIMIT
