"""The mixed-precision SCF modes of nbed_tpu_torch (float32 warm-up,
incremental float32 J/K with float32 XC on coarse cycles) against nbed_tpu's
float64 energies, within 1e-8 Ha as in tests/test_ops.py:29-51; float32 XC
against nbed_tpu's float32 XC; the float32 J/K of a density change."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.dft.xc import _mask_thresh as ref_mask_thresh
from nbed_tpu.scf.engine import SCFEngine as RefEngine
from nbed_tpu_torch.dft.xc import _mask_thresh
from nbed_tpu_torch.interop import molecule_from_reference
from nbed_tpu_torch.ops import jk
from nbed_tpu_torch.scf import SCFEngine

# one torch thread per test process: under pytest-xdist the OpenMP threads
# of several workers spin on the same cores and slow every worker many-fold
torch.set_num_threads(1)

SCF = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)
MODES = {"warmup_f32": dict(warmup_f32=True),
         "incremental": dict(incremental_jk="on"),
         "both": dict(warmup_f32=True, incremental_jk="on")}


@pytest.fixture(scope="module")
def port_mol(water_molecule):
    return molecule_from_reference(water_molecule)


@pytest.fixture(scope="module")
def ref_f64(water_uhf, water_uks):
    return {None: water_uhf.e_tot, "b3lyp": water_uks.e_tot}


@pytest.fixture
def jk_calls(monkeypatch):
    """Counts of the plain J/K by dtype, the CPU route of every J/K."""
    calls = {torch.float32: 0, torch.float64: 0}
    plain = jk.fused_jk_reference

    def counting(g_j, g_k, dm):
        calls[dm.dtype] += 1
        return plain(g_j, g_k, dm)

    monkeypatch.setattr(jk, "fused_jk_reference", counting)
    return calls


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("xc", [None, "b3lyp"])
def test_mixed_precision_water_matches_f64(port_mol, ref_f64, jk_calls, xc, mode):
    sol = SCFEngine(port_mol, xc=xc, device="cpu", **MODES[mode], **SCF).kernel()
    assert sol.converged
    assert abs(sol.e_tot - ref_f64[xc]) < 1e-8
    # the float32 J/K ran (the warm-up's, or the density changes'), and so
    # did float64 builds (the final SCF, the rebases, the polish)
    assert jk_calls[torch.float32] > 0 and jk_calls[torch.float64] > 0


@pytest.mark.parametrize("xc", [None, "b3lyp"])
def test_incremental_df_matches_df_f64(port_mol, xc):
    """DF engines contract density changes through a float32 cast of the
    factor; the energy is the float64 DF one."""
    f64 = SCFEngine(port_mol, xc=xc, density_fitting=True, device="cpu", **SCF)
    inc = SCFEngine(port_mol, xc=xc, density_fitting=True, df_b=f64.df_factor(),
                    incremental_jk="on", device="cpu", **SCF)
    j, k = inc._jk_fast_fn(f64._sad_guess().to(torch.float32))
    assert j.dtype == k.dtype == torch.float32
    e_f64, e_inc = f64.kernel(), inc.kernel()
    assert e_inc.converged and abs(e_inc.e_tot - e_f64.e_tot) < 1e-8


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_incremental_off_and_auto_run_float64(port_mol, mode):
    eng = SCFEngine(port_mol, incremental_jk=mode, device="cpu")
    assert eng._jk_fast_fn is None and eng._xc_fast_fn is None


def test_incremental_mode_is_validated(port_mol):
    with pytest.raises(ValueError, match="incremental_jk"):
        SCFEngine(port_mol, incremental_jk="yes", device="cpu")


def test_mask_threshold_per_dtype():
    """The reference's CPU masks: 1e-11 in float64, 3e-6 in float32."""
    assert _mask_thresh(torch.float64) == ref_mask_thresh(jnp.float64) == 1e-11
    assert _mask_thresh(torch.float32) == ref_mask_thresh(jnp.float32) == 3e-6


@pytest.mark.parametrize("xc", ["b3lyp", "pbe", "wb97x", "tpss", "scan"])
def test_f32_xc_matches_reference_f32_xc(water_molecule, port_mol, water_uks, xc):
    """One spin-polarised density through both packages' float32
    quadratures: exc within 5e-6 (five float32 ulps of |exc| ~ 9.5) and
    vxc within 5e-6 of nbed_tpu's float32 values, and both within 5e-5 of
    the float64 quadrature, whose 1e-11 mask keeps points the float32 mask
    (3e-6) drops. nbed_tpu's float32 TPSS and SCAN potentials are NaN: its
    clips 1 -+ 1e-15 (spin polarisation) and 1 -+ 1e-9 (SCAN's switch)
    round to 1 in float32; the port clips by float32's epsilon there and
    stays finite."""
    dm = np.asarray(water_uks.make_rdm1())
    dm = np.stack([1.02 * dm[0], 0.98 * dm[1]])
    exc_r, vxc_r = RefEngine(water_molecule, xc=xc)._build_xc(jnp.float32)(
        jnp.asarray(dm, jnp.float32))
    eng = SCFEngine(port_mol, xc=xc, device="cpu")
    exc, vxc = eng._xc_f32(torch.tensor(dm, dtype=torch.float32))
    assert exc.dtype == vxc.dtype == torch.float32
    assert torch.isfinite(vxc).all()
    assert abs(float(exc) - float(exc_r)) < 5e-6
    if xc in ("tpss", "scan"):
        assert np.isnan(np.asarray(vxc_r)).any()
    else:
        np.testing.assert_allclose(vxc.numpy(), np.asarray(vxc_r), rtol=0, atol=5e-6)
    exc64, vxc64 = eng.xc_fn(torch.tensor(dm))
    assert abs(float(exc) - float(exc64)) < 5e-5
    np.testing.assert_allclose(vxc.numpy(), vxc64.numpy(), rtol=0, atol=5e-5)


@pytest.mark.parametrize("xc", ["tpss", "scan"])
def test_meta_gga_warmup_matches_f64(port_mol, xc):
    """The float32 warm-up of a meta-GGA: finite float32 potentials let it
    seed the float64 SCF, which lands on the float64 energy."""
    kw = dict(xc=xc, device="cpu", **SCF)
    e64 = SCFEngine(port_mol, **kw).kernel()
    warm = SCFEngine(port_mol, warmup_f32=True, **kw).kernel()
    assert warm.converged and abs(warm.e_tot - e64.e_tot) < 1e-8


def test_f32_jk_of_density_change_matches_numpy(port_mol, water_uhf):
    """The incremental builds' input: a difference of two densities,
    symmetric and indefinite. J and K are linear in it; the float32 plain
    version matches float64 numpy to float32 accuracy."""
    eng = SCFEngine(port_mol, device="cpu")
    dm1 = np.asarray(water_uhf.make_rdm1())
    dm0 = eng._sad_guess().numpy()
    ddm = dm1 - dm0
    w = np.linalg.eigvalsh(ddm[0])
    assert w.min() < -1e-3 and w.max() > 1e-3
    g_j, g_k = eng.eri_j.numpy(), eng.eri_k.numpy()
    n = ddm.shape[-1]
    j_np = (g_j @ (ddm[0] + ddm[1]).reshape(-1)).reshape(n, n)
    k_np = (g_k @ ddm.reshape(2, -1).T).T.reshape(2, n, n)
    f32 = torch.float32
    j, k = jk.fused_jk(eng.eri_j.to(f32), eng.eri_k.to(f32), torch.tensor(ddm, dtype=f32))
    assert j.dtype == f32
    scale = max(np.abs(j_np).max(), np.abs(k_np).max())
    np.testing.assert_allclose(j.numpy(), j_np, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(k.numpy(), k_np, rtol=0, atol=2e-6 * scale)
    # linear: the difference of the two densities' J equals J of the change
    j1, _ = jk.fused_jk(eng.eri_j, eng.eri_k, torch.tensor(dm1))
    j0, _ = jk.fused_jk(eng.eri_j, eng.eri_k, torch.tensor(dm0))
    np.testing.assert_allclose((j1 - j0).numpy(), j_np, rtol=0, atol=1e-12)
