"""The fused J/K build of nbed_tpu_torch against the Pallas kernel of
nbed_tpu (interpret mode on the CPU) and against float64 numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.ops import fused_jk as ref_fused_jk
from nbed_tpu_torch.ops import jk

NAO = 12


def _problem(seed=7, nao=NAO):
    m = nao * nao
    rng = np.random.default_rng(seed)
    g_j = rng.standard_normal((m, m))
    g_k = rng.standard_normal((m, m))
    dm = rng.standard_normal((2, nao, nao))
    return g_j, g_k, dm + dm.swapaxes(-1, -2)


def _numpy_jk(g_j, g_k, dm):
    n = dm.shape[-1]
    j = (g_j @ (dm[0] + dm[1]).reshape(-1)).reshape(n, n)
    k = (g_k @ dm.reshape(2, -1).T).T.reshape(2, n, n)
    return j, k


def test_matches_pallas_kernel_f32():
    """Tolerances of tests/test_ops.py:25-26 (float32 in and out)."""
    g_j, g_k, dm = _problem()
    j_ref, k_ref = ref_fused_jk(jnp.asarray(g_j), jnp.asarray(g_k), jnp.asarray(dm),
                                tile_m=128, tile_c=128, interpret=True)
    j, k = jk.fused_jk(*(torch.tensor(a, dtype=torch.float32) for a in (g_j, g_k, dm)))
    assert j.dtype == torch.float32 and k.shape == (2, NAO, NAO)
    np.testing.assert_allclose(j.numpy(), np.asarray(j_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), rtol=1e-5, atol=1e-4)


def test_matches_numpy_f64():
    g_j, g_k, dm = _problem(seed=3)
    j_np, k_np = _numpy_jk(g_j, g_k, dm)
    j, k = jk.fused_jk(*(torch.tensor(a) for a in (g_j, g_k, dm)))
    np.testing.assert_allclose(j.numpy(), j_np, rtol=0, atol=1e-12)
    np.testing.assert_allclose(k.numpy(), k_np, rtol=0, atol=1e-12)


def test_cpu_tensors_take_plain_version_without_launch():
    before = jk.LAUNCHES["fused_jk"]
    jk.fused_jk(*(torch.tensor(a) for a in _problem(nao=3)))
    assert jk.LAUNCHES["fused_jk"] == before


@pytest.mark.parametrize("case", ["shape", "device"])
def test_kernel_argument_checks(case):
    g_j, g_k, dm = (torch.tensor(a) for a in _problem(nao=3))
    if case == "shape":
        with pytest.raises(ValueError, match="g_j must be"):
            jk._check(g_j[:-1], g_k, dm)
    else:
        with pytest.raises(ValueError, match="CUDA device"):
            jk._check(g_j, g_k, dm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float64, 1e-12, 1e-10),
                                             (torch.float32, 1e-5, 1e-4)])
def test_cuda_kernel_matches_plain(dtype, rtol, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g_j, g_k, dm = (torch.tensor(a, dtype=dtype, device="cuda") for a in _problem())
    before = jk.LAUNCHES["fused_jk"]
    j, k = jk.fused_jk(g_j, g_k, dm)
    j_ref, k_ref = jk.fused_jk_reference(g_j, g_k, dm)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["fused_jk"] == before + 1
    torch.testing.assert_close(j, j_ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(k, k_ref, rtol=rtol, atol=atol)
