"""The capturable eigh of nbed_tpu_torch (``ops/eigh.py``) against
nbed_tpu's ``eigh_refined`` (float64 CPU), at the SCF's shapes: both spins'
Fock matrices of water (n = 7) and acetonitrile (n = 18) in one call, and the
DIIS system (n = diis_space + 1 = 9).

On the CPU the wrapper takes its plain version, ``torch.linalg.eigh``; a
``cuda``-marked test holds the cuSOLVER call against it on a card.
Eigenvalues are compared at 1e-12 relative to the largest, eigenvectors
only through the projector onto the lower half (they are free up to sign,
and up to rotation within a degenerate space).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbed_tpu.scf.hf import eigh_refined
from nbed_tpu_torch.ops import eigh as eigh_ops

# one torch thread per test process (see the other torch test files)
torch.set_num_threads(1)

SHAPES = [(2, 7), (2, 18), (1, 9)]


def _symmetric(batch, n, seed):
    a = np.random.default_rng(seed).standard_normal((batch, n, n))
    return a + a.swapaxes(-1, -2)


def _projector(v, k):
    return v[..., :k] @ np.swapaxes(v[..., :k], -1, -2)


@pytest.mark.parametrize("batch,n", SHAPES)
def test_eigh_matches_reference(batch, n):
    a = _symmetric(batch, n, seed=n)
    w, v = eigh_ops.eigh(torch.tensor(a))
    for b in range(batch):
        w_ref, v_ref = (np.asarray(t) for t in eigh_refined(jnp.asarray(a[b])))
        assert np.max(np.abs(w[b].numpy() - w_ref)) <= 1e-12 * np.max(np.abs(w_ref))
        np.testing.assert_allclose(_projector(v[b].numpy(), n // 2), _projector(v_ref, n // 2),
                                   atol=1e-10)


def test_eigh_reads_the_lower_triangle():
    """As torch.linalg.eigh (and the kernel, which asks cuSOLVER for the
    column-major upper triangle) the lower triangle is what counts."""
    a = _symmetric(2, 7, seed=1)
    skewed = a + np.triu(np.ones((7, 7)), 1)
    w, _ = eigh_ops.eigh(torch.tensor(skewed))
    w_ref, _ = eigh_ops.eigh(torch.tensor(a))
    assert torch.equal(w, w_ref)


def test_eigh_prepares_cuda_only():
    with pytest.raises(ValueError):
        eigh_ops.Eigh(7, 2, torch.float64, "cpu")
    with pytest.raises(TypeError):
        eigh_ops.Eigh(7, 2, torch.int64, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n", SHAPES + [(2, 126)])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float64, 1e-12, 1e-10),
                                             (torch.float32, 1e-5, 1e-4)])
def test_cuda_eigh_matches_plain_and_replays(batch, n, dtype, rtol, atol):
    """The cuSOLVER call against torch.linalg.eigh of the same matrices in
    float64 on the card (torch's own float32 eigh misses float64 by 3.2e-5
    relative at n = 126 there, cuSOLVER's by 6.4e-7), one launch counted
    per call, no failure, and a CUDA-graph replay bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cuSOLVER call has no CPU mode)")
    a = torch.tensor(_symmetric(batch, n, seed=n), dtype=dtype, device="cuda")
    key = "eigh_f64" if dtype == torch.float64 else "eigh_f32"
    before = eigh_ops.LAUNCHES[key]
    w, v = eigh_ops.eigh(a)
    assert eigh_ops.LAUNCHES[key] == before + 1
    w_ref, v_ref = torch.linalg.eigh(a.to(torch.float64))
    assert float(torch.max(torch.abs(w - w_ref))) <= rtol * float(torch.max(torch.abs(w_ref)))
    k = n // 2
    proj = v[..., :k] @ v[..., :k].mT - v_ref[..., :k] @ v_ref[..., :k].mT
    assert float(torch.max(torch.abs(proj))) <= atol
    assert int(eigh_ops.failure_count(a.device)) == 0
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        w_g, v_g = eigh_ops.eigh(a)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(w_g, w) and torch.equal(v_g, v)


def _converged_diis_system(batch: int, seed: int = 5):
    """The bordered DIIS matrices [[E E^T, 1], [1, 0]] of a nearly
    converged SCF: eight error vectors of norm ~1e-8, so the Gram block
    sits at rounding level beside the border of ones."""
    e = 1e-8 * np.random.default_rng(seed).standard_normal((batch, 8, 98))
    big = np.zeros((batch, 9, 9))
    big[:, :8, :8] = e @ np.swapaxes(e, -1, -2)
    big[:, :8, 8] = big[:, 8, :8] = 1.0
    return big


def test_eigh_retry_is_the_plain_eigh_on_the_cpu():
    a = torch.tensor(_converged_diis_system(3))
    w, v = eigh_ops.eigh_retry(a)
    w_ref, v_ref = torch.linalg.eigh(a)
    assert torch.equal(w, w_ref) and torch.equal(v, v_ref)


@pytest.mark.cuda
def test_cuda_eigh_retry_solves_a_converged_diis_system():
    """On the card: the retried solve of converged DIIS systems within
    1e-14 of float64 torch.linalg.eigh in eigenvalues and residual, no
    failure counted, and a CUDA-graph replay bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cuSOLVER call has no CPU mode)")
    a = torch.tensor(_converged_diis_system(36), device="cuda")
    eigh_ops.failure_count(a.device).zero_()
    w, v = eigh_ops.eigh_retry(a)
    w_ref, _ = torch.linalg.eigh(a)
    assert float(torch.max(torch.abs(w - w_ref))) <= 1e-14
    assert float(torch.max(torch.abs(a @ v - v * w[:, None, :]))) <= 1e-13
    assert int(eigh_ops.failure_count(a.device)) == 0
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        w_g, v_g = eigh_ops.eigh_retry(a)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(w_g, w) and torch.equal(v_g, v)
