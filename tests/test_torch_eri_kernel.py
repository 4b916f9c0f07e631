"""The ERI kernel of nbed_tpu_torch (``csrc/md_eri.cu``, ``ops/eri.py``): its
index tables and write rule on the CPU, the kernel itself on a card.

A CUDA kernel has no CPU mode, so on the CPU the tests hold what surrounds
it: the tables it reads (shells, shell pairs, primitive pairs, canonical
quartets) and :func:`ops.eri.owners`, the numpy form of the kernel's rule
for which block element writes each element of the output. Filling the
nao^4 tensor from the host engine's values at the canonical positions
through that rule must give ``integrals.native.eri`` exactly, with one write
per element. ``cuda``-marked tests hold the kernel against the host engine
on a card. Nothing here imports ``nbed_tpu`` or JAX, so ``pytest
--noconftest -m cuda tests/test_torch_eri_kernel.py`` runs on a machine
without them.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nbed_tpu_torch import nbed
from nbed_tpu_torch.chem import build_molecule
from nbed_tpu_torch.integrals import eri_tensor, native
from nbed_tpu_torch.integrals.eri import _device_tables, eri_program, eri_torch
from nbed_tpu_torch.ops import eri as md_eri
from nbed_tpu_torch.scf import SCFEngine

torch.set_num_threads(1)

MOLECULES = Path(__file__).resolve().parent / "molecules"
CASES = {"acetonitrile": ("acetonitrile.xyz", "sto-3g"),
         "water_ccpvdz": ("water.xyz", "cc-pvdz")}
# the benchmark's acetonitrile embedding, without the post-embedding solvers
PRA = dict(n_active_atoms=2, basis="STO-3G", xc_functional="b3lyp", projector="huzinaga",
           localization="spade", run_ccsd_emb=False, run_fci_emb=False)
# the host engine's agreement with the kernel: rounding of float64 sums
# taken in another order (and the host's Schwarz screening below 1e-14)
TOL = 1e-12


def _mol(case):
    name, basis = CASES[case]
    return build_molecule((MOLECULES / name).read_text(), basis)


def _canonical_values(tab, full):
    """Each canonical quartet's spherical block read from ``full`` at its
    own position, concatenated in ``tab.quartets``' order."""
    vals = []
    for bra, ket in tab.quartets:
        sh = (*tab.pairs[bra, :2], *tab.pairs[ket, :2])
        block = tuple(slice(tab.shells[s, 3], tab.shells[s, 3] + 2 * tab.shells[s, 0] + 1)
                      for s in sh)
        vals.append(full[block].ravel())
    return np.concatenate(vals)


@pytest.mark.parametrize("case", list(CASES))
def test_owners_fill_native_exactly(case):
    """Every element of the output has exactly one writer, and filling the
    tensor from the host engine's canonical values through the kernel's
    rule reproduces the host engine's tensor bit for bit."""
    mol = _mol(case)
    tab = md_eri.tables(mol)
    source, writes = md_eri.owners(tab)
    assert (writes == 1).all()
    ref = native.eri(mol)
    filled = _canonical_values(tab, ref)[source].reshape(ref.shape)
    assert np.array_equal(filled, ref)


@pytest.mark.parametrize("case", list(CASES))
def test_tables_list_every_canonical_quartet_once(case):
    """Pairs a >= b in pair order, primitive pairs i-major with their
    pairs' first entries, each canonical quartet (ab) >= (cd) once, the
    heaviest first, and a block's shared memory within 48 KB."""
    mol = _mol(case)
    tab = md_eri.tables(mol)
    nsh = len(mol.shells)
    a, b = np.tril_indices(nsh)
    assert np.array_equal(tab.pairs[:, :2], np.stack([a, b], axis=1))
    nprim = tab.shells[:, 1]
    sizes = nprim[tab.pairs[:, 0]] * nprim[tab.pairs[:, 1]]
    assert np.array_equal(tab.pairs[:, 2], np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    for p, (i, j) in zip(tab.prim_pairs[:, 0], tab.prim_pairs[:, 1:]):
        assert 0 <= i < nprim[tab.pairs[p, 0]] and 0 <= j < nprim[tab.pairs[p, 1]]
    first = tab.prim_pairs[tab.pairs[:, 2]]
    assert np.array_equal(first, np.stack([np.arange(len(a)), 0 * a, 0 * a], axis=1))
    npair = len(a)
    assert len(tab.quartets) == npair * (npair + 1) // 2
    assert (tab.quartets[:, 0] >= tab.quartets[:, 1]).all()
    assert len({tuple(q) for q in tab.quartets}) == len(tab.quartets)
    ncart = (tab.shells[:, 0] + 1) * (tab.shells[:, 0] + 2) // 2
    weight = sizes * ncart[tab.pairs[:, 0]] * ncart[tab.pairs[:, 1]]
    cost = weight[tab.quartets[:, 0]] * weight[tab.quartets[:, 1]]
    assert (np.diff(cost) <= 0).all()
    assert md_eri.covers(mol)
    assert tab.launch_sizes()["smem_bytes"] <= 48 * 1024
    assert md_eri.tables(_mol(case)) is tab  # cached by structure, not by object


def test_cpu_keeps_every_route():
    """On the CPU nothing launches the kernel: the engine takes the host
    engine's ERIs once a request, ``eri_tensor`` keeps its torch
    arithmetic (``eri_torch``), bit for bit, and :func:`ops.eri.eri`
    refuses CPU tensors."""
    launches = md_eri.LAUNCHES.copy()
    args = dict(PRA, geometry=(MOLECULES / "water.xyz").read_text(), n_active_atoms=1)
    nbed(**args, device="cpu")  # the SAD guess's atoms integrate once per process
    before = native.CALLS.copy()
    nbed(**args, device="cpu")
    assert native.CALLS - before == {"one_electron": 1, "eri": 1}
    mol = build_molecule((MOLECULES / "water.xyz").read_text(), "sto-3g")
    x = torch.as_tensor(mol.coords, dtype=torch.float64)
    assert torch.equal(eri_tensor(mol, x, omega=0.33, device="cpu"),
                       eri_torch(mol, x, _device_tables(mol, x.device), 2**22, 0.33))
    with pytest.raises(ValueError, match="CUDA tensors"):
        md_eri.eri(mol, x, 0.33)
    assert md_eri.LAUNCHES == launches


def test_operations_count_the_contraction():
    """The contraction's operations: (ss|ss) two a primitive quartet (one
    multiply-add), STO-3G water's 120 quartets summed by class."""
    h2 = build_molecule("2\n\nH 0 0 0\nH 0 0 0.74", "sto-3g")
    assert md_eri.operations(md_eri.tables(h2)) == 2 * 2 * 6 * 81
    water = md_eri.tables(build_molecule((MOLECULES / "water.xyz").read_text(), "sto-3g"))
    assert md_eri.operations(water, batch=3) == 3 * md_eri.operations(water)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _jittered(mol, lanes, seed=3):
    rng = np.random.default_rng(seed)
    return np.stack([mol.coords + rng.normal(0.0, 0.02, mol.coords.shape)
                     for _ in range(lanes)])


@pytest.mark.cuda
@pytest.mark.parametrize("case,omega,lanes", [("water_ccpvdz", None, 0),
                                              ("acetonitrile", None, 0),
                                              ("acetonitrile", 0.33, 0),
                                              ("acetonitrile", None, 3)])
def test_cuda_kernel_matches_native(case, omega, lanes):
    """The kernel against the host engine within 1e-12 absolute: d shells,
    acetonitrile/STO-3G, the erf-attenuated kernel, three jittered lanes at
    once."""
    _cuda()
    mol = _mol(case)
    coords = mol.coords[None] if lanes == 0 else _jittered(mol, lanes)
    x = torch.as_tensor(coords if lanes else coords[0], device="cuda")
    ours = md_eri.eri(mol, x, omega).cpu().numpy().reshape((len(coords),) + (mol.nao,) * 4)
    for lane, c in enumerate(coords):
        ref = native.eri(mol, c, omega=omega or 0.0)
        assert np.abs(ours[lane] - ref).max() <= TOL


@pytest.mark.cuda
def test_cuda_graph_replay_is_bitwise_eager():
    """A captured graph of the kernel replays bitwise equal to an eager
    launch, at new coordinates copied into its input."""
    _cuda()
    mol = _mol("acetonitrile")
    coords = torch.as_tensor(_jittered(mol, 2), device="cuda")
    x = coords[0].clone()
    md_eri.eri(mol, x)  # builds, loads and copies the tables outside the capture
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph):
        out = md_eri.eri(mol, x)
    torch.cuda.current_stream().wait_stream(stream)
    x.copy_(coords[1])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, md_eri.eri(mol, coords[1]))


@pytest.mark.cuda
def test_cuda_routes_take_the_kernel_where_they_carry_no_derivative():
    """``eri_tensor`` and the "eri" program take the kernel on the card;
    coordinates that require grad keep the torch arithmetic, which autograd
    passes through."""
    _cuda()
    mol = _mol("acetonitrile")
    x = torch.as_tensor(mol.coords, device="cuda")
    eri_program(mol, x)  # captured here, or already in the process's program cache
    before = md_eri.LAUNCHES["md_eri"]
    plain = eri_tensor(mol, x)
    program = eri_program(mol, x)  # one replay
    assert md_eri.LAUNCHES["md_eri"] == before + 2
    assert torch.equal(plain, program)
    assert (plain - torch.as_tensor(native.eri(mol), device="cuda")).abs().max() <= TOL
    leaf = x.clone().requires_grad_(True)
    grad_route = eri_tensor(mol, leaf)
    assert grad_route.requires_grad and md_eri.LAUNCHES["md_eri"] == before + 2
    assert (grad_route.detach() - plain).abs().max() <= TOL


@pytest.mark.cuda
def test_cuda_warm_nbed_launches_once_and_skips_the_host_eri():
    """A warm acetonitrile nbed() on the card makes no host ERI call and
    one kernel call, which the embedded HF shares with the global KS; the
    "native" backend keeps the host engine."""
    _cuda()
    args = dict(PRA, geometry=(MOLECULES / "acetonitrile.xyz").read_text())
    nbed(**args, device="cuda")
    eri_calls, launches = native.CALLS["eri"], md_eri.LAUNCHES["md_eri"]
    nbed(**args, device="cuda")
    assert native.CALLS["eri"] == eri_calls
    assert md_eri.LAUNCHES["md_eri"] == launches + 1
    mol = _mol("acetonitrile")
    host = SCFEngine(mol, device="cuda", integrals_backend="native")
    card = SCFEngine(mol, device="cuda")
    assert (host.eri - card.eri).abs().max() <= TOL
    assert native.CALLS["eri"] == eri_calls + 1
