"""Device meshes, sharded SCF and conformer-batched energies and gradients
(port of ``nbed_tpu/parallel/sharding.py``).

A :class:`Mesh` is a (batch, model) array of torch devices. The reference
lets GSPMD insert the collectives from sharding annotations; torch has no
GSPMD, so here every collective is written out, in one process (the
reference's single controller), with no ``torch.distributed``:

- conformer batches split over the 'batch' axis in contiguous lane groups;
  each group runs as one batched program (lanes, :func:`~nbed_tpu_torch.scf.
  hf.run_scf` over a lane axis) on its device, and results are gathered in
  lane order;
- exact-ERI supermatrices split row-wise over the 'model' axis: each device
  holds a zero-padded (R, M) slab, R = M_pad / n_model, and runs the fused
  J/K kernel on it; the slab outputs are copied to the mesh's first device
  and concatenated (the all-gather), and the pad rows are dropped from the
  small output only;
- density fitting splits the auxiliary axis of the factor B, stored (nao,
  naux, nao) in the port, and DF-KS also the grid points: each slab's J, K,
  exc and Vxc are partial sums, added on the first device (the
  all-reduce). Zero padding is exact: a zero auxiliary function, or a
  point of zero weight and zero AO values, adds nothing.

Every exact-ERI J/K goes through the fused J/K kernel, lanes and slabs
alike (:mod:`nbed_tpu_torch.ops.jk`); DF J/K and XC are torch operations,
as they are XLA in the reference.
"""

import numpy as np
import torch

from .._device import DTYPE, resolve_device
from ..chem.molecule import Molecule
from ..integrals import eri_tensor, overlap
from ..integrals.eri import eri_program
from ..ops.jk import prepare_jk
from ..ops.programs import takes_program
from ..scf.engine import lane_scf, lane_spec
from ..scf.engine import single_scf as _single_scf
from ..solvers.gradients import (_autograd, _energy_functional, _hcore, _w_from_dm,
                                 hf_gradient_program)

__all__ = ["Mesh", "make_mesh", "sharded_scf", "make_sharded_scf", "sharded_df_scf",
           "make_sharded_df_scf", "sharded_df_ks", "make_sharded_df_ks",
           "batched_hf_energies", "batched_hf_gradients", "pad_to_multiple"]


class Mesh:
    """A (batch, model) array of torch devices; ``shape`` maps each axis
    name to its size, as a JAX mesh's does."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict:
        return {"batch": self.devices.shape[0], "model": self.devices.shape[1]}


def make_mesh(n_devices: int | None = None, batch: int = 1, devices=None) -> Mesh:
    """Mesh with ('batch', 'model') axes over the first ``n_devices`` of
    ``devices`` (default: every visible CUDA device).

    ``devices`` may name one device more than once (``["cuda"] * 2``,
    ``["cpu"] * 4``): the port's counterpart of the reference tests' virtual
    8-device CPU mesh. It runs every slab and lane group in turn on the one
    device, so the slab and gather logic runs on a machine with one card or
    none, and says nothing about speed across cards.

    Raises:
        ValueError: when n is not divisible by ``batch``, or exceeds the
            devices given.
    """
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devs:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=")
    else:
        devs = [resolve_device(d) for d in devices]
    n = len(devs) if n_devices is None else n_devices
    if n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch axis {batch}.")
    if n > len(devs):
        raise ValueError(f"make_mesh: {n} devices asked for, {len(devs)} given")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(batch, n // batch))


def pad_to_multiple(x, multiple: int, axes=(0,)):
    """Zero-pad selected axes of ``x`` up to a multiple of ``multiple``."""
    for ax in axes:
        rem = (-x.shape[ax]) % multiple
        if rem:
            shape = list(x.shape)
            shape[ax] = rem
            x = torch.cat([x, x.new_zeros(shape)], dim=ax)
    return x


def _df_k_gemm(b, d):
    """DF exchange of one spin density as a GEMM chain over one auxiliary
    slab: K_ij = sum_{P,k,l} B[i,P,k] d[k,l] B[j,P,l], a partial sum over
    the slab's P (``nbed_tpu/parallel/sharding.py:55-67``: no in-loop eigh,
    no chunking of the split axis)."""
    t = torch.einsum("iPk,kl->iPl", b, d)
    return torch.einsum("iPl,jPl->ij", t, b)


def _lanes_jk(jk, n: int):
    """A lane J/K call (:class:`~nbed_tpu_torch.ops.jk.FusedJK` of (B, M, M)
    G, or its plain version) as ``run_scf``'s lane ``jk_fn``."""
    def jk_fn(dm):
        out = jk(dm.contiguous())
        return out[:, 0].reshape(-1, n, n), out[:, 1:].reshape(-1, 2, n, n)

    return jk_fn


def _supermatrices(g):
    """(G_J, G_K) of ERI tensors ([B,] n, n, n, n): (ij|kl) and (ik|jl) as
    contiguous ([B,] M, M) supermatrices."""
    n = g.shape[-1]
    lead = tuple(g.shape[:-4])
    g_k = g.permute(*range(len(lead)), -4, -2, -3, -1)
    return (g.reshape(*lead, n * n, n * n).contiguous(),
            g_k.reshape(*lead, n * n, n * n).contiguous())


def _exact_lanes(n: int):
    """``build`` of :func:`~nbed_tpu_torch.scf.engine.lane_scf` for exact
    J/K over lanes: the fused kernel on the (B, M, M) "g_j", "g_k"."""
    def build(t):
        return _lanes_jk(prepare_jk(t["g_j"], t["g_k"]), n), None

    return build


def _lane_scf(mol: Molecule, x, nelec=None, jit_kernel: str = "auto", **scf_kw):
    """UHF of the (B, natm, 3) lanes ``x`` on their device, one batched SCF
    with every cycle's J/K in one fused-kernel launch, as a shared program
    (:func:`~nbed_tpu_torch.scf.engine.lane_scf`; ``jit_kernel`` as
    there), on the ERIs of the lanes' "eri" program
    (:func:`~nbed_tpu_torch.integrals.eri.eri_program`): (SCFResult of
    lanes, ERI tensors (B, n, n, n, n))."""
    with torch.no_grad():
        g = eri_program(mol, x, jit_kernel=jit_kernel)
        g_j, g_k = _supermatrices(g)
        res = lane_scf(lane_spec(mol, "uhf"),
                       {"hcore": _hcore(mol, x), "s": overlap(mol, x, device=x.device),
                        "g_j": g_j, "g_k": g_k}, _exact_lanes(mol.nao),
                       nelec=mol.nelec if nelec is None else nelec, jit_kernel=jit_kernel,
                       **scf_kw)
    return res, g


def _lane_groups(coords_batch, mesh, device):
    """[(device, (b, natm, 3) float64 tensor on it), ...]: the lanes in
    contiguous groups over the mesh's 'batch' axis (the first device of
    each 'model' row), or all on ``device`` without a mesh."""
    x = np.asarray(torch.as_tensor(coords_batch).detach().cpu(), dtype=np.float64)
    if mesh is None:
        dev = resolve_device(device)
        return [(dev, torch.as_tensor(x, dtype=DTYPE, device=dev))]
    out = []
    for i, part in enumerate(np.array_split(x, mesh.shape["batch"])):
        if len(part):
            dev = mesh.devices[i, 0]
            out.append((dev, torch.as_tensor(part, dtype=DTYPE, device=dev)))
    return out


def _gather(parts, mesh, device):
    """Concatenate per-group tensors on the mesh's first device (or
    ``device``), in lane order."""
    dev = resolve_device(device) if mesh is None else mesh.devices[0, 0]
    return torch.cat([p.to(dev) for p in parts])


def batched_hf_energies(mol: Molecule, coords_batch, mesh: Mesh | None = None,
                        conv_tol: float = 1e-8, max_cycle: int = 50, device="cuda",
                        jit_kernel: str = "auto"):
    """UHF total energies of a batch of conformers.

    ``coords_batch``: (B, natm, 3) in bohr. Each lane group (all lanes
    without a mesh; one group per 'batch' row of a mesh) runs as one
    batched SCF: its one-electron integrals and ERI tensors in one
    computation per class, every SCF cycle's J/K in one fused-kernel launch
    for the group, converged lanes frozen; on a card as CUDA graphs shared
    by every batch of the molecule and size (``jit_kernel``, see
    :func:`~nbed_tpu_torch.scf.engine.lane_scf`). Returns ``(e (B,),
    converged (B,))`` on the mesh's first device (or ``device``).
    """
    es, convs = [], []
    for _, x in _lane_groups(coords_batch, mesh, device):
        res, _ = _lane_scf(mol, x, conv_tol=conv_tol, max_cycle=max_cycle,
                           jit_kernel=jit_kernel)
        es.append(res.e_elec + mol.energy_nuc_tensor(x))
        convs.append(res.converged)
    return _gather(es, mesh, device), _gather(convs, mesh, device)


def _gradient_bytes_per_lane(mol: Molecule, device) -> float:
    """Estimated device bytes one lane's reverse-mode gradient holds at its
    peak: the ERI classes' per-row intermediates that autograd keeps (the
    Hermite recursion's cubes, the R4, E and product tensors) and a few
    nao^4 tensors, doubled."""
    from ..integrals.eri import _device_tables

    classes = _device_tables(mol, device)[0]
    elems = 0
    for cls in classes:
        la, lb, lc, ld = cls.ls
        t3, u3 = (la + lb + 1) ** 3, (lc + ld + 1) ** 3
        nab = cls.ncart[0] * cls.ncart[1]
        ncd = cls.ncart[2] * cls.ncart[3]
        elems += cls.n_prim * (6 * (la + lb + lc + ld + 1) ** 4 + t3 * u3 + nab * t3
                               + ncd * u3 + nab * u3 + 2 * nab * ncd)
    return 2.0 * 8.0 * (elems + 8 * mol.nao ** 4)


def _lanes_per_pass(mol: Molecule, x) -> int:
    """Lanes of one reverse-mode pass: all of them on the CPU; on CUDA as
    many as half the device's free memory holds at
    :func:`_gradient_bytes_per_lane` each."""
    nb = x.shape[0]
    if x.device.type != "cuda":
        return nb
    free, _ = torch.cuda.mem_get_info(x.device)
    free += torch.cuda.memory_reserved(x.device) - torch.cuda.memory_allocated(x.device)
    return max(1, min(nb, int(0.5 * free // _gradient_bytes_per_lane(mol, x.device))))


# the share of the card's memory that one lane gradient program may keep:
# its graph pool stays reserved while the program is cached, so it is sized
# from the card, not from the memory free at the moment (with 36
# acetonitrile lanes in one pass, a later pfoa phase of chip_smoke.py ran
# out of device memory, 51 GiB of it in graph pools)
PROGRAM_MEMORY_SHARE = 0.125


def _even_passes(nb: int, most: int) -> int:
    """Lanes per pass for ``nb`` lanes at most ``most`` a pass, as even
    as the passes allow: one program shape serves every pass where it
    divides (36 lanes at most 13 a pass: 3 passes of 12)."""
    passes = -(-nb // max(1, min(nb, most)))
    return -(-nb // passes)


def _lanes_per_program(mol: Molecule, x) -> int:
    """Lanes of one pass of the lane gradient program: all of them off
    CUDA; on a card as many as :data:`PROGRAM_MEMORY_SHARE` of its memory
    holds at :func:`_gradient_bytes_per_lane` each, in even passes. It
    reads no free memory, so every call of a structure and batch size
    takes the same passes, and the programs' keys (their lane shapes)
    hold it."""
    nb = x.shape[0]
    if x.device.type != "cuda":
        return nb
    total = torch.cuda.get_device_properties(x.device).total_memory
    return _even_passes(nb, int(PROGRAM_MEMORY_SHARE * total
                                // _gradient_bytes_per_lane(mol, x.device)))


def _lane_gradients(mol: Molecule, x, res, g, jit_kernel: str = "auto"):
    """(B, natm, 3) analytic UHF gradients of converged lanes: the
    stationary energy functional of :mod:`nbed_tpu_torch.solvers.gradients`
    summed over lanes, differentiated once per pass of lanes; each pass
    the "hf_grad" program of its lanes where ``jit_kernel`` takes programs
    (see :func:`~nbed_tpu_torch.solvers.gradients.hf_gradient`)."""
    if takes_program(jit_kernel, (x, res.dm)):
        step = _lanes_per_program(mol, x)
        return torch.cat([hf_gradient_program(mol, x[b:b + step], res.dm[b:b + step])
                          for b in range(0, x.shape[0], step)])
    w_tot = _w_from_dm(mol, x, res.dm, hyb=1.0, eri=g)
    step = _lanes_per_pass(mol, x)
    return torch.cat([
        _autograd(_energy_functional(mol, res.dm[b:b + step], w_tot[b:b + step], hyb=1.0),
                  x[b:b + step])
        for b in range(0, x.shape[0], step)])


def batched_hf_gradients(mol: Molecule, coords_batch, mesh: Mesh | None = None,
                         conv_tol: float = 1e-10, dm_conv_tol: float = 1e-8,
                         max_cycle: int = 100, device="cuda", jit_kernel: str = "auto"):
    """UHF energies and analytic nuclear gradients of a conformer batch.

    Returns ``(e (B,), grad (B, natm, 3), converged (B,))``: each lane group
    runs one batched SCF (as :func:`batched_hf_energies`, ``jit_kernel``
    as there) and then the reverse-mode gradient of the stationary energy
    functional over its lanes at once, on a card as the lanes' "hf_grad"
    program (``jit_kernel``: the ERIs, the functional and its backward in
    one CUDA graph per structure and lanes). On a card the lanes of one
    backward pass are limited by the free device memory
    (:func:`_lanes_per_pass`), or for the program by a share of the card's
    memory (:func:`_lanes_per_program`).
    """
    es, grads, convs = [], [], []
    for _, x in _lane_groups(coords_batch, mesh, device):
        res, g = _lane_scf(mol, x, conv_tol=conv_tol, dm_conv_tol=dm_conv_tol,
                           max_cycle=max_cycle, jit_kernel=jit_kernel)
        es.append(res.e_elec + mol.energy_nuc_tensor(x))
        grads.append(_lane_gradients(mol, x, res, g, jit_kernel))
        convs.append(res.converged)
    return (_gather(es, mesh, device), _gather(grads, mesh, device),
            _gather(convs, mesh, device))


def _model_devices(mesh: Mesh):
    """The 'model' axis of the mesh's first 'batch' row."""
    return list(mesh.devices[0])


def _coords0(mol: Molecule, coords, dev):
    return torch.as_tensor(mol.coords if coords is None else coords, dtype=DTYPE, device=dev)


def make_sharded_scf(mol: Molecule, mesh: Mesh, coords=None, nelec=None, **scf_kwargs):
    """Build the model-parallel SCF program: ``(fn, args)``.

    ``args = (hcore, s, slabs_j, slabs_k)``: the (ij|kl) and (ik|jl)
    supermatrices row-padded to a multiple of the 'model' axis and cut into
    (R, M) slabs, R = M_pad / n_model, one on each model device. Each SCF
    cycle runs the fused J/K kernel on every slab (R rows, one lane), copies
    the (3, R) outputs to the first device, concatenates them and drops the
    pad rows. Exposed apart from :func:`sharded_scf` so that tests can look
    at the slabs.
    """
    devs = _model_devices(mesh)
    dev0, n_model = devs[0], len(devs)
    n = mol.nao
    m = n * n
    with torch.no_grad():
        c = _coords0(mol, coords, dev0)
        g_j, g_k = _supermatrices(eri_tensor(mol, c, device=dev0))
        hcore, s = _hcore(mol, c), overlap(mol, c, device=dev0)
    g_j, g_k = (pad_to_multiple(a, n_model, axes=(0,)) for a in (g_j, g_k))
    r = g_j.shape[0] // n_model
    # each slab its own allocation (the kernel takes 16-byte aligned G; a
    # row view into one device's G need not be)
    slabs_j = [g_j[i * r:(i + 1) * r].to(d).clone() for i, d in enumerate(devs)]
    slabs_k = [g_k[i * r:(i + 1) * r].to(d).clone() for i, d in enumerate(devs)]

    def build(t):
        jks = [(t[f"j{i}"].device, prepare_jk(t[f"j{i}"][None], t[f"k{i}"][None]))
               for i in range(len(devs))]
        dev0 = t["hcore"].device

        def jk_fn(dm):
            dm = dm.contiguous()[None]
            out = torch.cat([jk(dm.to(d))[0].to(dev0) for d, jk in jks], dim=-1)
            out = out[:, :m]  # the pad rows, dropped from the small output only
            return out[0].reshape(n, n), out[1:].reshape(2, n, n)

        return jk_fn, None

    def padded_run(hcore, s, slabs_j, slabs_k):
        ops = {"hcore": hcore, "s": s, **{f"j{i}": a for i, a in enumerate(slabs_j)},
               **{f"k{i}": a for i, a in enumerate(slabs_k)}}
        return _single_scf(lane_spec(mol, "uhf_row_slabs", len(devs)), ops, build,
                           nelec=mol.nelec if nelec is None else nelec, **scf_kwargs)

    return padded_run, (hcore, s, slabs_j, slabs_k)


def sharded_scf(mol: Molecule, mesh: Mesh, coords=None, nelec=None, **scf_kwargs):
    """UHF with the ERI supermatrices split row-wise over the mesh's 'model'
    axis (:func:`make_sharded_scf`); returns the SCFResult, on the first
    device."""
    fn, args = make_sharded_scf(mol, mesh, coords=coords, nelec=nelec, **scf_kwargs)
    return fn(*args)


def _aux_slabs(mol: Molecule, c, devs, df_beta: float, omega: float = 0.0):
    """The DF factor (nao, naux, nao) at ``c``, its auxiliary axis
    zero-padded to a multiple of the model axis and cut into one slab per
    device."""
    from ..scf.engine import df_b_factor

    b = df_b_factor(mol, df_beta, c.device, omega=omega, coords=c.cpu().numpy())
    b = pad_to_multiple(b, len(devs), axes=(1,))
    w = b.shape[1] // len(devs)
    return [b[:, i * w:(i + 1) * w].to(d).contiguous() for i, d in enumerate(devs)]


def _df_jk_fn(b_slabs, dev0, b_lr_slabs=None, hyb: float = 1.0, beta: float = 0.0):
    """J/K of the DF factor's slabs: each slab's partial J and K, summed on
    ``dev0`` (the all-reduce). With ``b_lr_slabs`` K is the folded
    hyb * K + beta * K_LR of a range-separated hybrid."""
    from ..scf.engine import _df_j

    def k_of(slabs, dm):
        return sum(torch.stack([_df_k_gemm(b, dm.to(b.device)[s]) for s in (0, 1)]).to(dev0)
                   for b in slabs)

    def jk_fn(dm):
        d_tot = dm[0] + dm[1]
        j = sum(_df_j(b, d_tot.to(b.device)).to(dev0) for b in b_slabs)
        k = k_of(b_slabs, dm)
        if b_lr_slabs is not None:
            k = hyb * k + beta * k_of(b_lr_slabs, dm)
        return j, k

    return jk_fn


def make_sharded_df_scf(mol: Molecule, mesh: Mesh, coords=None, nelec=None,
                        df_beta: float = 1.8, **scf_kwargs):
    """Build the auxiliary-split density-fitted SCF program: ``(fn, args)``
    with ``args = (hcore, s, b_slabs)``, each slab (nao, naux_pad / n_model,
    nao) on its model device. Per cycle each slab contracts the density
    into its partial J and K (``_df_k_gemm``), and the partials are summed
    on the first device."""
    devs = _model_devices(mesh)
    dev0 = devs[0]
    with torch.no_grad():
        c = _coords0(mol, coords, dev0)
        hcore, s = _hcore(mol, c), overlap(mol, c, device=dev0)
    b_slabs = _aux_slabs(mol, c, devs, df_beta)

    def build(t):
        return _df_jk_fn([t[f"b{i}"] for i in range(len(devs))], t["hcore"].device), None

    def df_run(hcore, s, b_slabs):
        ops = {"hcore": hcore, "s": s, **{f"b{i}": b for i, b in enumerate(b_slabs)}}
        return _single_scf(lane_spec(mol, "df_uhf_aux_slabs", len(devs), df_beta), ops,
                           build, nelec=mol.nelec if nelec is None else nelec, **scf_kwargs)

    return df_run, (hcore, s, b_slabs)


def sharded_df_scf(mol: Molecule, mesh: Mesh, coords=None, nelec=None,
                   df_beta: float = 1.8, **scf_kwargs):
    """Density-fitted UHF with the factor's auxiliary axis split over the
    mesh's 'model' axis (:func:`make_sharded_df_scf`)."""
    fn, args = make_sharded_df_scf(mol, mesh, coords=coords, nelec=nelec, df_beta=df_beta,
                                   **scf_kwargs)
    return fn(*args)


def make_sharded_df_ks(mol: Molecule, mesh: Mesh, xc: str = "b3lyp", coords=None,
                       nelec=None, df_beta: float = 1.8, grid_level: int = 3, **scf_kwargs):
    """Build the split UKS program: ``(fn, args)``.

    ``args = (hcore, s, b_slabs, [b_lr_slabs,] ao_slabs, ao_grad_slabs,
    weight_slabs)``: the DF factor split over its auxiliary axis as in
    :func:`make_sharded_df_scf` (a range-separated hybrid adds its
    long-range factor, split the same way, and folds hyb * K + beta * K_LR
    into K with the reported hyb 1.0, the engine's convention), and the XC
    grid (``build_grid(level=grid_level)``, the reference scheme: the SCF
    engine's default grid) split over its points: the AO table (G, nao),
    its gradient (3, G, nao) and the weights (G,) zero-padded to a multiple
    of the model axis, a slab on each device. Each slab's exc and Vxc are
    partial sums, added on the first device; the pad points have zero
    weight and zero AO values, which the density mask makes exactly zero.
    """
    from ..dft.functionals import resolve_functional
    from ..dft.xc import make_xc_fn
    from ..grids import build_grid, eval_aos

    _, hyb, rsh = resolve_functional(xc)
    devs = _model_devices(mesh)
    dev0, n_model = devs[0], len(devs)
    with torch.no_grad():
        c = _coords0(mol, coords, dev0)
        hcore, s = _hcore(mol, c), overlap(mol, c, device=dev0)
        points, weights = build_grid(mol, c, level=grid_level, device=dev0)
        ao, ao_grad = eval_aos(mol, points, c)
    b_slabs = _aux_slabs(mol, c, devs, df_beta)
    b_lr_slabs = None if rsh is None else _aux_slabs(mol, c, devs, df_beta, omega=rsh[1])
    ao = pad_to_multiple(ao, n_model, axes=(0,))
    ao_grad = pad_to_multiple(ao_grad, n_model, axes=(1,))
    weights = pad_to_multiple(weights, n_model, axes=(0,))
    gs = ao.shape[0] // n_model
    ao_slabs = [ao[i * gs:(i + 1) * gs].to(d).contiguous() for i, d in enumerate(devs)]
    grad_slabs = [ao_grad[:, i * gs:(i + 1) * gs].to(d).contiguous()
                  for i, d in enumerate(devs)]
    w_slabs = [weights[i * gs:(i + 1) * gs].to(d).contiguous() for i, d in enumerate(devs)]
    hyb_eff = 1.0 if rsh is not None else hyb

    def build(t):
        slabs = range(n_model)
        ao_s = [t[f"ao{i}"] for i in slabs]
        fns = [make_xc_fn(ao_s[i], t[f"grad{i}"], t[f"w{i}"], xc) for i in slabs]
        dev0 = t["hcore"].device

        def xc_fn(dm):
            parts = [fn(dm.to(a.device)) for fn, a in zip(fns, ao_s)]
            return (sum(e.to(dev0) for e, _ in parts), sum(v.to(dev0) for _, v in parts))

        b_lr = None if rsh is None else [t[f"b_lr{i}"] for i in slabs]
        jk_fn = _df_jk_fn([t[f"b{i}"] for i in slabs], dev0, b_lr, hyb,
                          0.0 if rsh is None else rsh[0])
        return jk_fn, None if fns[0] is None else xc_fn

    def ks_run(hcore, s, b_slabs, *rest):
        b_lr, (ao_s, grad_s, w_s) = (rest[0], rest[1:]) if rsh is not None else (None, rest)
        ops = {"hcore": hcore, "s": s}
        for i in range(n_model):
            ops.update({f"b{i}": b_slabs[i], f"ao{i}": ao_s[i], f"grad{i}": grad_s[i],
                        f"w{i}": w_s[i]})
            if b_lr is not None:
                ops[f"b_lr{i}"] = b_lr[i]
        return _single_scf(lane_spec(mol, "df_uks_aux_grid_slabs", n_model, xc, df_beta),
                           ops, build, hyb=hyb_eff,
                           nelec=mol.nelec if nelec is None else nelec, **scf_kwargs)

    lr = () if rsh is None else (b_lr_slabs,)
    return ks_run, (hcore, s, b_slabs, *lr, ao_slabs, grad_slabs, w_slabs)


def sharded_df_ks(mol: Molecule, mesh: Mesh, xc: str = "b3lyp", coords=None, nelec=None,
                  df_beta: float = 1.8, grid_level: int = 3, **scf_kwargs):
    """UKS with the DF factor split over its auxiliary axis and the XC grid
    over its points (:func:`make_sharded_df_ks`); returns the SCFResult."""
    fn, args = make_sharded_df_ks(mol, mesh, xc=xc, coords=coords, nelec=nelec,
                                  df_beta=df_beta, grid_level=grid_level, **scf_kwargs)
    return fn(*args)
