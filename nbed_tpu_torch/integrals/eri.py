"""Two-electron repulsion integrals in torch, chemist notation (ab|cd)
(port of ``nbed_tpu/integrals/eri.py``).

Shell quartets are canonicalised (a>=b, c>=d, pair(ab)>=pair(cd)), rotated
to an l-sorted representative of their 8-fold permutation orbit and grouped
by angular class ``(la, lb, lc, ld)``, as in the reference. Every primitive
quartet of a class is one row of a flat work list; the rows run through one
batched McMurchie-Davidson computation per chunk (the reference ``vmap``s
one row) and are summed into per-quartet cartesian blocks, which the
per-shell cart2sph matrices turn spherical.

The tensor is assembled by one gather: each of the nao^4 elements reads the
one spherical value whose permutation orbit it lies in. The reference
instead scatters every value to its 8 images with ``.at[].set``, where
quartets with repeated shells write some elements twice; JAX's scatter JVP
sends such an element's cotangent to the one update that wins, while
torch's ``index_put`` backward would send it to every update and double the
gradient. With the gather each element has exactly one source, and the
backward (an index-add over the elements) sums the cotangents of all images
of a value, which is the derivative. Everything is torch arithmetic on the
coordinates, so autograd passes through.

On a CUDA device, coordinates that neither require grad nor carry a
forward-mode tangent take the hand-written kernel instead
(:func:`nbed_tpu_torch.ops.eri.eri`, shells up to d): one launch for all
lanes, where the classes' chunks are thousands of small ones. The derivative
routes and the CPU keep the torch arithmetic.
"""

from functools import lru_cache
from itertools import product

import numpy as np
import torch

from .._device import DTYPE, resolve_device
from ..chem.molecule import Molecule
from ..ops import eri as md_eri
from .core import _coords, _e3_tensor
from .md import hermite_r_cross

__all__ = ["eri_tensor"]

_PERMS = ((0, 1, 2, 3), (1, 0, 2, 3), (0, 1, 3, 2), (1, 0, 3, 2),
          (2, 3, 0, 1), (3, 2, 0, 1), (2, 3, 1, 0), (3, 2, 1, 0))


def _l_sorted(q, shells):
    """Rotate a quartet to the l-sorted representative of its 8-orbit:
    l_a >= l_b, l_c >= l_d, (l_a, l_b) >= (l_c, l_d)."""
    a, b, c, d = q
    if shells[a].l < shells[b].l:
        a, b = b, a
    if shells[c].l < shells[d].l:
        c, d = d, c
    if (shells[a].l, shells[b].l) < (shells[c].l, shells[d].l):
        a, b, c, d = c, d, a, b
    return (a, b, c, d)


def _canonical_quartets(nsh):
    """Canonical (a, b, c, d) with a>=b, c>=d, pair(ab)>=pair(cd)."""
    pairs = [(i, j) for i in range(nsh) for j in range(i + 1)]
    return [(*pairs[pi], *pairs[qi]) for pi in range(len(pairs)) for qi in range(pi + 1)]


class _AngularClass:
    """Host arrays of one (la, lb, lc, ld) class: the flattened primitive
    work list (``prim_*``, one row per primitive quartet, ``prim_qid`` its
    quartet) and the per-quartet spherical rotations ``c2s``."""

    def __init__(self, ls, quartets, shells):
        self.ls = ls
        sh = [[shells[i] for i in q] for q in quartets]
        self.m = len(quartets)
        self.c2s = [np.array([q[k].cart2sph for q in sh]) for k in range(4)]
        self.ncart = [(l + 1) * (l + 2) // 2 for l in ls]
        self.nsph = [2 * l + 1 for l in ls]
        exps, coefs, qid, atoms = [], [], [], []
        for mi, q in enumerate(sh):
            for combo in product(*[list(zip(s.exps, s.coeffs)) for s in q]):
                exps.append([p[0] for p in combo])
                coefs.append(np.prod([p[1] for p in combo]))
                qid.append(mi)
                atoms.append([s.atom for s in q])
        self.prim_exps = np.array(exps)  # (P, 4)
        self.prim_coef = np.array(coefs)  # (P,)
        self.prim_qid = np.array(qid, dtype=np.int64)  # (P,)
        self.prim_atoms = np.array(atoms, dtype=np.int64)  # (P, 4)
        self.n_prim = len(qid)
        # AO index of each element of the (M, na, nb, nc, nd) spherical block
        offs = [np.array([q[k].ao_offset for q in sh]) for k in range(4)]
        grids = np.meshgrid(*[np.arange(n) for n in self.nsph], indexing="ij")
        self.ao_index = [(offs[k][:, None, None, None, None] + grids[k][None]).reshape(-1)
                         for k in range(4)]


def _angular_classes(mol: Molecule):
    """The classes of ``mol``, and for each element of the flat (nao^4,)
    tensor the index of its value in the concatenation of the classes'
    spherical blocks (every element lies in exactly one orbit)."""
    shells = mol.shells
    groups = {}
    for q in _canonical_quartets(len(shells)):
        q = _l_sorted(q, shells)
        groups.setdefault(tuple(shells[i].l for i in q), []).append(q)
    classes = [_AngularClass(ls, qs, shells) for ls, qs in sorted(groups.items())]
    n = mol.nao
    source = np.full(n ** 4, -1, dtype=np.int64)
    offset = 0
    for cls in classes:
        idx = cls.ao_index
        vals = offset + np.arange(idx[0].size)
        for perm in _PERMS:
            # the image puts the block's index k in slot perm.index(k)
            i, j, k, l = (idx[perm.index(slot)] for slot in range(4))
            # repeated shells map several (equal) values to one element:
            # any of them is that element's one source
            source[((i * n + j) * n + k) * n + l] = vals
        offset += idx[0].size
    assert (source >= 0).all(), "ERI orbits do not cover the tensor"
    return classes, source


@lru_cache(maxsize=4)
def _device_tables(mol: Molecule, device: torch.device):
    """The tables of :func:`_angular_classes` copied to ``device`` once per
    (molecule, device), so that repeated calls (the displaced gradients of a
    Hessian, the steps of an optimization) do only arithmetic: for each class
    its (exps, coef, qid, atoms (4, P), c2s) tensors, then the gather
    index."""
    classes, source = _angular_classes(mol)
    tables = [(torch.as_tensor(cls.prim_exps, dtype=DTYPE, device=device),
               torch.as_tensor(cls.prim_coef, dtype=DTYPE, device=device),
               torch.as_tensor(cls.prim_qid, device=device),
               torch.as_tensor(np.ascontiguousarray(cls.prim_atoms.T), device=device),
               [torch.as_tensor(m, dtype=DTYPE, device=device) for m in cls.c2s])
              for cls in classes]
    return classes, tables, torch.as_tensor(source, device=device)


def _class_rows(ls, coords, exps, coef, atoms, omega):
    """Cartesian blocks ([B,] rows, nca, ncb, ncc, ncd) of a chunk of
    primitive quartet rows, each scaled by its contraction coefficient; B
    the lanes of (B, natm, 3) coordinates; ``atoms`` (4, rows)."""
    la, lb, lc, ld = ls
    lead = tuple(coords.shape[:-2])
    ra, rb, rc, rd = (coords.index_select(-2, atoms[k]) for k in range(4))
    a, b, c, d = (exps[:, k] for k in range(4))
    p, q = a + b, c + d
    big_p = (a[:, None] * ra + b[:, None] * rb) / p[:, None]
    big_q = (c[:, None] * rc + d[:, None] * rd) / q[:, None]
    e_ab = _e3_tensor(la, lb, a, b, ra - rb)  # ([B,] rows, nca, ncb, T, T, T)
    e_cd = _e3_tensor(lc, ld, c, d, rc - rd)
    r4 = hermite_r_cross(la + lb, lc + ld, p * q / (p + q), big_p - big_q, omega=omega)
    rows = exps.shape[0]
    cart_ab, cart_cd = e_ab.shape[-5:-3], e_cd.shape[-5:-3]
    nab = cart_ab[0] * cart_ab[1]
    ncd = cart_cd[0] * cart_cd[1]
    t3 = (la + lb + 1) ** 3
    u3 = (lc + ld + 1) ** 3
    pref = coef * 2.0 * np.pi ** 2.5 / (p * q * torch.sqrt(p + q))
    out = torch.bmm(torch.bmm(e_ab.reshape(-1, nab, t3), r4.reshape(-1, t3, u3)),
                    e_cd.reshape(-1, ncd, u3).transpose(1, 2))
    out = pref[:, None, None] * out.reshape(*lead, rows, nab, ncd)
    return out.reshape(*lead, rows, *cart_ab, *cart_cd)


def eri_tensor(mol: Molecule, coords=None, chunk_elems: int = 2**22, omega=None,
               device="cuda"):
    """Full AO ERI tensor (nao, nao, nao, nao), chemist notation (ij|kl), on
    ``device``.

    A pure function of ``coords`` (Bohr; the molecule's by default):
    autograd gives its nuclear derivatives. Only canonical quartets are
    computed. ``chunk_elems`` bounds the per-chunk intermediates: a chunk of
    a class holds at most ``chunk_elems`` elements of the larger of its
    cartesian block and its Hermite R4 tensor per row and lane (at least
    16 rows). ``omega`` selects the long-range erf(omega*r12)/r12 kernel of
    range-separated hybrids.

    Coordinates of shape (B, natm, 3) give (B, nao, nao, nao, nao): the B
    lanes ride through each class's chunks in one computation, and a
    chunk holds chunk_elems / B rows, so its memory is the single
    geometry's. Where :func:`takes_kernel` (a card, no derivative), the
    kernel computes all lanes in one call and ``chunk_elems`` is unused.
    """
    c = _coords(mol, coords, resolve_device(device))
    omega = None if omega is None else float(omega)
    if takes_kernel(mol, c):
        return md_eri.eri(mol, c, omega)
    return eri_torch(mol, c, _device_tables(mol, c.device), chunk_elems, omega)


def takes_kernel(mol: Molecule, c) -> bool:
    """Whether the ERIs at coordinates ``c`` come from the card's kernel:
    ``c`` on a CUDA device, carrying no derivative (``requires_grad`` or a
    forward-mode tangent), and every shell of ``mol`` within the kernel's."""
    from ..scf.hf import carries_derivative

    return c.device.type == "cuda" and not carries_derivative(c) and md_eri.covers(mol)


def _eri_of(mol: Molecule, c, device_tables, chunk_elems: int, omega):
    """:func:`eri_tensor` at coordinates ``c`` (a tensor): the kernel where
    :func:`takes_kernel`, else :func:`eri_torch` over ``device_tables``
    (:func:`_device_tables` of ``mol``): tensors only, so a CUDA graph
    captures it."""
    if takes_kernel(mol, c):
        return md_eri.eri(mol, c, omega)
    return eri_torch(mol, c, device_tables, chunk_elems, omega)


def eri_torch(mol: Molecule, c, device_tables, chunk_elems: int, omega):
    """The torch arithmetic of :func:`eri_tensor` at ``c`` on any device,
    over the :func:`_device_tables` of ``mol``: the kernel's plain version."""
    lead = tuple(c.shape[:-2])
    lanes = int(np.prod(lead))
    classes, tables, source = device_tables
    vals = []
    for cls, (exps, coef, qid, atoms, c2s) in zip(classes, tables):
        la, lb, lc, ld = cls.ls
        per_row = max(int(np.prod(cls.ncart)), (la + lb + 1) ** 3 * (lc + ld + 1) ** 3)
        chunk = max(16, min(cls.n_prim, chunk_elems // (per_row * lanes)))
        acc = torch.zeros((*lead, cls.m, *cls.ncart), dtype=DTYPE, device=c.device)
        for s in range(0, cls.n_prim, chunk):
            sl = slice(s, s + chunk)
            blocks = _class_rows(cls.ls, c, exps[sl], coef[sl], atoms[:, sl], omega)
            acc = acc.index_add(len(lead), qid[sl], blocks)
        sph = torch.einsum("...mabcd,map->...mpbcd", acc, c2s[0])
        sph = torch.einsum("...mpbcd,mbq->...mpqcd", sph, c2s[1])
        sph = torch.einsum("...mpqcd,mcr->...mpqrd", sph, c2s[2])
        sph = torch.einsum("...mpqrd,mds->...mpqrs", sph, c2s[3])
        vals.append(sph.reshape(*lead, -1))
    n = mol.nao
    # a gather whose backward is an index addition over ``source``
    # (atomics on the card), not the sort of an accumulating index_put
    return torch.cat(vals, dim=-1).index_select(-1, source).reshape(*lead, n, n, n, n)


def eri_program(mol: Molecule, coords, omega=None, chunk_elems: int = 2**22,
                jit_kernel: str = "auto"):
    """:func:`eri_tensor` at ``coords`` ((natm, 3) or (B, natm, 3) tensor)
    as the derivative program of kind "eri": one CUDA graph per
    (structure, lanes, omega, ``chunk_elems``, card) in
    :data:`nbed_tpu_torch.ops.programs.DERIVATIVE_PROGRAMS`, the
    coordinates copied into its input buffer and the tensor read from its
    output (a copy the caller owns). Coordinates that carry a forward-mode
    tangent take the program of kind "eri_jvp", which writes the tensor
    and its tangent (a dual tensor the caller owns). ``jit_kernel`` as the
    SCF engine's: "auto" runs the program on a card and :func:`eri_tensor`
    elsewhere, "on" the program everywhere (uncaptured off CUDA), "off"
    :func:`eri_tensor`; coordinates that require grad run
    :func:`eri_tensor` under "auto" and raise under "on"."""
    from ..ops.programs import (BufferProgram, TangentProgram, derivative_program, has_tangent,
                                structure_key, takes_program)

    tangent = has_tangent(coords)
    if not takes_program(jit_kernel, (coords,), tangent=tangent):
        return eri_tensor(mol, coords, chunk_elems=chunk_elems, omega=omega,
                          device=coords.device)
    omega = None if omega is None else float(omega)
    shape = tuple(coords.shape)
    n = mol.nao
    kind = "eri_jvp" if tangent else "eri"

    def build(device, pool):
        x = torch.zeros(shape, dtype=DTYPE, device=device)
        # the body's tables: the kernel's, which the graph reads by address,
        # where the primal program takes the kernel
        kernel = not tangent and takes_kernel(mol, x)
        tables = md_eri.device_tables(mol, device) if kernel else _device_tables(mol, device)
        if tangent:
            return TangentProgram(kind, {"x": x},
                                  lambda x: {"eri": _eri_of(mol, x, tables, chunk_elems, omega)},
                                  device, pool, holds=(tables,))
        out = torch.zeros(shape[:-2] + (n, n, n, n), dtype=DTYPE, device=device)

        def body():
            with torch.no_grad():
                out.copy_(_eri_of(mol, x, tables, chunk_elems, omega))

        return BufferProgram(kind, {"x": x}, {"eri": out}, body, device, pool, holds=(tables,))

    prog = derivative_program((kind, structure_key(mol), shape, omega, int(chunk_elems)),
                              coords.device, build)
    return prog(x=coords)["eri"].clone()
