"""The ERI tensor on a CUDA device: the wrapper of ``csrc/md_eri.cu`` and the
tables it reads.

:func:`eri` returns the full float64 (nao, nao, nao, nao) tensor in chemist
notation at (natm, 3) coordinates, or (B, nao, nao, nao, nao) at (B, natm, 3),
laid out as ``integrals.native.eri`` returns it, with the same ``omega``
(erf-attenuated) option. It launches the hand-written McMurchie-Davidson
kernel, built with ``nvcc`` for ``sm_90a`` into ``nbed_tpu_torch/_build``
at first use, and takes CUDA tensors only (the plain version, for every
device, is ``integrals.eri.eri_tensor``). There is no fallback: a call
that cannot build or launch raises. The kernel covers shells up to d
(:data:`LMAX`); :func:`covers` says whether a molecule's shells are within
it, and callers route a molecule that is not elsewhere.

The tables (:class:`Tables`) are built in numpy once per basis structure
(the shells, not the coordinates) and copied to each card once
(:func:`device_tables`); a call copies nothing from the host and reads
nothing back, so a CUDA graph captures it. :func:`owners` is the kernel's
rule for which block element writes each element of the output, in numpy,
for the CPU tests. :data:`LAUNCHES_BY_SHAPE` counts the calls that launched
the kernel by (B, nao, canonical quartets).
"""

import ctypes
from collections import Counter, OrderedDict
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from .._compile import build_shared_library
from .jk import _NVCC_FLAGS, _nvcc, count_launch
from .programs import card

__all__ = ["eri", "covers", "tables", "device_tables", "owners", "operations", "Tables",
           "LAUNCHES", "LAUNCHES_BY_SHAPE", "LMAX", "build_library"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "md_eri.cu"

# the highest shell l the kernel covers (csrc/md_eri.cu's kLmax)
LMAX = 2
# threads of a quartet block, float64 words of a primitive pair's scratch,
# the shared memory a block may use without an opt-in (csrc/md_eri.cu)
_THREADS = 256
_PAIR_WORDS = 5 + 3 * (LMAX + 1) ** 2 * (2 * LMAX + 1)
_SMEM_BYTES = 48 * 1024
# the fewest primitive quartets of an R tile, and the most shared memory a
# block may take (the H100's)
_MIN_TILE = 16
_SMEM_MAX = 232448

# calls that launched the kernel in this process: "md_eri"; and by
# (B, nao, canonical shell quartets)
LAUNCHES: Counter = Counter()
LAUNCHES_BY_SHAPE: Counter = Counter()

# the eight permutations of (ab|cd) that keep its value, as csrc/md_eri.cu's
# kPerms: slot k of an image takes index perm[k]
_PERMS = ((0, 1, 2, 3), (1, 0, 2, 3), (0, 1, 3, 2), (1, 0, 3, 2),
          (2, 3, 0, 1), (3, 2, 0, 1), (2, 3, 1, 0), (3, 2, 1, 0))


def covers(mol) -> bool:
    """Whether every shell of ``mol`` is within the kernel's l <= :data:`LMAX`."""
    return all(sh.l <= LMAX for sh in mol.shells)


def _ncart(l):
    return (l + 1) * (l + 2) // 2


@dataclass(frozen=True, eq=False)
class Tables:
    """The host tables of one basis structure, as ``csrc/md_eri.cu`` reads
    them. ``shells`` (nsh, 6) int32: l, primitives, atom, AO offset, first
    primitive in ``exps``/``coefs``, first word of its cart2sph in ``c2s``;
    ``pairs`` (npair, 3) int32: shells a >= b, first primitive pair;
    ``prim_pairs`` (npp, 3) int32: pair, primitive i of a, j of b (i major);
    ``quartets`` (nq, 2) int32: bra pair >= ket pair, every canonical shell
    quartet once, the heaviest first."""

    shells: np.ndarray
    exps: np.ndarray
    coefs: np.ndarray
    c2s: np.ndarray
    pairs: np.ndarray
    prim_pairs: np.ndarray
    quartets: np.ndarray
    nao: int
    natm: int

    @property
    def lmax(self) -> int:
        return int(self.shells[:, 0].max())

    def launch_sizes(self) -> dict:
        """The shared-memory layout of a quartet block (``Plan``'s tile, nr,
        cart_max, smem_bytes): two cartesian buffers, R tables of ``tile``
        primitive quartets and their prefactors, then the E tables of the
        quartet's primitive pairs (``e_words``: twice the largest pair's).
        The tile fills 48 KB, but takes at least :data:`_MIN_TILE` primitive
        quartets, above 48 KB where it must."""
        lsum = 4 * self.lmax
        nr = (lsum + 1) * (lsum + 2) * (lsum + 3) // 6
        cart_max = _ncart(self.lmax) ** 4
        l = self.shells[:, 0].astype(np.int64)
        la, lb = l[self.pairs[:, 0]], l[self.pairs[:, 1]]
        n_pp = self.shells[self.pairs[:, 0], 1] * self.shells[self.pairs[:, 1], 1]
        # E_t^{ij} kept per axis: sum over i <= la, j <= lb of i + j + 1
        per_axis = (lb + 1) * (la + 1) * (la + 2) // 2 + (la + 1) * lb * (lb + 1) // 2
        e_words = 2 * int((3 * n_pp * per_axis).max())
        tile = min(_THREADS, (_SMEM_BYTES // 8 - 2 * cart_max - e_words) // (nr + 1))
        # the R tables' space also takes the threads' partial sums
        tile = max(tile, _MIN_TILE, -(-_THREADS // nr))
        return {"tile": tile, "nr": nr, "cart_max": cart_max,
                "smem_bytes": 8 * (2 * cart_max + tile * (nr + 1) + e_words)}


def _structure_key(mol) -> tuple:
    return (mol.natm, tuple((sh.atom, sh.l, sh.exps, sh.coeffs, sh.ao_offset,
                             np.asarray(sh.cart2sph, dtype=np.float64).tobytes())
                            for sh in mol.shells))


def _build_tables(mol) -> Tables:
    shells, exps, coefs, c2s = [], [], [], []
    for sh in mol.shells:
        shells.append([sh.l, len(sh.exps), sh.atom, sh.ao_offset, len(exps), len(c2s)])
        exps.extend(sh.exps)
        coefs.extend(sh.coeffs)
        c2s.extend(np.asarray(sh.cart2sph, dtype=np.float64).ravel().tolist())
    shells = np.asarray(shells, dtype=np.int32)
    nprim = shells[:, 1].astype(np.int64)
    a, b = np.tril_indices(len(shells))  # a >= b, pair index a (a + 1) / 2 + b
    n_pp = nprim[a] * nprim[b]
    first = np.concatenate([[0], np.cumsum(n_pp)[:-1]])
    pairs = np.stack([a, b, first], axis=1).astype(np.int32)
    pair_of = np.repeat(np.arange(len(a)), n_pp)
    k = np.arange(int(n_pp.sum())) - first[pair_of]
    prim_pairs = np.stack([pair_of, k // nprim[b][pair_of], k % nprim[b][pair_of]],
                          axis=1).astype(np.int32)
    bra, ket = np.tril_indices(len(a))  # pair(ab) >= pair(cd)
    ncart = (shells[:, 0] + 1) * (shells[:, 0] + 2) // 2
    weight = n_pp * ncart[a] * ncart[b]
    order = np.argsort(-(weight[bra] * weight[ket]), kind="stable")
    quartets = np.stack([bra[order], ket[order]], axis=1).astype(np.int32)
    return Tables(shells, np.asarray(exps, dtype=np.float64),
                  np.asarray(coefs, dtype=np.float64), np.asarray(c2s, dtype=np.float64),
                  pairs, prim_pairs, quartets, mol.nao, mol.natm)


_TABLES = OrderedDict()     # structure key -> Tables
_DEVICE = OrderedDict()     # (structure key, device) -> _DeviceTables
_CACHE_MAX = 8


def _cached(cache, key, make):
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    value = cache[key] = make()
    if len(cache) > _CACHE_MAX:
        cache.popitem(last=False)
    return value


def tables(mol) -> Tables:
    """The host :class:`Tables` of ``mol``'s basis structure, cached by its
    shells (atoms, l, exponents, coefficients, offsets), not its
    coordinates."""
    return _cached(_TABLES, _structure_key(mol), lambda: _build_tables(mol))


class _PlanC(ctypes.Structure):
    """``csrc/md_eri.cu``'s ``Plan``."""

    _fields_ = [("shells", ctypes.c_void_p), ("exps", ctypes.c_void_p),
                ("coefs", ctypes.c_void_p), ("c2s", ctypes.c_void_p),
                ("pairs", ctypes.c_void_p), ("prim_pairs", ctypes.c_void_p),
                ("quartets", ctypes.c_void_p), ("n_prim_pairs", ctypes.c_int64),
                ("n_quartets", ctypes.c_int64), ("natm", ctypes.c_int), ("nao", ctypes.c_int),
                ("batch", ctypes.c_int), ("tile", ctypes.c_int), ("nr", ctypes.c_int),
                ("cart_max", ctypes.c_int), ("smem_bytes", ctypes.c_int)]


class _DeviceTables:
    """:class:`Tables` on one CUDA device, and a launch plan per lane count."""

    def __init__(self, host: Tables, device: torch.device):
        self.host = host
        self.device = device
        names = ("shells", "exps", "coefs", "c2s", "pairs", "prim_pairs", "quartets")
        self.tensors = {name: torch.as_tensor(getattr(host, name), device=device)
                        for name in names}
        self.sizes = host.launch_sizes()
        if self.sizes["smem_bytes"] > _SMEM_MAX:
            raise ValueError(f"md_eri: a quartet block needs {self.sizes['smem_bytes']} bytes "
                             f"of shared memory, more than {_SMEM_MAX}")
        if self.sizes["smem_bytes"] > _SMEM_BYTES:
            with torch.cuda.device(device):
                err = build_library().nbed_md_eri_init(self.sizes["smem_bytes"])
            if err != 0:
                raise RuntimeError(f"md_eri: kernel set-up failed with status {err}")
        self._plans = {}

    def plan(self, batch: int):
        """(ctypes plan, its address) for ``batch`` lanes."""
        if batch not in self._plans:
            t, h = self.tensors, self.host
            plan = _PlanC(*(t[name].data_ptr() for name in ("shells", "exps", "coefs", "c2s",
                                                            "pairs", "prim_pairs", "quartets")),
                          len(h.prim_pairs), len(h.quartets), h.natm, h.nao, batch,
                          self.sizes["tile"], self.sizes["nr"], self.sizes["cart_max"],
                          self.sizes["smem_bytes"])
            self._plans[batch] = (plan, ctypes.addressof(plan))
        return self._plans[batch]


def device_tables(mol, device) -> _DeviceTables:
    """``mol``'s :func:`tables` copied to ``device`` once per structure and
    card (a small LRU); a CUDA graph of :func:`eri` reads them by address,
    so a program holds the object it captured with."""
    device = card(device)
    key = _structure_key(mol)
    return _cached(_DEVICE, (key, device),
                   lambda: _DeviceTables(_cached(_TABLES, key, lambda: _build_tables(mol)),
                                         device))


@lru_cache(maxsize=1)
def build_library() -> ctypes.CDLL:
    """Build (if stale) and load ``csrc/md_eri.cu``."""
    lib = ctypes.CDLL(str(build_shared_library([_nvcc(), *_NVCC_FLAGS], _SRC,
                                               "libnbed_md_eri.so")))
    ptr = ctypes.c_void_p
    lib.nbed_md_eri.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_double, ptr]
    lib.nbed_md_eri.restype = ctypes.c_int
    lib.nbed_md_eri_init.argtypes = [ctypes.c_int]
    lib.nbed_md_eri_init.restype = ctypes.c_int
    return lib


def eri(mol, coords, omega=None):
    """The ERI tensor of ``mol`` at ``coords`` ((natm, 3) or (B, natm, 3),
    float64, bohr): (nao,) * 4 or (B,) + (nao,) * 4, chemist notation;
    ``omega`` > 0 the long-range erf(omega r12) / r12 kernel. CUDA tensors
    and shells up to :data:`LMAX` only, else ``ValueError``."""
    omega = 0.0 if omega is None else float(omega)
    if coords.device.type != "cuda":
        raise ValueError(f"md_eri: the kernel takes CUDA tensors, got {coords.device}")
    lead = tuple(coords.shape[:-2])
    batch = int(np.prod(lead)) if lead else 1
    if not (coords.dtype == torch.float64 and coords.shape[-2:] == (mol.natm, 3)
            and len(lead) <= 1 and 1 <= batch <= 65535):
        raise ValueError(f"md_eri: coordinates must be float64 (natm, 3) or (B, natm, 3) with "
                         f"natm {mol.natm} and B <= 65535, got {coords.dtype} "
                         f"{tuple(coords.shape)}")
    if not covers(mol):
        raise ValueError(f"md_eri: the kernel covers shells up to l = {LMAX}, got "
                         f"l = {max(sh.l for sh in mol.shells)}")
    tab = device_tables(mol, coords.device)
    _, plan_ptr = tab.plan(batch)  # the plan stays alive in tab
    x = coords.contiguous()
    n = tab.host.nao
    scratch = torch.empty(batch * len(tab.host.prim_pairs) * _PAIR_WORDS, dtype=torch.float64,
                          device=x.device)
    out = torch.empty(lead + (n, n, n, n), dtype=torch.float64, device=x.device)
    index = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    with torch.cuda.device(index):
        err = build_library().nbed_md_eri(plan_ptr, x.data_ptr(), scratch.data_ptr(),
                                          out.data_ptr(), omega, stream)
    if err != 0:
        raise RuntimeError(f"md_eri: launch failed with status {err}")
    count_launch(LAUNCHES, "md_eri")
    count_launch(LAUNCHES_BY_SHAPE, (batch, n, len(tab.host.quartets)))
    return out


def owners(tab: Tables):
    """The kernel's write rule in numpy: for every element of the flat
    (nao^4,) output, the block value that writes it, as an index into the
    concatenation of the canonical quartets' spherical blocks (in
    ``tab.quartets``' order, each block row-major), and how many writes it
    gets (the rule gives every element exactly one). Returns (source,
    writes)."""
    n = tab.nao
    shells = tab.shells
    source = np.full(n ** 4, -1, dtype=np.int64)
    writes = np.zeros(n ** 4, dtype=np.int64)
    offset = 0
    for bra, ket in tab.quartets:
        sh = np.array([*tab.pairs[bra, :2], *tab.pairs[ket, :2]])
        nsph = 2 * shells[sh, 0] + 1
        grids = np.meshgrid(*[np.arange(m) for m in nsph], indexing="ij")
        idx = np.stack([shells[sh[k], 3] + grids[k].ravel() for k in range(4)])  # (4, E)
        vals = offset + np.arange(idx.shape[1])
        seen = []
        for perm in _PERMS:
            img, ish = idx[list(perm)], sh[list(perm)]
            c, cs = img.copy(), ish.copy()
            if cs[0] < cs[1]:
                c[[0, 1]], cs[[0, 1]] = c[[1, 0]], cs[[1, 0]]
            if cs[2] < cs[3]:
                c[[2, 3]], cs[[2, 3]] = c[[3, 2]], cs[[3, 2]]
            if (cs[0], cs[1]) < (cs[2], cs[3]):
                c = c[[2, 3, 0, 1]]
            at = ((img[0] * n + img[1]) * n + img[2]) * n + img[3]
            own = (c == idx).all(axis=0)
            for prev in seen:
                own &= at != prev
            seen.append(np.where(own, at, -1))
            source[at[own]] = vals[own]
            np.add.at(writes, at[own], 1)
        offset += idx.shape[1]
    return source, writes


def operations(tab: Tables, batch: int = 1) -> int:
    """Floating-point operations of the kernel's E . R . E contraction for
    ``batch`` lanes (two a multiply-add, the terms its loops visit with
    nonzero E_bra; the Boys series, the R recursion and cart2sph are left
    out): the numerator of its least time at the card's float64 rate."""
    shells = tab.shells
    per_class = {}
    total = 0
    for bra, ket in tab.quartets:
        sh = (*tab.pairs[bra, :2], *tab.pairs[ket, :2])
        ls = tuple(int(shells[s, 0]) for s in sh)
        if ls not in per_class:
            per_class[ls] = _class_terms(ls)
        nprim = np.prod([int(shells[s, 1]) for s in sh])
        total += int(nprim) * per_class[ls]
    return 2 * batch * total


def _class_terms(ls) -> int:
    """Multiply-adds of one primitive quartet of angular class ``ls``:
    each cartesian element's Hermite terms of the bra times those of the ket."""
    def powers(l):
        return [(l - i, i - j, j) for i in range(l + 1) for j in range(i + 1)]

    def terms(la, lb):
        return [int(np.prod([a[d] + b[d] + 1 for d in range(3)]))
                for a in powers(la) for b in powers(lb)]

    bra, ket = terms(*ls[:2]), terms(*ls[2:])
    return sum(tb * (tk + 1) for tb in bra for tk in ket)
