"""ctypes binding of the C++ McMurchie-Davidson integral engine
(``nbed_tpu_torch/csrc/md_integrals.cpp``, the port's copy of the
reference's ``nbed_tpu/native/md_integrals.cpp``).

Host code, not a kernel: S, T, V, the ERI tensor and the density-fitting
integrals are made on the CPU in float64 and moved to the device by the SCF
engine, the same division of labour as ``nbed_tpu.native``
(``nbed_tpu/native/__init__.py:143-253``). The three-centre integrals, the
one host cost that grows with the molecule, run in blocks of auxiliary
shells on a thread per core: ctypes releases the interpreter lock and the
engine keeps its scratch in ``thread_local`` storage. :data:`CALLS` counts
the calls of each public function.
"""

import ctypes
import os
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from functools import lru_cache

import numpy as np

from .._compile import native_integrals_library

__all__ = ["one_electron", "eri", "eri_3c", "eri_2c", "CALLS"]

# calls of the public functions by kind ("one_electron", "eri", "eri_3c",
# "eri_2c"), summed per process
CALLS = Counter()

_DPTR = ctypes.POINTER(ctypes.c_double)
_IPTR = ctypes.POINTER(ctypes.c_int32)


@lru_cache(maxsize=1)
def _lib():
    lib = native_integrals_library()
    lib.nbed_one_electron.argtypes = [
        ctypes.c_int, _IPTR, _DPTR, _DPTR, _DPTR, _DPTR, ctypes.c_int, _DPTR,
        ctypes.c_int, _DPTR, _DPTR, _DPTR, _DPTR, _DPTR, _DPTR,
    ]
    lib.nbed_one_electron.restype = None
    lib.nbed_eri.argtypes = [
        ctypes.c_int, _IPTR, _DPTR, _DPTR, _DPTR, _DPTR, _DPTR, ctypes.c_double,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.nbed_eri.restype = None
    lib.nbed_eri_3c.argtypes = [
        ctypes.c_int, _IPTR, _DPTR, _DPTR, _DPTR, _DPTR,
        ctypes.c_int, _IPTR, _DPTR, _DPTR, _DPTR, _DPTR, ctypes.c_double,
    ]
    lib.nbed_eri_3c.restype = None
    lib.nbed_eri_2c.argtypes = [
        ctypes.c_int, _IPTR, _DPTR, _DPTR, _DPTR, _DPTR, _DPTR, ctypes.c_double,
    ]
    lib.nbed_eri_2c.restype = None
    return lib


def _pack(mol):
    """Flatten the shell tables into the C ABI layout."""
    meta, exps, coefs, c2s = [], [], [], []
    exp_off = c2s_off = 0
    for sh in mol.shells:
        meta.append([sh.l, len(sh.exps), sh.atom, sh.ao_offset, exp_off, c2s_off])
        exps.extend(sh.exps)
        coefs.extend(sh.coeffs)
        c2s.extend(np.asarray(sh.cart2sph).ravel().tolist())
        exp_off += len(sh.exps)
        c2s_off += np.asarray(sh.cart2sph).size
    return (np.asarray(meta, dtype=np.int32), np.asarray(exps, dtype=np.float64),
            np.asarray(coefs, dtype=np.float64), np.asarray(c2s, dtype=np.float64))


def _dp(a):
    return a.ctypes.data_as(_DPTR)


def _coords(mol, coords):
    return np.ascontiguousarray(mol.coords if coords is None else coords,
                                dtype=np.float64)


def one_electron(mol, coords=None):
    """(S, T, V) as float64 numpy arrays (nao, nao). V includes the
    molecule's MM charges when it has them: point charges, or Gaussian
    charges of exponent 1/mm_radii**2 when radii are given
    (``nbed_tpu/native/__init__.py:166-196``)."""
    CALLS["one_electron"] += 1
    meta, exps, coefs, c2s = _pack(mol)
    coords = _coords(mol, coords)
    charges = np.asarray(mol.atom_charges, dtype=np.float64)
    nao = mol.nao
    s, t, v = (np.zeros((nao, nao)) for _ in range(3))
    if mol.mm_coords is not None:
        n_extra = len(mol.mm_charges)
        centers = np.ascontiguousarray(mol.mm_coords, dtype=np.float64)
        q = np.ascontiguousarray(mol.mm_charges, dtype=np.float64)
        etas = (None if mol.mm_radii is None else
                np.ascontiguousarray(1.0 / np.asarray(mol.mm_radii, dtype=np.float64) ** 2))
    else:
        n_extra, centers, q, etas = 0, np.zeros((1, 3)), np.zeros(1), None
    _lib().nbed_one_electron(
        len(mol.shells), meta.ctypes.data_as(_IPTR),
        _dp(exps), _dp(coefs), _dp(c2s), _dp(coords),
        mol.natm, _dp(charges),
        n_extra, _dp(centers), _dp(q),
        ctypes.cast(None, _DPTR) if etas is None else _dp(etas),
        _dp(s), _dp(t), _dp(v),
    )
    return s, t, v


def eri(mol, coords=None, omega: float = 0.0):
    """Full (nao, nao, nao, nao) ERI tensor in chemist notation, float64.
    ``omega > 0`` evaluates the long-range erf(omega*r12)/r12 kernel of
    range-separated exchange. The unique quartets are split by their first
    shell into ranges of about equal work, evaluated on one thread per
    available core into disjoint elements of the result; each integral is
    computed exactly as in one call."""
    CALLS["eri"] += 1
    meta, exps, coefs, c2s = _pack(mol)
    coords = _coords(mol, coords)
    nao, n_sh = mol.nao, len(mol.shells)
    out = np.zeros((nao, nao, nao, nao))
    n_threads = len(os.sched_getaffinity(0))
    # the quartets of first shell ia number ~ (ia + 1)^3 / 2
    work = np.cumsum((np.arange(n_sh) + 1.0) ** 3)
    cuts = np.searchsorted(work, work[-1] * np.arange(1, 4 * n_threads) / (4 * n_threads))
    ranges = [(lo, hi) for lo, hi in zip([0, *cuts], [*cuts, n_sh]) if hi > lo]

    def fill(rng):
        _lib().nbed_eri(n_sh, meta.ctypes.data_as(_IPTR), _dp(exps), _dp(coefs), _dp(c2s),
                        _dp(coords), _dp(out), float(omega), int(rng[0]), int(rng[1]))

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        list(pool.map(fill, ranges[::-1]))
    return out


def _eri_3c_block(mol, aux, coords, omega):
    """(nao, nao, aux.nao) for one block of auxiliary shells."""
    meta, exps, coefs, c2s = _pack(mol)
    ameta, aexps, acoefs, ac2s = _pack(aux)
    out = np.zeros((mol.nao, mol.nao, aux.nao))
    _lib().nbed_eri_3c(
        len(mol.shells), meta.ctypes.data_as(_IPTR),
        _dp(exps), _dp(coefs), _dp(c2s), _dp(coords),
        len(aux.shells), ameta.ctypes.data_as(_IPTR),
        _dp(aexps), _dp(acoefs), _dp(ac2s), _dp(out), float(omega),
    )
    return out


def _aux_blocks(aux, n_blocks: int):
    """Split ``aux`` into up to ``n_blocks`` molecules of consecutive shells
    with about equal cartesian work each, AO offsets renumbered from 0.
    Returns ``[(first aux AO, block molecule), ...]``."""
    work = np.cumsum([(sh.l + 1) * (sh.l + 2) // 2 for sh in aux.shells])
    cuts = np.searchsorted(work, work[-1] * np.arange(1, n_blocks) / n_blocks)
    blocks = []
    for lo, hi in zip([0, *cuts], [*cuts, len(aux.shells)]):
        if hi <= lo:
            continue
        first = aux.shells[lo].ao_offset
        shells = tuple(replace(sh, ao_offset=sh.ao_offset - first)
                       for sh in aux.shells[lo:hi])
        blocks.append((first, replace(aux, shells=shells)))
    return blocks


def eri_3c(mol, aux, coords=None, omega: float = 0.0):
    """Three-centre DF integrals (ab|P): (nao, nao, naux) float64.

    ``omega > 0`` evaluates the long-range erf(omega*r12)/r12 kernel. The
    auxiliary shells are split into blocks evaluated on one thread per
    available core; each integral is computed exactly as in one call."""
    CALLS["eri_3c"] += 1
    coords = _coords(mol, coords)
    n_threads = len(os.sched_getaffinity(0))
    out = np.empty((mol.nao, mol.nao, aux.nao))

    def fill(block):
        # each worker copies its block into place and drops it, so at most
        # one block per thread is alive beside ``out``
        first, blk = block
        out[:, :, first:first + blk.nao] = _eri_3c_block(mol, blk, coords, omega)

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        list(pool.map(fill, _aux_blocks(aux, 4 * n_threads)))
    return out


def eri_2c(aux, coords=None, omega: float = 0.0):
    """Two-centre Coulomb metric (P|Q): (naux, naux) float64.

    ``omega > 0`` evaluates the long-range erf(omega*r12)/r12 kernel."""
    CALLS["eri_2c"] += 1
    ameta, aexps, acoefs, ac2s = _pack(aux)
    coords = _coords(aux, coords)
    out = np.zeros((aux.nao, aux.nao))
    _lib().nbed_eri_2c(
        len(aux.shells), ameta.ctypes.data_as(_IPTR),
        _dp(aexps), _dp(acoefs), _dp(ac2s), _dp(coords), _dp(out), float(omega),
    )
    return out
