"""ctypes binding of the port's own build of the C++ McMurchie-Davidson
integral engine (``nbed_tpu/native/md_integrals.cpp``).

Host code, not a kernel: S, T, V and the ERI tensor are made on the CPU in
float64 and moved to the device by the SCF engine, the same division of
labour as ``nbed_tpu.native`` (``nbed_tpu/native/__init__.py:143-253``).
"""

import ctypes
from functools import lru_cache

import numpy as np

from .._reference_files import native_integrals_library

__all__ = ["one_electron", "eri"]

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
    ]
    lib.nbed_eri.restype = None
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
    """(S, T, V) as float64 numpy arrays (nao, nao); no MM point charges
    (QM/MM is ROADMAP queue 1 item 8)."""
    meta, exps, coefs, c2s = _pack(mol)
    coords = _coords(mol, coords)
    charges = np.asarray(mol.atom_charges, dtype=np.float64)
    nao = mol.nao
    s, t, v = (np.zeros((nao, nao)) for _ in range(3))
    no_centers, no_charges = np.zeros((1, 3)), np.zeros(1)
    _lib().nbed_one_electron(
        len(mol.shells), meta.ctypes.data_as(_IPTR),
        _dp(exps), _dp(coefs), _dp(c2s), _dp(coords),
        mol.natm, _dp(charges),
        0, _dp(no_centers), _dp(no_charges), ctypes.cast(None, _DPTR),
        _dp(s), _dp(t), _dp(v),
    )
    return s, t, v


def eri(mol, coords=None):
    """Full (nao, nao, nao, nao) ERI tensor in chemist notation, float64."""
    meta, exps, coefs, c2s = _pack(mol)
    coords = _coords(mol, coords)
    nao = mol.nao
    out = np.zeros((nao, nao, nao, nao))
    _lib().nbed_eri(
        len(mol.shells), meta.ctypes.data_as(_IPTR),
        _dp(exps), _dp(coefs), _dp(c2s), _dp(coords), _dp(out), 0.0,
    )
    return out
