"""Integrals: the host C++ engine (``native``) and AO->MO transforms."""

from .transform import ao_to_mo_1e, ao_to_mo_eri

__all__ = ["ao_to_mo_1e", "ao_to_mo_eri"]
