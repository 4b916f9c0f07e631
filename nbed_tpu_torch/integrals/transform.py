"""AO -> MO integral transforms as quarter-transform einsum chains
(port of ``nbed_tpu/integrals/transform.py``)."""

import torch

__all__ = ["ao_to_mo_1e", "ao_to_mo_eri"]


def ao_to_mo_1e(h_ao, c_left, c_right=None):
    """C_left^T h C_right."""
    c_right = c_left if c_right is None else c_right
    return c_left.T @ h_ao @ c_right


def ao_to_mo_eri(eri_ao, c1, c2=None, c3=None, c4=None):
    """(ij|kl)_MO = sum (mu nu|la si) C_mu i C_nu j C_la k C_si l, O(N^5)."""
    c2 = c1 if c2 is None else c2
    c3 = c1 if c3 is None else c3
    c4 = c1 if c4 is None else c4
    out = torch.einsum("uvls,ui->ivls", eri_ao, c1)
    out = torch.einsum("ivls,vj->ijls", out, c2)
    out = torch.einsum("ijls,lk->ijks", out, c3)
    return torch.einsum("ijks,sl->ijkl", out, c4)
