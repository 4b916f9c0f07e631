"""Localized-system data contract (port of ``nbed_tpu/localizers/system.py``)."""

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["LocalizedSystem"]


@dataclass
class LocalizedSystem:
    """Active/environment partition of the occupied space.

    Index arrays are numpy (host bookkeeping); coefficients are stacked
    (2, n, k) tensors, one block per spin. Density matrices are derived as
    C C^T.
    """

    active_mo_inds: np.ndarray
    enviro_mo_inds: np.ndarray
    c_active: torch.Tensor
    c_enviro: torch.Tensor
    c_loc_occ: torch.Tensor
    c_loc_virt: torch.Tensor | None = None
    dm_active: torch.Tensor = field(init=False)
    dm_enviro: torch.Tensor = field(init=False)
    dm_loc_occ: torch.Tensor = field(init=False)

    def __post_init__(self):
        self.dm_active = self.c_active @ self.c_active.transpose(-1, -2)
        self.dm_enviro = self.c_enviro @ self.c_enviro.transpose(-1, -2)
        self.dm_loc_occ = self.c_loc_occ @ self.c_loc_occ.transpose(-1, -2)
