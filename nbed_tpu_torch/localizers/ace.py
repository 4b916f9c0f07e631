"""ACE-of-SPADE reaction-path localization (10.1021/acs.jctc.3c00653; port
of ``nbed_tpu/localizers/ace.py``).

A host-side Fermi-distribution fit (scipy) of the SPADE singular-value gaps
along a reaction path, giving one active-MO count for the whole path.
"""

import logging

import numpy as np
from scipy.optimize import curve_fit, minimize

from .occupied import SPADELocalizer

logger = logging.getLogger(__name__)

__all__ = ["ACELocalizer"]


class ACELocalizer:
    """Consistent SPADE active-space size along a geometry path."""

    def __init__(self, global_scf_list, n_active_atoms: int, max_shells: int = 4):
        self.global_scf_list = global_scf_list
        self.n_active_atoms = n_active_atoms
        self.max_shells = max_shells
        if len({tuple(g.mo_coeff.shape) for g in global_scf_list}) != 1:
            raise ValueError("Global SCF inputs must have the same mo_coeff shape.")

    def localize_path(self) -> tuple:
        """Return (n_mo_alpha, n_mo_beta) to use along the whole path."""
        singular_values = []
        for scf_object in self.global_scf_list:
            loc = SPADELocalizer(scf_object, self.n_active_atoms, self.max_shells)
            loc.localize()
            singular_values.append(loc.enviro_selection_condition)
        alpha = self.localize_spin([s[0] for s in singular_values])
        beta = self.localize_spin([s[1] for s in singular_values])
        logger.debug("ACE-of-SPADE complete: %s", (alpha, beta))
        return (alpha, beta)

    @staticmethod
    def localize_spin(singular_values) -> int:
        """Fermi-distribution fit over singular-value gaps -> MO count
        (reference ace.py:47-71)."""

        def fermi_dist(diff_i_max, beta):
            return beta * np.exp(beta * diff_i_max) / (1 + np.exp(beta * diff_i_max)) ** 1.5

        max_vals = []
        diff_i_max = None
        for val_set in singular_values:
            vals = np.asarray(val_set)
            diffs = vals[:-1] - vals[1:]
            max_i = int(np.argmax(diffs))
            diff_i_max = np.array([i - max_i for i in range(len(vals))])
            beta_fit, _ = curve_fit(fermi_dist, diff_i_max, vals)
            res = minimize(lambda d: -fermi_dist(d, beta_fit), max_i)
            max_vals.append(res.x[0])

        mean_max = np.mean(max_vals)
        # one zero in diff_i_max, so a (1, 1) array
        nmo = mean_max + np.argwhere(diff_i_max == np.int64(0)) + 0.5
        return int(nmo.item()) + 1
