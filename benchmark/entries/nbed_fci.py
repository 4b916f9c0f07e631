"""Entry "nbed_fci": one request is one ``nbed_tpu_torch.embed.nbed()`` call
with the embedded FCI on, as entry "nbed" makes it; the reference gives
everything up to the embedded Hamiltonian with ``reference.pipeline``'s
functions, and ``e_fci`` with the matrix-free ``reference.fci_direct``:
the dense ``correlated.fci_energy`` would need the sector's whole matrix
(acetonitrile's 28 qubits: 11,778,624 determinants)."""

import numpy as np
import torch

from reference.correlated import ccsd_energy
from reference.fci_direct import fci_energy_direct
from reference.pipeline import (TOLERANCES, System, _concentric, _keep_after_deletion,
                                _spin_orbital, hamiltonian_invariants)

NAMES = ("e_ks", "e_hf_emb", "e_ccsd", "e_fci", "ham_const", "ham_h2_norm", "n_act",
         "n_qubits")


def fci_answers(config: dict, xyz: str, n_active_atoms: int, dtype=torch.float64,
                device="cpu") -> dict:
    """The numbers the cell compares for one request: the steps of
    ``pipeline.nbed_answers`` up to the embedded Hamiltonian, its CCSD,
    and its FCI matrix-free."""
    system = System(xyz, config["xc_functional"], dtype, device)
    projector = config["projector"]
    mu = float(config.get("mu_level_shift", 1e6))
    out = {}
    e_ks, c = system.global_ks()
    out["e_ks"] = e_ks
    n_act, c_act, c_env = system.spade(c, n_active_atoms)
    out["n_act"] = n_act
    d_act, d_env = c_act @ c_act.T, c_env @ c_env.T
    _, e_env, cross, v_emb = system.subsystem(2 * d_act, 2 * d_env)
    e_emb, c_emb, _, _, v_frozen = system.embedded_scf(projector, v_emb, d_act, d_env, n_act, mu)
    corr = float(torch.sum(v_frozen * 2 * d_act))
    out["e_hf_emb"] = e_emb + e_env + cross - corr
    keep = _keep_after_deletion(projector, c_emb, system.s @ d_env @ system.s,
                                system.nocc - n_act)
    c_kept = c_emb[:, keep]
    if config.get("virtual_localization", "cl") == "cl":
        dm = 2 * c_kept[:, :n_act] @ c_kept[:, :n_act].T
        v2, _, _ = system.two_electron(dm, functional=False)
        c_kept = _concentric(system, c_kept[:, :n_act], c_kept[:, n_act:],
                             system.h + v_frozen + v2,
                             system.basis.n_aos_of_first_atoms(n_active_atoms),
                             int(config.get("max_shells", 4)))
    h1 = c_kept.T @ (system.h + v_frozen) @ c_kept
    eri_mo = torch.einsum("pqrs,pi,qj,rk,sl->ijkl", system.eri, c_kept, c_kept, c_kept, c_kept)
    h1s, h2s = _spin_orbital(h1, eri_mo)
    base = e_env + cross - corr + system.e_nuc
    out.update(hamiltonian_invariants(base, h1s.cpu(), 0.5 * h2s.cpu()))
    if config.get("run_ccsd_emb"):
        e_ref, e_corr = ccsd_energy(h1s, h2s, 2 * n_act, tol=TOLERANCES[dtype][2])
        out["e_ccsd"] = e_ref + e_corr + base
    # the spatial integrals back from the spin-orbital tensors the solver is
    # handed: chem (pq|rs) = h2[p, r, s, q]
    h_sp = h1s[::2, ::2]
    chem = h2s[::2, ::2, ::2, ::2].permute(0, 3, 1, 2)
    del system, h2s, eri_mo
    out["e_fci"] = fci_energy_direct(h_sp, chem, n_act, n_act, dtype, device) + base
    return out


class Entry:
    def __init__(self, config: dict, traffic: dict, device: str):
        self.settings = dict(config["settings"])
        self.device = device

    def setup(self, traffic):
        """Nothing beyond the warm-up requests."""

    def run(self, request):
        """The driver of one call, and the work it did (one request)."""
        from nbed_tpu_torch.embed import nbed

        driver = nbed(geometry=request.geometries[0],
                      n_active_atoms=request.molecule["n_active_atoms"], device=self.device,
                      **self.settings)
        return driver, 1

    @staticmethod
    def timings(driver) -> dict:
        return dict(driver.timings)

    def answers(self, driver, request) -> dict:
        """The program's numbers, on the host."""
        result = driver.huzinaga if self.settings["projector"] == "huzinaga" else driver.mu
        const, h1, h2 = result["second_quantised"]
        out = {"e_ks": float(driver._global_ks.e_tot),
               "n_act": int(len(driver.localized_system.active_mo_inds[0])),
               "e_hf_emb": float(result["e_rhf"]), "e_fci": float(result["e_fci"])}
        out.update(hamiltonian_invariants(const, h1.cpu().numpy(), h2.cpu().numpy()))
        if "e_ccsd" in result:
            out["e_ccsd"] = float(result["e_ccsd"])
        return out

    def reference(self, request, dtype, device, seed) -> dict:
        return fci_answers(self.settings, request.geometries[0],
                           request.molecule["n_active_atoms"], dtype, device)

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        """Named gaps between the program's answers and the reference's."""
        gaps = {name: abs(float(prog.get(name, np.inf)) - float(ref[name]))
                for name in NAMES if name in ref}
        a, b = prog["ham_h1_spectrum"], ref["ham_h1_spectrum"]
        gaps["ham_h1_spectrum"] = float(np.max(np.abs(a - b))) if a.shape == b.shape else np.inf
        return gaps
