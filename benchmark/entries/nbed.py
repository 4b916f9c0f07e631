"""Entry "nbed": one request is one ``nbed_tpu_torch.embed.nbed()`` call at
the request's geometry with the configuration's settings; its answers are
the numbers the benchmark holds against the reference."""

import numpy as np

from reference.pipeline import hamiltonian_invariants, nbed_answers


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
               "e_hf_emb": float(result["e_rhf"])}
        out.update(hamiltonian_invariants(const, h1.cpu().numpy(), h2.cpu().numpy()))
        for key, name in (("e_ccsd", "e_ccsd"), ("e_fci", "e_fci"),
                          ("e_dft_in_dft", "e_dft_in_dft")):
            if key in result:
                out[name] = float(result[key])
        return out

    def reference(self, request, dtype, device, seed) -> dict:
        return nbed_answers(self.settings, request.geometries[0],
                            request.molecule["n_active_atoms"], dtype, device)

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        """Named gaps between the program's answers and the reference's."""
        gaps = {}
        for name in ("e_ks", "e_hf_emb", "e_ccsd", "e_fci", "e_dft_in_dft", "ham_const",
                     "ham_h2_norm", "n_act", "n_qubits"):
            if name in ref:
                gaps[name] = abs(float(prog.get(name, np.inf)) - float(ref[name]))
        a, b = prog["ham_h1_spectrum"], ref["ham_h1_spectrum"]
        gaps["ham_h1_spectrum"] = float(np.max(np.abs(a - b))) if a.shape == b.shape else np.inf
        return gaps
