"""Entry "fleet": one request is one
``nbed_tpu_torch.parallel.embed_path.batched_embedding_energies`` call over
the request's conformers, with the active-MO count fixed in set-up by one
``nbed()`` at the publication geometry; its answers are each conformer's
global KS and Huzinaga HF-in-DFT energies."""

import numpy as np

from reference.pipeline import fleet_answers


class Entry:
    def __init__(self, config: dict, traffic: dict, device: str):
        self.settings = dict(config["settings"])
        self.device = device
        self.check_conformers = int(traffic.get("check_conformers", 4))
        self.n_act = None
        self._mols = {}

    def setup(self, traffic):
        """n_act_mos of each molecule from one nbed() at its publication
        geometry, as the lane program's docstring prescribes."""
        from nbed_tpu_torch.chem import build_molecule
        from nbed_tpu_torch.embed import nbed

        self.n_act = {}
        for mol in traffic.molecules:
            driver = nbed(geometry=mol["geometry"], n_active_atoms=mol["n_active_atoms"],
                          device=self.device, **self.settings)
            self.n_act[mol["name"]] = int(len(driver.localized_system.active_mo_inds[0]))
            self._mols[mol["name"]] = build_molecule(mol["geometry"], self.settings["basis"])

    def run(self, request):
        import torch
        from nbed_tpu_torch.parallel.embed_path import batched_embedding_energies

        name = request.molecule["name"]
        coords = torch.as_tensor(request.coords_bohr, dtype=torch.float64)
        out = batched_embedding_energies(
            self._mols[name], coords, request.molecule["n_active_atoms"], self.n_act[name],
            xc=self.settings["xc_functional"], projector="huzinaga", device=self.device)
        return out, coords.shape[0]

    @staticmethod
    def timings(out) -> dict:
        return {}

    def answers(self, out, request) -> dict:
        return {"e_global": out["e_global"].cpu().numpy(),
                "e_emb": out["e_emb_rhf"].cpu().numpy(),
                "converged": out["converged"].cpu().numpy()}

    def conformers(self, request, seed):
        """The conformers of a request the check compares, drawn from the
        seed."""
        rng = np.random.default_rng([int(seed) % 2 ** 64, 4, request.index])
        n = len(request.geometries)
        return sorted(rng.choice(n, size=min(n, self.check_conformers), replace=False).tolist())

    def reference(self, request, dtype, device, seed) -> dict:
        conformers = self.conformers(request, seed)
        n_act = self.n_act[request.molecule["name"]]
        rows = [fleet_answers(self.settings["xc_functional"], request.geometries[i],
                              request.molecule["n_active_atoms"], n_act, dtype, device)
                for i in conformers]
        out = {key: np.array([r[key] for r in rows]) for key in ("e_global", "e_emb")}
        out["conformers"] = conformers
        return out

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict:
        conformers = ref["conformers"]
        return {"e_global": float(np.max(np.abs(prog["e_global"][conformers] - ref["e_global"]))),
                "e_emb": float(np.max(np.abs(prog["e_emb"][conformers] - ref["e_emb"]))),
                "not_converged": float(np.sum(~prog["converged"].astype(bool)))}
