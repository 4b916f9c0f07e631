"""The reference embedding pipeline, closed shell, in plain PyTorch: global
KS, SPADE, the subsystem-DFT decomposition, the mu-shift or Huzinaga
embedded HF, the environment's deletion, concentric virtuals, the
spin-orbital Hamiltonian, CCSD, FCI and DFT-in-DFT, after projection-based
embedding as Nbed defines it (PRA 109, 022418). Every SCF here converges
far tighter than the program's, so the gap between the two is the
program's."""

import numpy as np
import torch

from .correlated import ccsd_energy, fci_energy
from .dft import FUNCTIONALS, XCEnergy, build_grid
from .integrals import build_basis, eri_tensor, overlap_kinetic_nuclear

__all__ = ["System", "nbed_answers", "fleet_answers", "TOLERANCES"]

# SCF and CCSD stopping rules by dtype: (energy change, commutator, CCSD)
TOLERANCES = {torch.float64: (1e-11, 1e-8, 1e-10), torch.float32: (1e-6, 1e-4, 1e-6)}
# coefficients the Hamiltonian builder drops (OpenFermion's EQ_TOLERANCE)
_EQ_TOLERANCE = 1e-8


class System:
    """One molecule's operators at one geometry."""

    def __init__(self, xyz, xc, dtype=torch.float64, device="cpu", grid_level=3):
        self.dtype, self.device = dtype, device
        self.basis = build_basis(xyz)
        s, t, v = overlap_kinetic_nuclear(self.basis, torch.float64, device)
        eri = eri_tensor(self.basis, torch.float64, device)
        self.s, self.h, self.eri = s.to(dtype), (t + v).to(dtype), eri.to(dtype)
        self.e_nuc = self.basis.energy_nuc()
        self.nocc = self.basis.nelectron // 2
        if xc is not None:
            grid = build_grid(self.basis.charges, self.basis.coords, grid_level, dtype, device)
            self.xc = XCEnergy(FUNCTIONALS[xc], self.basis, grid)
            self.hyb = FUNCTIONALS[xc].hyb
        else:
            self.xc, self.hyb = None, 1.0
        w, v = torch.linalg.eigh(self.s)
        self.x = (v / torch.sqrt(w)) @ v.T
        self.s_half = (v * torch.sqrt(w)) @ v.T

    def jk(self, dm):
        return (torch.einsum("ijkl,kl->ij", self.eri, dm),
                torch.einsum("ikjl,kl->ij", self.eri, dm))

    def two_electron(self, dm, functional=True):
        """(V, E_2) of total density ``dm``: J - hyb K / 2 (+ V_xc) and its
        energy; HF exchange alone where ``functional`` is False."""
        j, k = self.jk(dm)
        hyb = self.hyb if functional else 1.0
        v = j - 0.5 * hyb * k
        e = 0.5 * torch.sum(j * dm) - 0.25 * hyb * torch.sum(k * dm)
        if functional and self.xc is not None:
            exc, vxc = self.xc(dm)
            v, e = v + vxc, e + exc
        return v, e, j

    def scf(self, h_eff, nocc, functional, dm0=None, env_spin=None, max_cycle=200):
        """Closed-shell SCF on ``h_eff``; with ``env_spin`` (an environment
        density of one spin) the Huzinaga operator -(F D S + S D F) joins
        the Fock matrix. Returns (E_elec, C, eps, D, Huzinaga operator)."""
        e_tol, c_tol, _ = TOLERANCES[self.dtype]
        s, x = self.s, self.x

        def fock(dm):
            v, e2, _ = self.two_electron(dm, functional)
            f0 = h_eff + v
            huz = torch.zeros_like(f0)
            if env_spin is not None:
                fds = f0 @ env_spin @ s
                huz = -(fds + fds.T)
            return f0 + huz, huz, torch.sum((h_eff + huz) * dm) + e2

        def solve(f):
            eps, c = torch.linalg.eigh(x @ f @ x)
            c = x @ c
            return eps, c, 2 * c[:, :nocc] @ c[:, :nocc].T

        if dm0 is None:
            f0 = h_eff
            if env_spin is not None:
                fds = f0 @ env_spin @ s
                f0 = f0 - (fds + fds.T)
            dm0 = solve(f0)[2]
        dm, e_old, fs, errs = dm0, None, [], []
        for _ in range(max_cycle):
            f, huz, e = fock(dm)
            err = x @ (f @ dm @ s - s @ dm @ f) @ x
            fs, errs = (fs + [f])[-8:], (errs + [err])[-8:]
            m = len(fs)
            b = torch.zeros((m + 1, m + 1), dtype=f.dtype, device=f.device)
            b[:m, :m] = torch.stack([torch.stack([torch.sum(a * c) for c in errs]) for a in errs])
            b[:m, :m] /= b[:m, :m].diagonal().max()
            b[m, :m] = b[:m, m] = -1.0
            rhs = torch.zeros(m + 1, dtype=f.dtype, device=f.device)
            rhs[m] = -1.0
            coef = torch.linalg.lstsq(b, rhs[:, None]).solution[:m, 0]
            f_use = sum(c * fi for c, fi in zip(coef, fs))
            if e_old is not None and abs(float(e - e_old)) < e_tol and \
                    float(err.abs().max()) < c_tol:
                f, huz, e = fock(dm)
                eps, c, _ = solve(f)
                return float(e), c, eps, dm, huz
            e_old = e
            dm = solve(f_use)[2]
        if self.dtype == torch.float64:
            raise RuntimeError("reference SCF did not converge")
        # below float64 (the control) an SCF may stall at its rounding
        # (the 1e6 mu shift): its last iterate is its answer
        f, huz, e = fock(dm)
        eps, c, _ = solve(f)
        return float(e), c, eps, dm, huz

    # ------------------------------------------------------------ stages

    def global_ks(self):
        e, c, eps, dm, _ = self.scf(self.h, self.nocc, True)
        return e + self.e_nuc, c

    def spade(self, c, n_active_atoms, n_act=None):
        """(n_act, C_act, C_env) of the occupied space by SPADE: the SVD of
        the active atoms' rows of S^1/2 C_occ, split at the largest gap."""
        occ = c[:, :self.nocc]
        rows = self.basis.n_aos_of_first_atoms(n_active_atoms)
        _, sigma, vh = torch.linalg.svd((self.s_half @ occ)[:rows], full_matrices=True)
        if n_act is None:
            sig = sigma.double().cpu().numpy()
            diffs = sig[:-1] - sig[1:]
            n_act = 1 if len(sig) == 1 else int(np.argmax(diffs)) + 1
        v = vh.T
        return n_act, occ @ v[:, :n_act], occ @ v[:, n_act:]

    def subsystem(self, dm_act, dm_env):
        """(e_act, e_env, two_e_cross, v_emb) for total densities."""
        parts = []
        for dm in (dm_act, dm_env, dm_act + dm_env):
            j, k = self.jk(dm)
            v, e2, _ = self.two_electron(dm)
            exc = e2 - 0.5 * torch.sum(j * dm)
            parts.append((torch.sum(self.h * dm) + e2, v, exc, j))
        (e_act, v_act, x_act, j_act), (e_env, _, x_env, j_env), (_, v_tot, x_tot, _) = parts
        cross = 0.5 * (torch.sum(dm_act * j_env) + torch.sum(dm_env * j_act)) \
            + x_tot - x_act - x_env
        return float(e_act), float(e_env), float(cross), v_tot - v_act

    def embedded_scf(self, projector, v_emb, dm_act_spin, dm_env_spin, n_act, mu,
                     functional=False):
        """(E_emb total, C, eps, D, v_emb as frozen) of the embedded SCF."""
        dm0 = 2 * dm_act_spin
        if projector == "mu":
            v = v_emb + mu * self.s @ dm_env_spin @ self.s
            e, c, eps, dm, _ = self.scf(self.h + v, n_act, functional, dm0)
            return e + self.e_nuc, c, eps, dm, v
        e, c, eps, dm, huz = self.scf(self.h + v_emb, n_act, functional, dm0, dm_env_spin)
        return e + self.e_nuc, c, eps, dm, huz + v_emb


def _keep_after_deletion(projector, c, env_proj, n_env):
    """MO columns kept once the environment's are removed."""
    n = c.shape[1]
    if projector == "mu":
        return list(range(n - n_env))
    overlap = torch.einsum("pi,pq,qi->i", c, env_proj, c).double().cpu().numpy()
    drop = set(int(i) for i in np.argsort(overlap)[::-1][:n_env])
    return [i for i in range(n) if i not in drop]


def _concentric(system, c_occ, c_virt, fock, n_act_aos, max_shells):
    """Concentric localization of the embedded virtuals (Claudino and
    Mayhall, JCTC 15, 6085): the columns kept, occupied first."""
    s = system.s
    s_aa, s_a = s[:n_act_aos, :n_act_aos], s[:n_act_aos]

    def span(sigma):
        return int(torch.sum(sigma[:n_act_aos] >= 1e-15))

    left = torch.linalg.inv(s_aa) @ s_a @ c_virt
    _, sigma, vh = torch.linalg.svd(left.T @ s_a @ c_virt)
    size = span(sigma)
    right = vh.T
    total = torch.cat([c_occ, c_virt @ right[:, :size]], dim=1)
    ker = c_virt @ right[:, size:]
    if ker.shape[1] == 1:
        return torch.cat([total, ker], dim=1)
    if ker.shape[1] == 0:
        return total
    for _ in range(max_shells):
        _, sigma, vh = torch.linalg.svd(total.T @ fock @ ker)
        size = span(sigma)
        if size == 0:
            return torch.cat([total, ker], dim=1)
        right = vh.T
        total = torch.cat([total, ker @ right[:, :size]], dim=1)
        rest = right[:, size:]
        if rest.shape[1] == 0:
            return total
        ker = ker @ rest
        if rest.shape[1] == 1:
            return torch.cat([total, ker], dim=1)
    return total


def _spin_orbital(h1, eri_mo):
    """(h1, h2) interleaved spin orbitals, OpenFermion order h2[p,q,r,s] =
    (ps|qr), entries under the builder's tolerance zeroed."""
    k = h1.shape[0]
    n = 2 * k
    h1s = h1.new_zeros((n, n))
    h1s[::2, ::2] = h1
    h1s[1::2, 1::2] = h1
    phys = eri_mo.permute(0, 2, 3, 1)          # [p, r, s, q] = (pq|rs)
    h2 = h1.new_zeros((n, n, n, n))
    h2[::2, ::2, ::2, ::2] = phys
    h2[1::2, 1::2, 1::2, 1::2] = phys
    h2[::2, 1::2, 1::2, ::2] = phys
    h2[1::2, ::2, ::2, 1::2] = phys
    h1s[torch.abs(h1s) < _EQ_TOLERANCE] = 0.0
    h2[torch.abs(h2) < _EQ_TOLERANCE] = 0.0
    return h1s, h2


def hamiltonian_invariants(const, h1, h2_half):
    """The numbers of a spin-orbital Hamiltonian that a rotation of its
    orbitals leaves alone: qubits, constant, sorted one-body spectrum and
    the two-body Frobenius norm."""
    return {"n_qubits": int(h1.shape[0]), "ham_const": float(const),
            "ham_h1_spectrum": np.sort(np.linalg.eigvalsh(np.asarray(h1, dtype=np.float64))),
            "ham_h2_norm": float(np.linalg.norm(np.asarray(h2_half, dtype=np.float64)))}


def nbed_answers(config: dict, xyz: str, n_active_atoms: int, dtype=torch.float64,
                 device="cpu") -> dict:
    """Every number the benchmark compares for one ``nbed()`` request."""
    system = System(xyz, config["xc_functional"], dtype, device)
    projector = config["projector"]
    mu = float(config.get("mu_level_shift", 1e6))
    out = {}
    e_ks, c = system.global_ks()
    out["e_ks"] = e_ks
    n_act, c_act, c_env = system.spade(c, n_active_atoms)
    out["n_act"] = n_act
    d_act, d_env = c_act @ c_act.T, c_env @ c_env.T
    e_act, e_env, cross, v_emb = system.subsystem(2 * d_act, 2 * d_env)
    e_emb, c_emb, _, _, v_frozen = system.embedded_scf(projector, v_emb, d_act, d_env, n_act, mu)
    corr = float(torch.sum(v_frozen * 2 * d_act))
    out["e_hf_emb"] = e_emb + e_env + cross - corr
    classical = e_env + cross + system.e_nuc - corr

    n_env = system.nocc - n_act
    keep = _keep_after_deletion(projector, c_emb, system.s @ d_env @ system.s, n_env)
    c_kept = c_emb[:, keep]
    if config.get("virtual_localization", "cl") == "cl":
        dm = 2 * c_kept[:, :n_act] @ c_kept[:, :n_act].T
        v2, _, _ = system.two_electron(dm, functional=False)
        fock = system.h + v_frozen + v2
        n_act_aos = system.basis.n_aos_of_first_atoms(n_active_atoms)
        c_kept = _concentric(system, c_kept[:, :n_act], c_kept[:, n_act:], fock, n_act_aos,
                             int(config.get("max_shells", 4)))
    h1 = c_kept.T @ (system.h + v_frozen) @ c_kept
    eri_mo = torch.einsum("pqrs,pi,qj,rk,sl->ijkl", system.eri, c_kept, c_kept, c_kept, c_kept)
    h1s, h2s = _spin_orbital(h1, eri_mo)
    out.update(hamiltonian_invariants(classical, h1s.cpu(), 0.5 * h2s.cpu()))
    base = e_env + cross - corr + system.e_nuc
    if config.get("run_ccsd_emb"):
        e_ref, e_corr = ccsd_energy(h1s, h2s, 2 * n_act, tol=TOLERANCES[dtype][2])
        out["e_ccsd"] = e_ref + e_corr + base
    if config.get("run_fci_emb"):
        # the spatial integrals back from the spin-orbital tensors the
        # solver would be handed: chem (pq|rs) = h2[p, r, s, q]
        h_sp = h1s[::2, ::2].cpu().numpy()
        chem = h2s[::2, ::2, ::2, ::2].permute(0, 3, 1, 2).cpu().numpy()
        out["e_fci"] = fci_energy(h_sp, chem, n_act, n_act, h_sp.dtype) + base
    if config.get("run_dft_in_dft"):
        _, _, _, y, v = system.embedded_scf(projector, v_emb, d_act, d_env, n_act, mu,
                                            functional=True)
        _, e2, _ = system.two_electron(y)
        correction = float(torch.sum(v * (y - 2 * d_act)))
        out["e_dft_in_dft"] = float(torch.sum(system.h * y) + e2) + e_env + cross \
            + correction + system.e_nuc
    return out


def fleet_answers(xc: str, xyz: str, n_active_atoms: int, n_act: int, dtype=torch.float64,
                  device="cpu") -> dict:
    """The global KS and the Huzinaga HF-in-DFT energy of one conformer at
    a fixed active-MO count."""
    system = System(xyz, xc, dtype, device)
    e_ks, c = system.global_ks()
    _, c_act, c_env = system.spade(c, n_active_atoms, n_act)
    d_act, d_env = c_act @ c_act.T, c_env @ c_env.T
    _, e_env, cross, v_emb = system.subsystem(2 * d_act, 2 * d_env)
    e_emb, _, _, _, v_frozen = system.embedded_scf("huzinaga", v_emb, d_act, d_env, n_act, 0.0)
    corr = float(torch.sum(v_frozen * 2 * d_act))
    return {"e_global": e_ks, "e_emb": e_emb + e_env + cross - corr}
