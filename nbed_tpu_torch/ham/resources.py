"""Qubit-resource accounting: qubit and Pauli-term counts (port of
``nbed_tpu/ham/resources.py``).

The reference's headline results are problem-size reductions: qubits and
Pauli terms of the full system against the embedded one (the PRA 109,
022418 qubit-reduction table).
"""

from .builder import HamiltonianBuilder
from .qubit import bravyi_kitaev, jordan_wigner

__all__ = ["hamiltonian_resources", "embedding_reduction"]


def hamiltonian_resources(constant, h1, h2, mapping: str = "jw",
                          tol: float = 1e-12) -> dict:
    """{'n_qubits', 'n_terms'} of a second-quantised Hamiltonian under JW
    (``mapping="jw"``) or otherwise BK, as in the reference."""
    mapper = jordan_wigner if mapping == "jw" else bravyi_kitaev
    psum = mapper(constant, h1, h2, tol=tol)
    return {"n_qubits": psum.n_qubits, "n_terms": len(psum)}


def embedding_reduction(driver, mapping: str = "jw") -> dict:
    """Full-system against embedded qubit/term counts of a completed
    driver. The full system is taken at the driver's global HF solution
    (``driver._global_hf``, built on first use)."""
    full = HamiltonianBuilder(driver._global_hf, 0.0).build()
    out = {"full": hamiltonian_resources(*full, mapping=mapping)}
    for name in ("mu", "huzinaga"):
        result = getattr(driver, name)
        if result is not None:
            out[name] = hamiltonian_resources(*result["second_quantised"],
                                              mapping=mapping)
    return out
