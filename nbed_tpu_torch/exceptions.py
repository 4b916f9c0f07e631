"""Exceptions of the embedding pipeline (same names as ``nbed_tpu.exceptions``)."""


class NbedDriverError(Exception):
    """Raised when the embedding driver reaches an invalid state."""


class NbedLocalizerError(Exception):
    """Raised when a localizer sense check fails."""


class HamiltonianBuilderError(Exception):
    """Raised for invalid Hamiltonian construction inputs."""
