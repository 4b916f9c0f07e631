"""Run configuration: the schema of ``nbed_tpu.config.NbedConfig`` as a
stdlib dataclass with hand-written validation.

Field names, defaults and enum values are those of the reference model, so
the same JSON config files load here. Every field's features are ported.
:meth:`NbedConfig.require_ported`, which the driver calls before it runs
anything, is the hook for a field whose feature a slice has not ported yet:
it raises ``NotImplementedError`` for a non-default value of a field listed
in ``_NOT_PORTED``, naming the ROADMAP item that will port it.
"""

import dataclasses
import json
import logging
import os
import re
from dataclasses import dataclass
from enum import Enum
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = ["NbedConfig", "ProjectorTypes", "OccupiedLocalizerTypes",
           "VirtualLocalizerTypes", "parse_config", "overwrite_config_kwargs",
           "validate_xyz_file"]


class ProjectorTypes(Enum):
    MU = "mu"
    HUZ = "huzinaga"
    BOTH = "both"


class OccupiedLocalizerTypes(Enum):
    SPADE = "spade"
    BOYS = "boys"
    IBO = "ibo"
    PM = "pm"


class VirtualLocalizerTypes(Enum):
    CONCENTRIC = "cl"
    PROJECTED_AO = "pao"
    DISABLE = "disable"


# the reference's XYZ pattern (nbed_tpu/config.py:51-53)
_XYZ_RE = re.compile("^\\d+\n\\s?\n(?:\\w(?:\\s+\\-?\\d\\.\\d+){3}\n?)*")

# {field: ROADMAP item} of fields whose non-default values need code the
# port does not have yet; empty since every field's feature is ported
_NOT_PORTED: dict = {}


def validate_xyz_file(maybe_xyz):
    """Coerce a path to an XYZ file into its contents; pass anything else
    through (``nbed_tpu/config.py:61-78``): an existing path is read and
    checked against the XYZ pattern (ValueError if it does not match); a
    string that names no file is returned unchanged, for the geometry check
    to judge."""
    if isinstance(maybe_xyz, (str, Path)):
        if os.path.exists(maybe_xyz):
            with open(maybe_xyz) as f:
                content = f.read()
            if not _XYZ_RE.match(content):
                raise ValueError(f"{maybe_xyz} does not hold XYZ text")
            return content
        return str(maybe_xyz)
    return maybe_xyz


def _coerce_geometry(value) -> str:
    """An existing path is read as XYZ text; anything else must be XYZ text
    (reference config.py:55-76)."""
    if isinstance(value, (str, Path)) and os.path.exists(value):
        with open(value) as f:
            value = f.read()
    if not isinstance(value, str) or not _XYZ_RE.match(value):
        raise ValueError(f"geometry is neither an XYZ file nor XYZ text: {value!r}")
    return value


def _check_int(name, value, minimum):
    if isinstance(value, bool) or not isinstance(value, int) or value < minimum:
        raise ValueError(f"{name} must be an integer >= {minimum}, got {value!r}")


def _check_positive_float(name, value):
    if isinstance(value, bool) or not isinstance(value, (int, float)) or value <= 0:
        raise ValueError(f"{name} must be a positive number, got {value!r}")


def _check_bool(name, value):
    if not isinstance(value, bool):
        raise ValueError(f"{name} must be a bool, got {value!r}")


@dataclass
class NbedConfig:
    """Validated run configuration (field-for-field ``nbed_tpu.NbedConfig``)."""

    geometry: str
    n_active_atoms: int
    basis: str
    xc_functional: str
    projector: ProjectorTypes = ProjectorTypes.MU
    localization: OccupiedLocalizerTypes = OccupiedLocalizerTypes.SPADE
    convergence: float = 1e-6
    charge: int = 0
    spin: int = 0
    unit: str = "angstrom"
    symmetry: bool = False
    savefile: str | None = None
    run_ccsd_emb: bool = False
    run_fci_emb: bool = False
    run_dft_in_dft: bool = False
    run_vqe_emb: bool = False
    run_cis_emb: int = 0
    run_rpa_emb: int = 0
    mm_coords: list | None = None
    mm_charges: list | None = None
    mm_radii: list | None = None
    mu_level_shift: float = 1e6
    init_huzinaga_rhf_with_mu: bool = False
    virtual_localization: VirtualLocalizerTypes = VirtualLocalizerTypes.CONCENTRIC
    n_mo_overwrite: tuple = (None, None)
    occupied_threshold: float = 0.95
    virtual_threshold: float = 0.95
    max_shells: int = 4
    norm_cutoff: float = 0.05
    overlap_cutoff: float = 1e-5
    force_unrestricted: bool = False
    density_fitting: bool | None = None
    warmup_f32: bool = False
    taper_qubits: bool = False
    qubit_mapping: str = "jw"
    max_ram_memory: int = 4000
    max_hf_cycles: int = 50
    max_dft_cycles: int = 50

    def __post_init__(self):
        self.geometry = _coerce_geometry(self.geometry)
        self.projector = ProjectorTypes(self.projector)
        self.localization = OccupiedLocalizerTypes(self.localization)
        self.virtual_localization = VirtualLocalizerTypes(self.virtual_localization)
        _check_int("n_active_atoms", self.n_active_atoms, 1)
        for name in ("charge", "spin", "run_cis_emb", "run_rpa_emb"):
            _check_int(name, getattr(self, name), 0)
        for name in ("max_shells", "max_ram_memory", "max_hf_cycles",
                     "max_dft_cycles"):
            _check_int(name, getattr(self, name), 1)
        for name in ("convergence", "mu_level_shift", "norm_cutoff",
                     "overlap_cutoff"):
            _check_positive_float(name, getattr(self, name))
        for name in ("symmetry", "run_ccsd_emb", "run_fci_emb",
                     "run_dft_in_dft", "run_vqe_emb", "init_huzinaga_rhf_with_mu",
                     "force_unrestricted", "warmup_f32", "taper_qubits"):
            _check_bool(name, getattr(self, name))
        for name in ("occupied_threshold", "virtual_threshold"):
            value = getattr(self, name)
            if isinstance(value, bool) or not isinstance(value, (int, float)) \
                    or not 0 < value < 1:
                raise ValueError(f"{name} must lie in (0, 1), got {value!r}")
        if self.density_fitting is not None:
            _check_bool("density_fitting", self.density_fitting)
        if self.qubit_mapping not in ("jw", "bk", "parity"):
            raise ValueError(f"qubit_mapping must be jw, bk or parity, "
                             f"got {self.qubit_mapping!r}")
        overwrite = tuple(self.n_mo_overwrite)
        if len(overwrite) != 2:
            raise ValueError("n_mo_overwrite must have two entries")
        for value in overwrite:
            if value is not None:
                _check_int("n_mo_overwrite", value, 0)
        self.n_mo_overwrite = overwrite
        if self.symmetry:
            raise ValueError(
                "symmetry=True is not supported: point-group symmetry adds "
                "nothing to the dense kernels. Set symmetry=false."
            )
        if self.savefile is not None and not os.path.isfile(self.savefile):
            raise ValueError(f"savefile {self.savefile!r} is not an existing file")

    def require_ported(self):
        """Raise ``NotImplementedError`` for a feature the port lacks."""
        defaults = {f.name: f.default for f in dataclasses.fields(NbedConfig)}
        for name, item in _NOT_PORTED.items():
            value = getattr(self, name)
            if value != defaults[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported to nbed_tpu_torch yet: {item}."
                )

    def as_dict(self) -> dict:
        """The fields as JSON-ready values (enum values, tuples as lists)."""
        out = dataclasses.asdict(self)
        for key, value in out.items():
            if isinstance(value, Enum):
                out[key] = value.value
            elif isinstance(value, tuple):
                out[key] = list(value)
        return out


def overwrite_config_kwargs(config: NbedConfig, **config_kwargs) -> NbedConfig:
    """Copy of ``config`` with keywords overwritten, validated anew."""
    if not config_kwargs:
        return config
    data = config.as_dict()
    data.update(config_kwargs)
    return NbedConfig(**data)


def parse_config(config: "NbedConfig | str | Path | None" = None,
                 **config_kwargs) -> NbedConfig:
    """A config from a validated config, a JSON file path, or keywords
    (reference config.py:171-207)."""
    if isinstance(config, NbedConfig):
        return overwrite_config_kwargs(config, **config_kwargs)
    if isinstance(config, (str, Path)):
        with open(config) as f:
            data = json.load(f)
        return overwrite_config_kwargs(NbedConfig(**data), **config_kwargs)
    if config is not None:
        logger.warning("Unknown input to config argument will be ignored.")
    return NbedConfig(**config_kwargs)
